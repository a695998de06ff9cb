#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``sbeacon_tpu_torch``.

    python3 beacon_bench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, the
program (``sbeacon_tpu_torch/``) and this folder. The cell (a workload
of ``BENCHMARK.json``) names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); its per-layer metrics are
``metrics/<name>.py``, each a ``read(window)``. The run:

1. makes the deployment's rows from ``--seed`` (and its genotype bits
   on the card), hands them to the program, builds the engine (upload,
   kernel build, warm-up) and serves the program's HTTP app on a
   localhost port of this process;
2. starts the client process (standard library only, one thread, on a
   core of its own), which loads the server with the cell's closed
   loop, one stream of requests drawn from the seed. The stream's first
   part warms the server up until the response cache, the bounded state
   the traffic fills, is full: it has seen as many lookups as it holds
   entries (and ``WARM_MIN_S`` have passed). The window of
   ``--seconds`` follows without a seam;
3. closes the window, reads the peak device memory, frees the program,
   and checks every answer the window touched against the plain
   reference (``reference/``);
4. prints, as the last line of standard output, one JSON object:
   ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
   end-to-end metrics with ``--trace 0``, its per-layer metrics under a
   ``torch.profiler`` capture with ``--trace 1``), ``device``, with
   ``--trace 1`` ``breakdown``, and last ``checks`` (each number
   compared, beside its limit), which also end standard error.

It refuses to run (exit 3, no result) without a CUDA device, or with
fewer than the cell's chips; it exits 4, with no result, if ``jax``,
``jaxlib``, ``flax`` or ``sbeacon_tpu`` was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "sbeacon_tpu")
END_WAIT_S = 120.0
# the load: one client process (a single thread), and requests drawn
# for each client (more than the warm-up and the longest window use)
CLIENT_PROCESSES = 1
POOL_PER_CLIENT = 256
# warm-up: at least this long, and never longer than the cap (a stream
# that cannot fill the cache by then still gets its window)
WARM_MIN_S = 5.0
WARM_MAX_S = 200.0
# a traced run starts its capture this long before the window opens
TRACE_LEAD_S = 3.0


class Refused(Exception):
    """The run cannot measure here; exit code and reason."""

    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


def load_spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise Refused(2, f"no {path}")
    return json.loads(path.read_text())


def cell_of(spec: dict, workload: str, root: Path = ROOT,
            bench_dir: Path = HERE) -> dict:
    """Everything a run of ``workload`` needs, found by name: the cell,
    its configuration and traffic files, and its metrics: the cell's
    end-to-end metrics, and the per-layer metrics that list the cell
    (or, listing none, move an end-to-end metric the cell reports),
    each with its reader module."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise Refused(2, f"unknown workload {workload!r}")
    cell = cells[workload]
    cfg = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    end_to_end = [m for m in spec["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [dict(m, reader=load_reader(bench_dir, m["name"]))
                 for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": end_to_end, "per_layer": per_layer}


def load_reader(bench_dir: Path, name: str):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "beacon_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def spawn_clients(n_procs: int):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH",)}
    return [subprocess.Popen(
        [sys.executable, "-I", str(HERE / "lib" / "client.py")],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
        cwd=str(HERE / "lib"))
        for _ in range(n_procs)]


def isolate_load(procs) -> set:
    """The load process on a core of its own, and this process, the
    server, with every thread it starts from here on, on the others, so
    that the load takes no time from the system it measures (left as
    it is on a host of fewer than four cores). Returns the cores this
    thread had, for the end of the run."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 4:
        for p in procs:
            os.sched_setaffinity(p.pid, {cores[-1]})
        os.sched_setaffinity(0, set(cores[:-1]))
    return set(cores)


def stop_clients(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device,
             *, chips: int = 1, faults=None, warm_lookups: int | None = None,
             warm_min_s: float = WARM_MIN_S,
             client_processes: int = CLIENT_PROCESSES) -> dict:
    """One run; returns the result object (without printing it).
    ``warm_lookups`` replaces the warm-up's target, the response cache's
    capacity, and ``warm_min_s`` its least length (tests make both
    small)."""
    from beacon_bench.lib import datagen, probe, readers, traffic
    from beacon_bench.lib.adapter import to_shard
    from beacon_bench.lib.serve import Server
    from beacon_bench.reference.check import Judge

    config, mix = c["config"], c["traffic"]
    is_cuda = getattr(device, "type", str(device)) == "cuda"
    procs = spawn_clients(client_processes)
    cores = isolate_load(procs)
    server = None
    instruments = None
    gcw = probe.GcWatch()
    try:
        if is_cuda:
            import torch  # a fresh process: the peak counts from 0
        t = time.monotonic()
        stages = {"start_s": t - T_PROCESS}
        datasets = datagen.make_deployment(config, seed, device)
        people = (traffic.people_of(datasets[0], seed + 1)
                  if config.get("individuals") else None)
        stages["data_s"] = time.monotonic() - t
        t = time.monotonic()
        shards = [to_shard(d) for d in datasets]
        stages["shards_s"] = time.monotonic() - t
        server = Server(shards, datasets, people, config["server"], device)
        stages.update(server.times)
        del shards, people
        cap = server.window_cap
        if faults is not None:
            faults(server)
        t = time.monotonic()
        gen = traffic.Generator(mix, datasets, server.window_cap)
        n_clients = mix["clients"]
        reqs = traffic.draw_requests(gen, seed + 2,
                                     n_clients * POOL_PER_CLIENT)
        per_proc = -(-n_clients // len(procs))

        def client_lists(pool, lo, hi):
            return [[[i, *traffic.wire(pool[i])]
                     for i in range(k, len(pool), n_clients)]
                    for k in range(lo, min(hi, n_clients))]

        for j, p in enumerate(procs):
            lo, hi = j * per_proc, (j + 1) * per_proc
            p.stdin.write(json.dumps({
                "port": server.port,
                "lists": client_lists(reqs, lo, hi)}) + "\n")
            p.stdin.flush()
        # the pool waits for the check as text: no object graph of the
        # harness's own for the server's garbage collector to walk
        checks = [json.dumps(r["check"]) for r in reqs]
        paths = [r["path"] for r in reqs]
        del reqs
        gc.collect()
        gcw.install()
        for p in procs:
            if p.stdout.readline().strip() != "ready":
                raise RuntimeError("a client process did not start")
        stages["requests_s"] = time.monotonic() - t
        kernels = sorted({k for m in c["per_layer"]
                          for k in getattr(m["reader"], "KERNELS", ())})
        # one stream of the cell's traffic: its first part warms the
        # server up, the window follows without a seam
        t_go = time.monotonic()
        for p in procs:
            p.stdin.write(json.dumps({"go": True}) + "\n")
            p.stdin.flush()
        seen, capacity = probe.cache_lookups(server.app)
        target = capacity if warm_lookups is None else warm_lookups
        while True:
            seen, _ = probe.cache_lookups(server.app)
            waited = time.monotonic() - t_go
            if (seen >= target and waited >= warm_min_s) \
                    or waited >= WARM_MAX_S:
                break
            time.sleep(0.05)
        stages.update(warm_s=waited, warm_lookups=seen, warm_target=target)
        if trace:
            # the capture starts a little before the window, which its
            # start-up then does not touch
            instruments = probe.Instruments(kernels, cuda=is_cuda)
            instruments.install()
            instruments.start()
            time.sleep(TRACE_LEAD_S)
        state0 = probe.server_state(server.app)
        t0 = time.monotonic()
        t1 = t0 + seconds
        for p in procs:
            p.stdin.write(json.dumps({"t1": t1}) + "\n")
            p.stdin.flush()
        before = probe.counters(server.app)
        setup_s = before["t"] - T_PROCESS
        stages["setup_s"] = setup_s
        print(f"beacon_bench: set-up {json.dumps(stages)}", file=sys.stderr,
              flush=True)
        if trace:
            instruments.open_window()
        time.sleep(max(0.0, t1 - time.monotonic()))
        if trace:
            instruments.close_window()
        after = probe.counters(server.app)
        state1 = probe.server_state(server.app)
        if trace:
            instruments.stop()
        rows, errors = [], []
        deadline = time.monotonic() + END_WAIT_S
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
            doc = json.loads(out)
            rows += doc["rows"]
            errors += doc["errors"]
        mem_peak = (torch.cuda.max_memory_allocated(device)
                    if is_cuda else 0)
        window = readers.Window(before, after, 0, seconds)
        breakdown = None
        if trace:
            instruments.uninstall()
            window.trace = probe.reduce_trace(instruments.prof)
            window.window_s = window.trace["window_s"]
            for k, recs in instruments.records.items():
                from beacon_bench.lib.bounds import NEED, bound_of
                window.bounds[k] = [bound_of(*NEED[k](r)) for r in recs]
            instruments.records.clear()
            window.power_limit = power_limit()
            by_name = window.trace["device_s_by_name"]
            breakdown = {
                "device_ops": sorted(([k, v] for k, v in by_name.items()),
                                     key=lambda kv: -kv[1])[:10],
                "idle_gaps": probe.idle_gaps(window.trace),
            }
            instruments.prof = None
        server.close()
        server = None
    finally:
        gcw.uninstall()
        if instruments is not None:
            instruments.uninstall()
        if server is not None:
            server.close()
        stop_clients(procs)
        os.sched_setaffinity(0, cores)

    # the check, once the program's state is freed
    t_check = time.monotonic()
    judge = Judge(datasets, window_cap=cap, control=config.get("control"))
    # every request the window touched: sent in it, or answered in it
    sent = [r for r in rows if t0 <= r[1] < t1]
    touched = [r for r in rows if r[1] < t1 and r[2] >= t0]
    wrong, refused, unanswered, first_bad = 0, 0, 0, []
    completed_ok = 0
    for rid, ts, td, status, body in touched:
        why = judge.judge(json.loads(checks[rid]), status, body)
        if why is None:
            if td <= t1:
                completed_ok += 1
            continue
        if status == 200:
            wrong += 1
        elif status == 0:  # no answer came: the connection failed
            unanswered += 1
        else:
            refused += 1
        if len(first_bad) < 3:
            first_bad.append({"path": paths[rid], "why": why,
                              "body": (body or "")[:300]})
    window.completed = completed_ok
    check_s = time.monotonic() - t_check
    window.gc = gcw.between(t0, t1)
    per_s = [0] * max(1, int(round(seconds)))
    for _rid, _ts, td, _s, _b in touched:
        if t0 <= td < t1:
            per_s[min(len(per_s) - 1, int(td - t0))] += 1
    thirds = [sum(per_s[k * len(per_s) // 3:(k + 1) * len(per_s) // 3])
              for k in range(3)]
    lat = [(td - ts) * 1e3 for _rid, ts, td, _s, _b in sent]
    window.latencies_ms = lat
    print("beacon_bench: window " + json.dumps({
        "requests_per_s": readers.requests_per_s(window),
        "p50_ms": readers.latency_ms(window, 0.50),
        "p95_ms": readers.latency_ms(window, 0.95),
        "completed_per_s": per_s,
        "completed_by_third": thirds,
        "server_state": {"start": state0, "end": state1},
        "gc_by_generation": window.gc,
        "server_cpu_per_wall_s": (after["cpu_s"] - before["cpu_s"])
        / (after["t"] - before["t"]),
        "check_s": check_s}),
        file=sys.stderr, flush=True)
    checks = {
        "wrong_answers": {"value": wrong, "limit": 0},
        "unanswered": {"value": unanswered, "limit": 0},
        "client_errors": {"value": len(errors), "limit": 0},
    }
    correct = (wrong == 0 and unanswered == 0 and not errors
               and bool(touched))
    metrics = {}
    if not trace:
        values = {
            # the card's allocator at its peak, read by the benchmark
            # itself; none on a CPU run
            "device_memory_gb": mem_peak / 1e9 if mem_peak else None,
            "setup_s": setup_s,
        }
        for m in c["end_to_end"]:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in c["per_layer"]:
            v = m["reader"].read(window)
            if v is None:
                continue
            extra = {}
            if isinstance(v, tuple):
                v, by = v
                extra = {"bound_by": by, "power_limit": window.power_limit}
            metrics[m["name"]] = {"value": v, "unit": m["unit"], **extra}
    device_doc = device_info(device, chips, mem_peak)
    if trace and window.trace is not None:
        device_doc["busy_s"] = window.trace["busy_s"]
        device_doc["window_s"] = window.window_s
    result = {"correct": correct, "attempted": len(touched),
              "failed": wrong + refused + unanswered + len(errors),
              "metrics": metrics,
              "device": device_doc}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    result["_first_bad"] = first_bad
    result["_errors"] = errors[:3]
    return result


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def device_info(device, chips: int, mem_peak: int) -> dict:
    import torch

    if getattr(device, "type", str(device)) != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": mem_peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(mem_peak)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = load_spec()
        c = cell_of(spec, args.workload)
        import torch

        chips = int(c["cell"].get("chips", 1))
        if not torch.cuda.is_available():
            raise Refused(3, "no CUDA device: the benchmark measures only "
                             "on the card")
        if torch.cuda.device_count() < chips:
            raise Refused(3, f"the cell needs {chips} CUDA devices, "
                             f"{torch.cuda.device_count()} found")
        # every build cache at a fixed path inside the checkout (the
        # port's nvcc builds go to build/kernels by themselves)
        os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
        os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
        import sbeacon_tpu_torch  # noqa: F401  (refuse early without it)

        result = run_cell(c, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), chips=chips)
    except Refused as e:
        print(f"beacon_bench: {e}", file=sys.stderr)
        return e.code
    return emit(result)


def emit(result: dict) -> int:
    """Print a run's result: exit 4 and no result if a forbidden module
    was loaded; else the failed answers and the checks on standard
    error, and the result as the last line of standard output."""
    bad = forbidden_modules()
    if bad:
        print(f"beacon_bench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 4
    for item in result.pop("_first_bad") + result.pop("_errors"):
        print(f"beacon_bench: failed answer: {item}", file=sys.stderr)
    for name, chk in result["checks"].items():
        print(f"check {name} {chk['value']} limit {chk['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
