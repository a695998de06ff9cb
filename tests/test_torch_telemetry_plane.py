"""The port's observability plane against the JAX package's, at
tolerance 0: the slow-query log, the event journal's reads (newest
capped, paginated, kind lists) and ``configure``, the metrics
registry's Prometheus and OpenMetrics expositions byte for byte on
registries fed the same observations (exemplars included), and the
device flight recorder's ring and counters. Wall clocks are pinned
(``time.time`` patched) and the monotonic ones injected.
"""

import json
import logging
import time

import pytest

import sbeacon_tpu.telemetry as jtel
import sbeacon_tpu_torch.telemetry as ttel

NOW = 1_790_000_000.25


@pytest.fixture
def wall(monkeypatch):
    """Both packages read the same pinned wall clock."""
    monkeypatch.setattr(time, "time", lambda: NOW)


def _ctx_run(mod, trace_id, fn):
    ctx = mod.RequestContext(trace_id=trace_id, route="g_variants")
    with mod.request_context(ctx):
        return fn()


# -- slow-query log -------------------------------------------------------------


@pytest.mark.parametrize("threshold", [-1.0, 0.0, 50.0])
def test_slow_query_log(wall, tmp_path, threshold):
    logging.getLogger("sbeacon.slowquery").disabled = True
    try:
        logs = {}
        for name, mod in (("jax", jtel), ("port", ttel)):
            path = tmp_path / f"{name}.jsonl"
            log = mod.SlowQueryLog(threshold, keep=3, path=str(path))
            got = [
                log.maybe_record(trace_id=f"t{i}", route="g_variants",
                                 status=200 + (i % 2) * 229,
                                 elapsed_ms=12.5 * i,
                                 notes={"lane": "bulk", "i": i} if i % 3
                                 else None)
                for i in range(8)
            ]
            text = path.read_text() if path.exists() else ""
            logs[name] = (got, log.count(), log.recent(), text)
        assert logs["port"] == logs["jax"]
    finally:
        logging.getLogger("sbeacon.slowquery").disabled = False


# -- event journal ----------------------------------------------------------------


def _journal_reads(mod):
    clk = [100.0]
    j = mod.EventJournal(keep=6, clock=lambda: clk[0])
    kinds = ["shaping.shed", "canary.mismatch", "shaping.brownout",
             "plan.drift", "canary", "device.compile", "shapingx"]
    seqs = []
    for i in range(10):
        clk[0] += 0.5
        if i == 4:
            seqs.append(_ctx_run(mod, "tr-4",
                                 lambda: j.publish(kinds[i % 7], n=i)))
        else:
            seqs.append(j.publish(kinds[i % 7], n=i, lane="bulk"))
    reads = {"seqs": seqs, "published": j.published(),
             "last": j.last_seq()}
    for since in (0, 3, 7, 10):
        for kind in ("", "shaping", "canary", "shaping,plan", " canary , "
                     "device", "shapingx"):
            for limit in (0, 1, 2, 256):
                key = f"{since}|{kind}|{limit}"
                reads["events", key] = j.events(since=since, kind=kind,
                                                limit=limit)
                reads["page", key] = j.events_page(since=since, kind=kind,
                                                   limit=limit)
    # tail with the cursor, two at a time, filtered
    cursor, tail = 0, []
    for _ in range(6):
        page, cursor = j.events_page(since=cursor, kind="shaping,canary",
                                     limit=2)
        tail.append((page, cursor))
    reads["tail"] = tail
    j.configure(keep=3)
    reads["shrunk"] = j.events()
    j.configure(enabled=False)
    reads["disabled"] = (j.publish("canary.failure"), j.published(),
                         j.enabled)
    j.configure(enabled=True, keep=5)
    reads["again"] = (j.publish("canary.failure", path="engine"),
                      j.events(limit=8))
    return reads


def test_event_journal_reads_and_configure(wall):
    assert _journal_reads(ttel) == _journal_reads(jtel)


# -- the metrics registry's expositions ----------------------------------------


def _registry(mod):
    reg = mod.MetricsRegistry()
    hits = reg.counter("cache.hits", "cache hits")
    by_t = reg.counter("cost.requests", "requests by tenant", label="tenant",
                       max_label_values=3)
    reg.gauge("queue.depth", "queued now", fn=lambda: 7)
    reg.gauge("slo.burn_rate", "burn by route and window",
              label=("route", "window"),
              fn=lambda: {("g_variants", "5m"): 2.5,
                          ("info", "1h"): 0.0})
    reg.gauge("device.pad_waste", "", label="family",
              fn=lambda: {"scatter": 0.96875, "fused_l0": 0.5})
    reg.counter("broken.callback", "a callback that raises",
                fn=lambda: 1 / 0)
    lat = reg.histogram("request.latency_ms", "latency by route",
                        label="route", exemplars=True)
    plain = reg.histogram("stage.encode_ms", "no exemplars",
                          buckets=(1.0, 10.0))
    hits.inc()
    hits.inc(2.5)
    for t in ("gold", "free", "anon", "x1", "x2", 'we"ird\n'):
        by_t.inc(label_value=t)
    for i, v in enumerate((0.5, 3.0, 3.1, 40.0, 999.0, 20000.0, 7.25)):
        route = ("g_variants", "info", 'a"b')[i % 3]
        if i == 2:
            _ctx_run(mod, "ambient-2",
                     lambda: lat.observe(v, label_value=route))
        else:
            lat.observe(v, label_value=route, exemplar=f"t{i}")
        plain.observe(v)
    return reg


def test_render_prometheus_both_dialects_byte_for_byte(wall, caplog):
    caplog.set_level(logging.CRITICAL)
    jreg, treg = _registry(jtel), _registry(ttel)
    assert treg.names() == jreg.names()
    for openmetrics in (False, True):
        got = treg.render_prometheus(openmetrics=openmetrics)
        want = jreg.render_prometheus(openmetrics=openmetrics)
        assert got == want
        assert ("# {trace_id=" in got) == openmetrics
    assert json.dumps(treg.render_json()) == json.dumps(jreg.render_json())


def test_percentiles_equal():
    for xs in ([], [3.0], [1, 2], list(range(17)), [0.1 * i ** 2
                                                     for i in range(101)]):
        assert ttel.percentiles(xs) == jtel.percentiles(xs)


# -- device flight recorder --------------------------------------------------------

#: (family, tier, real, padded, pairs, launch ms, sliced) per launch
LAUNCHES = [
    ("scatter", 64, 3, 64, 0, 0.5, False),
    ("scatter", 64, 64, 64, 0, 0.25, False),
    ("fused", 12, 12, 12, 0, 1.0, False),
    ("fused_l0", 16, 9, 16, 0, 2.0, False),
    ("plane", 7, 7, 7, 0, 0.125, False),
    ("mesh_sliced", 4, 3, 8, 16, 3.0, True),
    ("scatter", 2048, 100, 2048, 0, 0.75, False),
]


def _flight(mod, ring):
    rec = mod.DeviceFlightRecorder(ring)
    seqs = []
    for i, (fam, tier, real, padded, pairs, ms, sliced) in enumerate(
            LAUNCHES):
        kw = dict(tier=tier, specs_real=real, specs_padded=padded,
                  evaluated_pairs=pairs, launch_ms=ms, sliced=sliced)
        if mod is jtel:
            seq = rec.record_launch(fam, seam="scatter", **kw)
        else:
            seq = i + 1
            rec.record_launch(fam, seq=seq, kernel=f"k{i}", **kw)
        seqs.append(seq)
        rec.note_stage(seq, fetch_ms=0.5 * i, fetch_bytes=1000 * i)
    rec.note_stage(10_000, fetch_bytes=77)  # rolled off: bytes still count
    # the compile tracker: two first-seen keys outside warmup, one inside
    with mod.device_warmup_phase() if mod is ttel else rec.warmup_phase():
        _compile(mod, rec, "scatter_match", 120.0)
    _compile(mod, rec, "bisect_query", 80.5)
    _compile(mod, rec, "bisect_query", 1.0)  # seen: no second entry
    _compile(mod, rec, "plane_stats", 60.0)
    rec.configure(ring_size=max(1, ring - 1))
    snap = rec.snapshot()
    for r in snap["ring"]["entries"]:
        r.pop("kernel", None)  # the port names the launching kernel too
        r.pop("seq")           # the port's seq is its launch seam's
    return {
        "snapshot": snap,
        "summary": rec.launch_summary(),
        "families": rec.launches_by_family(),
        "pad": rec.pad_waste_by_family(),
        "worst": rec.worst_pad_waste(),
        "mid": (rec.mid_request_compiles(), rec.last_mid_request_compile()),
        "counters": (rec.evaluated_pairs, rec.fetched_bytes,
                     rec.donated_buffers),
    }


def _compile(mod, rec, key, ms):
    if mod is ttel:
        rec.record_build(key, ms, warmup=ttel.in_warmup_phase())
    else:
        rec.record_launch(key, seam="kernel", tier=0, specs_real=1,
                          specs_padded=1, launch_ms=ms, program_key=key)


@pytest.mark.parametrize("ring", [3, 256])
def test_flight_recorder_ring_and_counters(wall, ring):
    got, want = _flight(ttel, ring), _flight(jtel, ring)
    # the JAX tracker keys compiles on launches, so its key launches
    # count in its families: take them out before comparing
    for k in ("scatter_match", "bisect_query", "plane_stats"):
        for doc in (want["families"], want["snapshot"]["byFamily"],
                    want["summary"]["byFamily"]):
            doc.pop(k, None)
    n_extra = 4
    want["snapshot"]["total"] -= n_extra
    want["summary"]["total"] -= n_extra
    want["snapshot"]["ring"]["recorded"] -= n_extra
    for doc in (want["pad"], want["snapshot"]["padWaste"]["byFamily"]):
        for k in ("scatter_match", "bisect_query", "plane_stats"):
            doc.pop(k, None)
    want["snapshot"]["padWaste"]["byTier"] = {
        k: v for k, v in want["snapshot"]["padWaste"]["byTier"].items()
        if not k.endswith(":0")}
    want["snapshot"]["ring"]["entries"] = [
        r for r in want["snapshot"]["ring"]["entries"]
        if r["family"] not in ("scatter_match", "bisect_query",
                               "plane_stats")]
    got["snapshot"]["ring"]["entries"] = got["snapshot"]["ring"]["entries"][
        -len(want["snapshot"]["ring"]["entries"]):] if want["snapshot"][
        "ring"]["entries"] else []
    assert got == want


def test_launch_seam_feeds_the_recorder(monkeypatch):
    """``record_device_launch`` lands every launch in the process
    recorder under its family, pads as the caller names them, and a
    ``note_device_stage`` correction of the real slots moves the pad
    counters; a library's first load reaches the compile tracker."""
    rec = ttel.DeviceFlightRecorder(16)
    monkeypatch.setattr(ttel, "flight_recorder", rec)
    seq = ttel.record_device_launch("scatter_match", family="scatter",
                                    slots=64)
    ttel.note_device_stage(seq, specs_real=3, nslots=64, fetch_bytes=10)
    ttel.record_device_launch("bisect_query", family="fused_l0", specs=40,
                              pad_real=9, pad_slots=16)
    ttel.record_device_launch("ring_step", family="mesh", words=100)
    snap = rec.snapshot()
    assert snap["byFamily"] == {"scatter": 1, "fused_l0": 1, "mesh": 1}
    assert snap["padWaste"]["byFamily"] == {
        "scatter": round(1 - 3 / 64, 4), "fused_l0": round(1 - 9 / 16, 4),
        "mesh": 0.0}
    assert snap["fetchedBytes"] == 10
    assert [r["kernel"] for r in snap["ring"]["entries"]] == [
        "scatter_match", "bisect_query", "ring_step"]
    ttel.reset_launch_counts()


def test_kernel_library_load_is_a_compile_event(monkeypatch):
    from sbeacon_tpu_torch.ops import _build

    rec = ttel.DeviceFlightRecorder(16)
    monkeypatch.setattr(ttel, "flight_recorder", rec)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build", lambda name: "lib.so")

    class Lib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    seq0 = ttel.journal.last_seq()
    with ttel.device_warmup_phase():
        _build.load("scatter_match")
    _build.load("plane_stats")
    _build.load("plane_stats")  # loaded: no second event
    comp = rec.compile_snapshot()
    assert [e["key"] for e in comp["entries"]] == ["scatter_match",
                                                    "plane_stats"]
    assert comp["warmupShapes"] == ["scatter_match"]
    assert comp["midRequestCompiles"] == 1
    evs = ttel.journal.events(since=seq0, kind="device.compile")
    assert [e["data"]["program"] for e in evs] == ["plane_stats"]


def test_every_recorded_family_is_a_device_family():
    """Each family a kernel wrapper of the port records (a ``family=``
    literal, an index's ``flight_family``, the mesh-fused layout's
    choice) is one of ``telemetry.DEVICE_FAMILIES``."""
    import ast
    from pathlib import Path

    root = Path(ttel.__file__).parent
    seen = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "record_device_launch":
                for kw in node.keywords:
                    if kw.arg == "family" and isinstance(kw.value,
                                                         ast.Constant):
                        seen.add(kw.value.value)
            elif isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) in ("flight_family", "family")
                    for t in node.targets):
                seen |= {c.value for c in ast.walk(node.value)
                         if isinstance(c, ast.Constant)
                         and isinstance(c.value, str)}
    assert {"scatter", "plane", "fused", "fused_l0", "mesh",
            "mesh_sliced", "mesh_replicated", "distinct"} <= seen
    assert seen <= set(ttel.DEVICE_FAMILIES), seen - set(ttel.DEVICE_FAMILIES)
