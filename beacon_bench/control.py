#!/usr/bin/env python3
"""The control of the benchmark's correctness check, at a cell's own
size: the plain reference with one of the configuration's guarantees
broken (``control`` in the configuration file), put in the program's
place and judged like a served answer.

    python3 beacon_bench/control.py --workload <name> --seeds 1 2 3 \\
        [--requests 4000]

For each seed it makes the run's data and draws the run's requests as
``run.py`` does, judges the control's answer to the first
``--requests`` of them against the reference, and prints one JSON line
a seed: the wrong answers the control gives and how many of the
requests have any answer at all. A run's check compares the number of
wrong answers with the limit 0; the control must read above it.
The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_readings(c: dict, seed: int, n: int, device,
                     window_cap: int = 2048) -> dict:
    from beacon_bench.lib import datagen, traffic
    from beacon_bench.reference.check import Judge

    config, mix = c["config"], c["traffic"]
    datasets = datagen.make_deployment(config, seed, device)
    gen = traffic.Generator(mix, datasets, window_cap)
    reqs = traffic.draw_requests(gen, seed + 2, n)
    judge = Judge(datasets, window_cap=window_cap,
                  control=config["control"])
    wrong = exists = 0
    for r in reqs:
        want = judge.expected(r["check"])
        exists += bool(want.get("exists") or want.get("count"))
        wrong += judge.expected(r["check"], control=True) != want
    return {"seed": seed, "requests": n, "control_wrong_answers": wrong,
            "limit": 0, "answers_with_hits": exists}


def main(argv=None) -> int:
    from beacon_bench.run import cell_of, load_spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=4000)
    args = ap.parse_args(argv)
    import torch

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    c = cell_of(load_spec(), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_readings(c, seed, args.requests, device)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
