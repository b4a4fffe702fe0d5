#!/usr/bin/env python3
"""The highest arrival rate an open-loop cell's system sustains, by a sweep
on the card, in one process: the cell run at each rate of ``--rates`` for
``--seconds``, each printing its latencies and its backlog's trend (the
median latency of the last quarter of the requests over that of the first
quarter: a queue that grows through the window reads far above 1).

Run from the root of a checkout:

    python3 benchmark/tools/sweep.py --workload harvest_requiem.serve_open \\
        --rates 120 160 200 240 --seconds 10 --seed 5

The cell's mix file keeps the rate chosen from it (0.8 of the highest that
held its backlog), as a number.
"""
import argparse
import copy
import json
import os
import sys
import time

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    bench, cell, cfg, mix = core.cell_of(args.workload)
    core.look_for_cards(cell)
    for rate in args.rates:
        m = copy.deepcopy(mix)
        m["params"]["rate"] = rate
        t0 = time.perf_counter()
        out = core.run(argparse.Namespace(workload=args.workload, seed=args.seed,
                                          seconds=args.seconds, trace=0), t0,
                       cell_data=(bench, cell, cfg, m))
        lat = np.asarray(out["latencies_ms"])
        q = max(1, lat.size // 4)
        print(json.dumps({"rate": rate, "requests": int(lat.size),
                          "p50_ms": float(np.median(lat)),
                          "p95_ms": float(np.percentile(lat, 95)),
                          "max_ms": float(lat.max()),
                          "trend": float(np.median(lat[-q:]) / np.median(lat[:q])),
                          "correct": out["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
