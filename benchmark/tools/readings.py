#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card, in
one process:

  * the program's numbers (benchmark/harness/judge.py) on each seed, from a
    run of ``--seconds`` (a window at the cell's own load, its sample
    checked against the float64 reference as every run checks it);
  * on the seeds of ``--control-seeds``, on the same sampled requests, the
    controls' (the reference put in the program's place in float32 with
    TF32 on, ``tf32``, and so on its input rounded to bfloat16, ``bf16``;
    the ``CONTROL`` of the reference path the cell's configuration names,
    benchmark/paths/<name>.py, is the cell's) and the faults'
    (:data:`FAULTS`, the program's own outputs altered where they are
    produced), each judged as the program's are.

Run from the root of a checkout:

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1 2 3 \\
        --control-seeds 1 2 3 --seconds 10 --out chiprun_out/readings.jsonl

Each seed prints one JSON line: {"seed", "program", "tf32", "bf16", and
each fault's}, each with the run's numbers (``summary``) and the per-request numbers
(``per``); the last line names the cell's reference path and its control,
and gives each number's largest program reading and smallest control and
fault readings.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness import core, judge  # noqa: E402


def vuv_zeroed(o):
    """Every frame unvoiced: an analysis that finds no f0 candidate."""
    return dict(o, vuv=np.zeros_like(o["vuv"]), f0=np.zeros_like(o["f0"]))


def half_detuned(o):
    """Every other frame's f0 5% high."""
    f0 = np.array(o["f0"], copy=True)
    f0[::2] *= 1.05
    return dict(o, f0=f0)


def y_halved(o):
    """The waveform 6 dB low: a synthesis that scales wrong."""
    return dict(o, y=np.asarray(o["y"]) * 0.5)


FAULTS = {"vuv_zeroed": vuv_zeroed, "half_detuned": half_detuned,
          "y_halved": y_halved}


def control_readings(out) -> dict:
    """The controls' and the faults' readings on the run's sample."""
    cfg, x32, samples = out["cfg"], out["x32"], out["samples"]
    got = [s[3] for s in samples]
    sets = {kind: judge.control(cfg, x32, samples, kind=kind)
            for kind in judge.CONTROLS}
    sets.update({name: [f(o) for o in got] for name, f in FAULTS.items()})
    ref = judge.reference(cfg, x32, samples, gots=list(sets.values()))
    res = {}
    for k, (name, outs) in enumerate(sets.items()):
        values, per = judge.judge(cfg, outs, ref, k)
        res[name] = {"summary": values, "per": per}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    _, cell, cfg, _ = core.cell_of(args.workload)
    core.look_for_cards(cell)
    lines, high, low = [], {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = core.run(argparse.Namespace(workload=args.workload, seed=seed,
                                          seconds=args.seconds, trace=0), t0)
        line = {"seed": seed, "correct": out["correct"],
                "program": {"summary": out["values"], "per": out["per_request"]},
                "metrics": out["result"]["metrics"]}
        for k, v in out["values"].items():
            high[k] = max(high.get(k, v), v)
        if seed in args.control_seeds:
            for name, r in control_readings(out).items():
                line[name] = r
                lo = low.setdefault(name, {})
                for k, v in r["summary"].items():
                    lo[k] = min(lo.get(k, v), v)
        line["run_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        lines.append(line)
        del out
    summary = {"workload": args.workload, "path": cfg["reference"],
               "control": judge.path_of(cfg["reference"]).CONTROL,
               "program_max": high, "other_min": low}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
