#!/usr/bin/env python3
"""The Harvest -> Requiem round trip on one GPU as a CUDA graph's replay and
eagerly, and ``World.encode(harvest)``: the numbers a change to the Harvest
path's device work moves, for comparing two checkouts in one process each.

Run from the repository root (or with a checkout first on the path, to
measure that checkout's package):

    PYTHONPATH=. python3 tools/bench_harvest_torch.py [--out f.json]
    PYTHONPATH=_checkout/parent:. python3 tools/bench_harvest_torch.py

Cases, float32, through ``HarvestRequiem`` (its static tables resident):
x16 (tests/golden/harvest_16k.npz, 4.644 s at 16 kHz) single and as a batch
of 4 copies, and 60 s of tools/check_long_audio.py's glide at 22.05 kHz.
For each: the graph's replay (after the module's first, eager call and its
second, which captures) and the eager static call
(``bench_torch.eager_round_trip``), taken replay, eager, eager, replay, by
CUDA events around ``rounds`` calls a reading; then ``World.encode`` of x16
by Harvest with Requiem aperiodicity, numpy in and out, by the host clock.
Readings are reported whole, with their medians.  Every row's waveform must
be finite.  Prints one JSON line; ``--out`` also writes it.
"""
import argparse
import json
import time
from pathlib import Path

import numpy as np

import bench_torch as BT


def event_ms(fn, rounds: int) -> float:
    """Milliseconds a call of fn, ``rounds`` calls between two CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    if not torch.isfinite(out["y"]).all():
        raise AssertionError("bench_harvest_torch: a non-finite waveform")
    return start.elapsed_time(end) / rounds


def round_trip_case(x: np.ndarray, fs: int, rows: int, readings: int,
                    rounds: int) -> dict:
    import torch

    from world_tpu_torch import HarvestRequiem

    model = HarvestRequiem(fs, x.shape[0], dtype=torch.float32, device="cuda")
    xt = torch.tensor(x, dtype=torch.float32, device="cuda")[None]
    xt = xt.expand(rows, -1).contiguous()
    model(xt)                        # eager
    model(xt)                        # warm-up, capture, replay
    BT.eager_round_trip(model, xt)
    torch.cuda.synchronize()
    replay, eager = [], []
    for graph in (True, False, False, True):
        for _ in range(readings):
            if graph:
                replay.append(event_ms(lambda: model(xt), rounds))
            else:
                eager.append(event_ms(lambda: BT.eager_round_trip(model, xt),
                                      max(1, rounds // 2)))
    audio = rows * x.shape[0] / fs
    med_r, med_e = float(np.median(replay)), float(np.median(eager))
    return {"rows": rows, "seconds": x.shape[0] / fs,
            "replay_ms": replay, "eager_ms": eager,
            "replay_ms_median": med_r, "eager_ms_median": med_e,
            "replay_xrt": audio / (med_r / 1e3), "eager_xrt": audio / (med_e / 1e3)}


def encode_case(x: np.ndarray, fs: int, readings: int) -> dict:
    import torch

    from world_tpu_torch import World

    w = World(device="cuda", dtype=torch.float32)
    w.encode(fs, x, f0_method="harvest", is_requiem=True)
    ms = []
    for _ in range(readings):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w.encode(fs, x, f0_method="harvest", is_requiem=True)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"ms": ms, "ms_median": float(np.median(ms))}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--readings", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", type=Path, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    import torch

    import world_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_harvest_torch: no CUDA device")
    # the stage profile's glide (beside this script under tools/)
    from profile_stages_torch import GLIDE_FS, GLIDE_SECONDS, glide_signal

    x, fs, _, _ = BT.fixture()
    x60 = glide_signal(GLIDE_FS, GLIDE_SECONDS)
    cases = {"single": round_trip_case(x, fs, 1, args.readings, args.rounds),
             "batch4": round_trip_case(x, fs, 4, args.readings, args.rounds),
             "glide_60s": round_trip_case(x60, GLIDE_FS, 1, args.readings,
                                          max(1, args.rounds // 4))}
    doc = {"package": str(Path(world_tpu_torch.__file__).resolve().parent),
           "dtype": "float32", "cases": cases,
           "world_encode_harvest": encode_case(x, fs, 2 * args.readings + 1),
           **BT.environment(torch.device("cuda"))}
    line = json.dumps(doc)
    print(line)
    if args.out is not None:
        args.out.write_text(line + "\n")
    return doc


if __name__ == "__main__":
    main()
