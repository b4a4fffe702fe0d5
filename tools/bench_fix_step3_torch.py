#!/usr/bin/env python3
"""Harvest's FixStep3 on one GPU, and its two kernels, K4 (the chains) and
K5 (the merge): the numbers a change to FixStep3 moves, for comparing two
checkouts in one process each.

Run from the repository root (or with a checkout first on the path, to
measure that checkout's package):

    PYTHONPATH=. python3 tools/bench_fix_step3_torch.py [--out f.json]
    PYTHONPATH=_checkout/parent:. python3 tools/bench_fix_step3_torch.py

Cases, float32, FixStep3's arguments as one ``harvest_core`` call gives
them: x16 (tests/golden/harvest_16k.npz, 4.644 s at 16 kHz) single and as
a batch of 4 copies, and 60 s of tools/check_long_audio.py's glide at
22.05 kHz.  For each: FixStep3 alone as one replay of a CUDA graph of its
own and eagerly (CUDA events around ``rounds`` calls a reading, taken
replay, eager, eager, replay), one replay's device events and device time
under torch.profiler, and K4's and K5's launches a call; then K4 alone and
K5 alone, the sum of the K5 launches of one call, by CUDA events (K5
updates its carried state in place, so each launch takes a fresh copy made
before the timing).  The kernels are found through the wrappers' names
(``ops.fix_step3.extend_chains_cuda``, ``merge_sections_cuda``), whatever
their arguments.  Prints one JSON line; ``--out`` also writes it.
"""
import argparse
import json
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
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / rounds


def step3_arguments(x: np.ndarray, fs: int, rows: int) -> tuple:
    """The arguments of the one FixStep3 call of harvest_core on ``rows``
    copies of x, float32 on the card."""
    import torch

    from world_tpu_torch.f0 import harvest as H

    xt = torch.tensor(x, dtype=torch.float32, device="cuda")[None]
    xt = xt.expand(rows, -1).contiguous()
    real, got = H.fix_step3, []

    def capture(*args):
        got.append(args)
        return real(*args)

    H.fix_step3 = capture
    try:
        H.harvest_core(xt, fs, 71.0, 800.0, 5.0, H.default_max_candidates(),
                       H.default_max_sections(xt.shape[1], fs))
    finally:
        H.fix_step3 = real
    return got[0]


def kernel_calls(fn) -> tuple:
    """The K4 and K5 launches fn makes: ([K4 args], [(K5 args, n_state)]),
    n_state the count of carried state tensors K5 returns (the last of its
    arguments)."""
    import torch

    from world_tpu_torch.ops import fix_step3 as K45

    real_e, real_m = K45.extend_chains, K45.merge_sections
    ext, mer = [], []
    clone = lambda a: a.clone() if isinstance(a, torch.Tensor) else a  # noqa: E731

    def extend(*args):
        ext.append(tuple(clone(a) for a in args))
        return real_e(*args)

    def merge(*args):
        kept = tuple(clone(a) for a in args)
        out = real_m(*args)
        mer.append((kept, len(out)))
        return out

    K45.extend_chains, K45.merge_sections = extend, merge
    try:
        fn()
    finally:
        K45.extend_chains, K45.merge_sections = real_e, real_m
    return ext, mer


def case(x: np.ndarray, fs: int, rows: int, readings: int, rounds: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from world_tpu_torch.f0 import harvest as H
    from world_tpu_torch.ops import fix_step3 as K45
    from world_tpu_torch.parallel.graphs import GraphCache

    f0, cands, scores, allowed, S, chunk = step3_arguments(x, fs, rows)
    inputs = (f0, cands, scores)
    fn = lambda f, c, sc: {"f0": H.fix_step3(f, c, sc, allowed, S, chunk)}  # noqa: E731
    graph = GraphCache().capture("fix_step3", fn, inputs, f0.device)
    replay = lambda: graph.replay(inputs)  # noqa: E731
    eager = lambda: fn(*inputs)  # noqa: E731
    replay()
    eager()
    torch.cuda.synchronize()
    before = (K45.extend_counter.launches, K45.merge_counter.launches)
    replay()
    torch.cuda.synchronize()
    launches = (K45.extend_counter.launches - before[0],
                K45.merge_counter.launches - before[1])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    dev_us, n_events = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us += float(getattr(ev, "device_time_total", None)
                            or getattr(ev, "cuda_time_total", 0.0) or 0.0)
            n_events += ev.count
    times = {"replay": [], "eager": []}
    for mode in ("replay", "eager", "eager", "replay"):
        call = replay if mode == "replay" else eager
        times[mode] += [event_ms(call, rounds) for _ in range(readings)]

    ext, mer = kernel_calls(eager)
    k4_ms = [event_ms(lambda: K45.extend_chains_cuda(*ext[0]), rounds)
             for _ in range(readings)]
    n = readings * rounds
    # fresh copies of K5's carried state for every timed launch, made now
    states = iter([[[t.clone() for t in args[-n_state:]] for args, n_state in mer]
                   for _ in range(n)])

    def k5_call():
        for (args, n_state), state in zip(mer, next(states)):
            K45.merge_sections_cuda(*args[:-n_state], *state)

    k5_ms = [event_ms(k5_call, rounds) for _ in range(readings)]
    return {"rows": rows, "frames": f0.shape[1], "section_rows": S,
            "section_chunk": chunk, "k4_launches": launches[0],
            "k5_launches": launches[1],
            "replay_device_events": n_events, "replay_device_ms": dev_us / 1e3,
            "replay_ms": times["replay"], "eager_ms": times["eager"],
            "replay_ms_median": float(np.median(times["replay"])),
            "eager_ms_median": float(np.median(times["eager"])),
            "k4_ms": k4_ms, "k4_ms_median": float(np.median(k4_ms)),
            "k5_ms": k5_ms, "k5_ms_median": float(np.median(k5_ms)),
            "k5_launches_timed": len(mer)}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--readings", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--out", type=Path, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    import torch

    import world_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_fix_step3_torch: no CUDA device")
    # the stage profile's glide (beside this script under tools/)
    from profile_stages_torch import GLIDE_FS, GLIDE_SECONDS, glide_signal

    x, fs, _, _ = BT.fixture()
    x60 = glide_signal(GLIDE_FS, GLIDE_SECONDS)
    cases = {"single": case(x, fs, 1, args.readings, args.rounds),
             "batch4": case(x, fs, 4, args.readings, args.rounds),
             "glide_60s": case(x60, GLIDE_FS, 1, args.readings,
                               max(1, args.rounds // 5))}
    doc = {"package": str(Path(world_tpu_torch.__file__).resolve().parent),
           "dtype": "float32", "cases": cases,
           **BT.environment(torch.device("cuda"))}
    line = json.dumps(doc)
    print(line)
    if args.out is not None:
        args.out.write_text(line + "\n")
    return doc


if __name__ == "__main__":
    main()
