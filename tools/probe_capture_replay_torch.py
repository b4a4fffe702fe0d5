#!/usr/bin/env python3
"""Probe: does what runs before a capture change how fast its graph replays?

Run from the repository root on a GPU machine:

    PYTHONPATH=. python3 tools/probe_capture_replay_torch.py

The Harvest round trip of x16 (float32, 4.644 s, one row, the tables of
``HarvestRequiem``) is captured three times, each in a ``GraphCache`` of
its own after one eager call of it:

  * ``run``: the cache's second call, as a server's graph is captured (no
    second eager call, no synchronize, no ``empty_cache``);
  * ``emptied``: the same, after ``torch.cuda.synchronize()`` and
    ``torch.cuda.empty_cache()`` (the allocator's cached blocks given back
    to the card first, as the capture once did);
  * ``warmed``: the same, after an eager call on a side stream, then the
    synchronize and ``empty_cache()`` (the whole of the earlier capture).

The three replays are timed in turns (run, emptied, warmed, warmed,
emptied, run), each reading ``--rounds`` replays between CUDA events, and
each replay's outputs held bitwise to the eager call.  Prints one JSON
line last.
"""
import argparse
import json
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parent.parent / "tests" / "golden" / "harvest_16k.npz"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    from world_tpu_torch import HarvestRequiem
    from world_tpu_torch.parallel.graphs import GraphCache

    if not torch.cuda.is_available():
        raise SystemExit("probe_capture_replay_torch: no CUDA device")
    x16 = np.asarray(np.load(GOLDEN)["x16"], np.float32)
    model = HarvestRequiem(16000, x16.shape[0], dtype=torch.float32, device="cuda")
    x = torch.tensor(x16, device="cuda")[None]
    offsets = torch.zeros(model.pulse_seed.shape[1], dtype=torch.int64,
                          device="cuda")
    fn = model._round_trip
    eager = fn(x, offsets)

    def prepare(name):
        if name == "warmed":
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(x, offsets)
            torch.cuda.current_stream().wait_stream(side)
        if name in ("emptied", "warmed"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    graphs = {}
    for name in ("run", "emptied", "warmed"):
        cache = GraphCache()
        cache.run(name, fn, (x, offsets), x.device)         # eager
        prepare(name)
        cache.run(name, fn, (x, offsets), x.device)         # capture, replay
        graphs[name] = cache

    def reading(name):
        cache = graphs[name]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.rounds):
            out = cache.run(name, fn, (x, offsets), x.device)
        end.record()
        torch.cuda.synchronize()
        same = all(torch.equal(out[k], eager[k]) for k in eager)
        return start.elapsed_time(end) / args.rounds, same

    found = {name: [] for name in graphs}
    bitwise = True
    for _ in range(2):
        for name in ("run", "emptied", "warmed", "warmed", "emptied", "run"):
            ms, same = reading(name)
            found[name].append(ms)
            bitwise &= same
    doc = {"tool": "tools/probe_capture_replay_torch.py",
           "card": torch.cuda.get_device_name(0), "rounds": args.rounds,
           "replay_ms": found, "bitwise": bitwise,
           "pool_bytes": {n: c.pool_bytes() for n, c in graphs.items()}}
    for name, ms in found.items():
        print(f"{name}: replay {' / '.join(f'{m:.3f}' for m in ms)} ms, pool "
              f"{doc['pool_bytes'][name] / 2**20:.1f} MiB")
    print(json.dumps(doc))
    return doc


if __name__ == "__main__":
    main()
