#!/usr/bin/env python3
"""The tracer's spans of a benchmark cell's entry, with no profiler, and
what tracing costs.

Run from the repository root:

    python3 tools/trace_spans_torch.py --workload dio_classic.corpus_b16 \\
        --out spans_dio.json

It sets the cell up as ``benchmark/run.py`` does (its configuration, its
traffic's plan from ``--seed`` and its entry; every signature warmed up:
eager call, then capture) and runs the first ``--calls`` calls of the
cell's window ``--rounds`` times each with the tracer off and on
(``world_tpu_torch.utils.profiling.tracing``), off first, on the host
clock (the entries return numpy arrays, which waits for the device).

Prints each span's name with its count a call, its median host ms and,
where it has one, its median device ms; for the graph replays, the four
stage spans' device ms against the launch span's (CUDA events on the
stream around ``cudaGraphLaunch``, so that the difference is the time the
device waited for the launch); the copy back's bytes a call and those of
them that went into fresh pinned memory (the counters ``copy_back.bytes``
and ``copy_back.fresh_bytes``); the median ms a call off and on; and the
cost of one boundary while the tracer is off (a span entered and left and
a stage stamp, 100,000 each).  ONE JSON line last; ``--out`` writes it too.
It needs the card.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]
# the copy back's counters over the traced calls (the fresh bytes are read
# only while the tracer records), as bytes a call
COPY_COUNTERS = ("copy_back.bytes", "copy_back.fresh_bytes")


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unreadable"


def median(values):
    return statistics.median(values) if values else None


def off_cost_us(n: int = 100_000) -> dict:
    """Host us of one boundary while the tracer is off."""
    import torch

    from world_tpu_torch.utils.profiling import TRACER
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    for _ in range(n):
        with TRACER.span("world.off"):
            pass
    t1 = time.perf_counter()
    for _ in range(n):
        TRACER.stamp("f0", cpu)
    t2 = time.perf_counter()
    return {"span_us": 1e6 * (t1 - t0) / n, "stamp_us": 1e6 * (t2 - t1) / n}


def replay_stages(spans) -> list:
    """[(launch device ms, the sum of its stage spans' device ms)] of each
    replay whose stages were read."""
    stages = defaultdict(float)
    for s in spans:
        if s.name.startswith("world.stage.") and s.device_ms is not None:
            stages[s.parent] += s.device_ms
    return [(s.device_ms, stages[s.id]) for s in spans
            if s.name == "world.batch.launch" and s.id in stages]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 12345)
    ap.add_argument("--calls", type=int, default=37)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import importlib

    import torch

    from harness import core
    from world_tpu_torch.utils.profiling import TRACER, tracing

    device = torch.device("cuda", 0)
    _, _, cfg, mix = core.cell_of(args.workload)
    audio = core.audio_of(cfg, mix)
    driver = importlib.import_module(f"traffic.{mix['driver']}")
    plan = driver.plan(mix["params"], args.seed, audio, 1.0)
    system = importlib.import_module(f"entries.{cfg['entry']}").System(
        cfg, audio.x, device)
    core.warm(system, plan, mix)
    core.sync(device)
    calls = []
    for call in plan.calls():
        calls.append(call)
        if len(calls) == args.calls:
            break

    def block() -> list:
        ms = []
        for call in calls:
            t0 = time.perf_counter()
            system.call(call)
            core.sync(device)
            ms.append(1e3 * (time.perf_counter() - t0))
        return ms

    off, on, spans, dropped = [], [], [], 0
    counted = dict.fromkeys(COPY_COUNTERS, 0)
    TRACER.clear()
    for _ in range(args.rounds):
        off += block()
        before = TRACER.counters()
        with tracing():
            on += block()
        spans += TRACER.spans()
        dropped += TRACER.dropped
        for k in counted:
            counted[k] += TRACER.counters()[k] - before[k]
        TRACER.clear()
    system.close()

    n_calls = len(on)
    host, dev = defaultdict(list), defaultdict(list)
    for s in spans:
        if s.host_ms is not None:
            host[s.name].append(s.host_ms)
        if s.device_ms is not None:
            dev[s.name].append(s.device_ms)
    names = sorted(set(host) | set(dev))
    table = {n: {"per_call": max(len(host[n]), len(dev[n])) / n_calls,
                 "host_ms": median(host[n]), "device_ms": median(dev[n])}
             for n in names}
    replays = replay_stages(spans)
    out = {"workload": args.workload, "card": card_line(),
           "calls": n_calls, "call_ms_off": median(off),
           "call_ms_on": median(on), "spans": table,
           "replays": len(replays),
           "launch_device_ms": median([a for a, _ in replays]),
           "stages_device_ms": median([b for _, b in replays]),
           "launch_wait_ms": median([a - b for a, b in replays]),
           "copy_back": {k: v / n_calls for k, v in counted.items()},
           "off_cost": off_cost_us(), "dropped": dropped}
    print(f"card: {out['card']}; {n_calls} calls a side; ms a call: off "
          f"{out['call_ms_off']:.3f}, on {out['call_ms_on']:.3f}")
    print(f"{'span':32s} {'a call':>8s} {'host ms':>10s} {'device ms':>10s}")
    for n, row in table.items():
        fmt = lambda v: "" if v is None else f"{v:.4f}"   # noqa: E731
        print(f"{n:32s} {row['per_call']:8.2f} {fmt(row['host_ms']):>10s} "
              f"{fmt(row['device_ms']):>10s}")
    if replays:
        print(f"replays {len(replays)}: launch device ms "
              f"{out['launch_device_ms']:.4f}, stages {out['stages_device_ms']:.4f},"
              f" the device waiting for the launch {out['launch_wait_ms']:.4f}")
    copied, fresh = (out["copy_back"][k] for k in COPY_COUNTERS)
    print(f"copy back a traced call: {copied / 2**20:.3f} MiB, "
          f"{fresh / 2**20:.3f} MiB of it into fresh pinned memory"
          + (f" ({100 * fresh / copied:.2f}%)" if copied else ""))
    print(f"off: a span {out['off_cost']['span_us']:.3f} us, a stamp "
          f"{out['off_cost']['stamp_us']:.3f} us")
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
