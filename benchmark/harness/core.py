"""One run of one cell: set up the program, warm up the cell's signatures,
measure for ``--seconds``, read the trace where asked, check the sampled
outputs against the plain reference, and print the result.

Everything that belongs to one cell is found by name: the cell in
BENCHMARK.json, its configuration (``configs/<config>.json``), the audio
the configuration names (``data/<audio>.npy`` and its manifest
``data/<audio>.json``, traffic/cuts.py), its traffic mix
(``mixes/<traffic>.json``, which names a driver in ``traffic/`` and the
kind of entry point, ``api``, that the configuration maps to a module of
``entries/`` and to a reference path, ``paths/<reference>.py``), its
limits (``limits/<cell>.json``) and each metric's reader
(``metrics/<metric>.py``).
"""
import argparse
import gc
import importlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from . import judge, load_module

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
SAMPLE = 12             # requests the check compares, besides the longest
PROFILE_S = 2.0         # the profiled window of a traced run
KEEP_UNTIL = 200_000    # request ids a run may keep the outputs of
FORBIDDEN = ("jax", "jaxlib", "flax", "world_tpu")


class Setup(Exception):
    """The run cannot start: no result is printed."""


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_of(name: str) -> tuple:
    """(BENCHMARK.json, the cell's entry, its configuration, its mix)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Setup(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT / conf["file"])
    mix = load_json(BENCH / "mixes" / f"{cell['traffic']}.json")
    cfg = dict(cfg, entry=cfg["entries"][mix["api"]],
               reference=cfg["references"][mix["api"]])
    return bench, cell, cfg, mix


def audio_of(cfg: dict, mix: dict):
    """The audio the configuration names (traffic/cuts.py's ``Audio``).
    Raise Setup where it names none, where its manifest's rate is not the
    configuration's, or where the mix asks for cuts longer than the audio:
    nothing is resampled or cut short."""
    from traffic import cuts
    if "audio" not in cfg:
        raise Setup(f"the configuration {cfg['name']!r} names no audio")
    try:
        audio = cuts.load(cfg["audio"])
    except FileNotFoundError as e:
        raise Setup(f"the audio {cfg['audio']!r} is missing: {e}") from e
    if audio.fs != cfg["fs"]:
        raise Setup(f"the audio {cfg['audio']!r} is at {audio.fs} Hz, the "
                    f"configuration {cfg['name']!r} at {cfg['fs']} Hz")
    max_s = mix["params"].get("max_s", 0.0)
    if int(max_s * audio.fs) > audio.x.shape[0]:
        raise Setup(f"the mix asks for cuts of up to {max_s} s; the audio "
                    f"{cfg['audio']!r} holds {audio.x.shape[0] / audio.fs} s")
    return audio


def metrics_of(bench: dict, cell: dict, trace: int) -> list:
    """The cell's metrics: end-to-end with ``--trace 0``, per-layer with
    ``--trace 1``; a metric with a ``workloads`` list only in those cells;
    a per-layer metric without one wherever its ``moves`` is reported."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unreadable"


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Run:
    """What the metric readers read: the cell, the record of the window,
    set-up seconds, and in a traced run the replays' device spans, the
    profiled window and the kernels' rooflines (``rooflines``: [(kernel,
    bound ms, what bounds it, measured ms)] of every K1-K7 launch of each
    signature's first call)."""

    def __init__(self, **kw):
        self.spans = self.profile = self.rooflines = None
        self.__dict__.update(kw)


def warm(system, plan, mix: dict, rooflines=None):
    """Each signature of the cell's traffic ``warm_repeats`` times (on a
    graph entry its eager call, then its capture).  With ``rooflines`` (a
    traced run) the first call of each signature, the entry's own, runs
    with its K1-K7 launches captured, and each launch's bound and time on
    the card are appended."""
    for call in plan.warm_calls():
        for i in range(mix["warm_repeats"]):
            if i == 0 and rooflines is not None:
                rooflines.extend(launch_rooflines(system, call))
            else:
                system.call(call)


def launch_rooflines(system, call) -> list:
    """[(kernel, bound ms, what bounds it, measured ms)] of every K1-K7
    launch of the entry's call ``call``."""
    from roofline import kernels
    launches = []
    with kernels.capture_launches(launches):
        system.call(call)
    return [(k, ms, by, kernels.time_launch(ln))
            for ln, (k, ms, by) in zip(launches, kernels.launch_bounds(launches))]


def look_for_cards(cell: dict):
    """Raise Setup unless the machine has the cards the cell asks for."""
    import torch
    if not torch.cuda.is_available():
        raise Setup("torch.cuda.is_available() is false: no card")
    if torch.cuda.device_count() < cell["chips"]:
        raise Setup(f"{torch.cuda.device_count()} cards, the cell needs "
                    f"{cell['chips']}")


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    """The peak of allocated bytes on the fullest card (0 on the CPU)."""
    import torch
    if device.type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(d)
               for d in range(torch.cuda.device_count()))


def run(args, t_start: float, device=None, cell_data=None) -> dict:
    """One run; ``device`` is the first card unless given (the tests drive
    a run on the CPU), ``cell_data`` what :func:`cell_of` reads unless
    given."""
    bench, cell, cfg, mix = cell_data or cell_of(args.workload)
    import torch
    try:
        import world_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        raise Setup(f"the program is not in this checkout: {e}") from e
    from traffic import common

    device = torch.device(device or "cuda:0")
    audio = audio_of(cfg, mix)
    x32 = audio.x
    driver = importlib.import_module(f"traffic.{mix['driver']}")
    params = mix["params"]
    plan = driver.plan(params, args.seed, audio, args.seconds)
    system = importlib.import_module(f"entries.{cfg['entry']}").System(
        cfg, x32, device)
    rooflines = [] if args.trace else None
    warm(system, plan, mix, rooflines)
    sync(device)
    setup_s = time.perf_counter() - t_start
    if args.trace and device.type == "cuda":
        # the launches' copies the rooflines took are the benchmark's
        torch.cuda.reset_peak_memory_stats(device)

    from harness import trace
    record = common.Record(keep=common.keep_ids(KEEP_UNTIL, args.seed,
                                                params["keep_share"]))
    calls0 = [dict(c.calls) for c in system.caches()]
    launches0 = trace.launches()
    spans = trace.ReplaySpans()
    if args.trace:
        with spans.installed():
            driver.run(trace.TaggingSystem(system, spans), plan, args.seconds,
                       record)
    else:
        driver.run(system, plan, args.seconds, record)
    sync(device)
    launches1 = trace.launches()
    caches = system.caches()
    counters = {"eager": sum(c.calls["eager"] - c0["eager"]
                             for c, c0 in zip(caches, calls0)),
                "captured": sum(c.calls["captured"] - c0["captured"]
                                for c, c0 in zip(caches, calls0)),
                "replayed": sum(c.calls["replayed"] - c0["replayed"]
                                for c, c0 in zip(caches, calls0)),
                "dropped": sum(c.dropped for c in caches),
                "pool_mib": sum(c.pool_bytes() for c in caches) / 2 ** 20,
                "launches": {k: launches1[k] - launches0[k] for k in launches1}}
    peak = memory_peak(device)
    info = Run(cell=cell, cfg=cfg, mix=mix, seed=args.seed, seconds=args.seconds,
               record=record, setup_s=setup_s, counters=counters,
               rooflines=rooflines)
    if args.trace:
        info.spans = spans.per_call_ms()
        pplan = driver.plan(params, args.seed, audio, PROFILE_S)

        def window():
            rec = common.Record()
            driver.run(system, pplan, PROFILE_S, rec)
            return len(rec.calls)

        l0 = trace.launches()
        info.profile = trace.profile_window(window)
        l1 = trace.launches()
        info.profile["launches"] = {k: l1[k] - l0[k] for k in l1}

    metrics = {}
    for m in metrics_of(bench, cell, args.trace):
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(info)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    samples = record.sample(args.seed, SAMPLE)
    system.close()
    system = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values, per = judge.check(cfg, x32, samples, device=device)
    limits = judge.limits_of(cell["name"])
    correct, rows = judge.verdict(values, limits)
    result = {"correct": correct, "attempted": len(record.requests),
              "failed": record.failed, "metrics": metrics,
              "device": {"platform": "gpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": cell["chips"], "memory_peak_bytes": int(peak)}}
    if args.trace:
        p = info.profile
        result["device"].update(busy_s=p["busy_s"], window_s=p["window_s"])
        result["breakdown"] = {"device_ops": p["device_ops"],
                               "idle_gaps": p["idle_gaps"]}
    lateness = getattr(record, "lateness", None)
    notes = [f"card: {card_line()}",
             f"window: {record.window_s():.3f} s, {len(record.calls)} calls, "
             f"{len(record.requests)} requests, {record.audio_s():.1f} audio s, "
             f"set-up {setup_s:.2f} s",
             "graph calls in the window: eager {eager}, captured {captured}, "
             "replayed {replayed}; dropped {dropped}; pool {pool_mib:.1f} MiB; "
             "launches {launches}".format(**counters)]
    if lateness:
        notes.append(f"open loop lateness: max {1e3 * max(lateness):.3f} ms, "
                     f"mean {1e3 * float(np.mean(lateness)):.3f} ms over "
                     f"{len(lateness)} requests that found the server idle")
    if rooflines:
        notes.append("roofline (bound/measured): " + "; ".join(
            f"{k} {b:.5f}/{t:.5f} ms ({by})" for k, b, by, t in rooflines))
    checked = [f"{k} {'missing' if v is None else format(v, '.6g')} "
               f"(limit {lim:g})" for k, v, lim in rows]
    others = {k: v for k, v in values.items() if k not in limits}
    result["checked"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return {"result": result, "notes": notes, "checked": checked,
            "others": others, "correct": correct, "values": values,
            "per_request": per, "samples": samples, "cfg": cfg, "x32": x32,
            "latencies_ms": record.latencies_ms()}


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        look_for_cards(cell_of(args.workload)[1])
        out = run(args, t_start)
    except Setup as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    except Exception:                       # noqa: BLE001  (a run's boundary)
        traceback.print_exc()
        print("benchmark: the run failed; no result", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or of the JAX package are loaded: "
              f"{', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for line in out["notes"]:
        print(line, file=sys.stderr)
    if out["others"]:
        print("not compared: " + ", ".join(f"{k} {v:.6g}" for k, v in
                                             sorted(out["others"].items())),
              file=sys.stderr)
    print("correct: " + str(out["correct"]).lower(), file=sys.stderr)
    for line in out["checked"]:
        print(line, file=sys.stderr)
    print(json.dumps(out["result"]))
    sys.stdout.flush()
    return 0
