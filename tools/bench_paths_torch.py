#!/usr/bin/env python3
"""xRT of every path of world_tpu_torch on one GPU, golden-gated, and the
Harvest path's batch sweep (the PyTorch port's counterpart of
tools/bench_paths.py and tools/bench_batch_scaling.py).

Run from the repository root:

    PYTHONPATH=. python3 tools/bench_paths_torch.py [--batch 1 2 4 8 16 32] [--out f.json]
    PYTHONPATH=. python3 tools/bench_paths_torch.py --device cpu --seconds 0.5 \
        --readings 1 --rounds 1 --batch 1 2

Paths, in float32 on tests/golden/harvest_16k.npz's x16 (4.644 s at 16 kHz),
each with its static tables resident:
  * dio_encode: DIO -> StoneMask -> CheapTrick -> D4C (``encode_classic_one``)
    replayed as a CUDA graph (a ``GraphCache`` on ``DioClassic``'s tables);
  * classic_roundtrip: the same, then classic synthesis (``DioClassic``, a
    graph replay, one noise draw from a generator on the device);
    each of the two also run eagerly on the same static code, under
    ``eager`` (on the CPU both run eagerly);
  * harvest_roundtrip: Harvest -> CheapTrick -> D4C-Requiem -> Requiem
    (``HarvestRequiem``, bench_torch.py's widths);
  * swipe_f0: SWIPE' ``get_f0`` (``SwipeF0``, pitch-strength threshold 0.3).

Each path is gated on its own timed output.  The Harvest path against the
golden (bench_torch.py's bars; "n/a" on a cut); the in-repo goldens at 16 kHz
cover no other path, so the classic paths and SWIPE' are held to the port's
own float64 run on the same device, at PERF.md section 2's bars (as
chip_smoke.py's phases 8 and 11 hold them).

The batch sweep runs the Harvest path on B copies of the input; row 0 of
each batch must keep the single stream's decisions (no vuv flip, at most
max(5, 1%) frames off by more than 0.5 Hz), as tools/bench_batch_scaling.py
checks.  Timing as bench_torch.py's: readings of ``rounds`` calls enqueued
back to back, CUDA events and one synchronize a reading, min/median/max.

Prints one JSON line; ``--out`` also writes it to a file.
"""
import argparse
import json
from pathlib import Path

import numpy as np

import bench_torch as BT
import chip_smoke as CS

FP = BT.FRAME_PERIOD
# PERF.md section 2: float32 against the port's float64 on the same device
CLASSIC_BARS = {"vuv_agreement": 0.99, "f0_median_err": 0.01, "f0_rmse": 1.0,
                "lsd": 1.0, "ap_max_db": 1.0}
SWIPE_BARS = {"vuv_agreement": 0.97, "median_rel_err": 1e-4, "within_1pct": 0.97}
# tools/bench_batch_scaling.py's decision gate for row 0 of a batch
BATCH_F0_OFF_HZ = 0.5


def classic_gate(dat, ref):
    """Float32 analysis (B = 1) against the float64 one: chip_smoke.py's
    bars (vuv, F0 median and RMSE, LSD, aperiodicity as 20 log10 of the
    linear amplitudes' ratio, on frames voiced in both)."""
    host = lambda d: {k: d[k][0].double().cpu().numpy()      # noqa: E731
                      for k in ("f0", "vuv", "spectrogram", "aperiodicity")}
    b = CS.classic_bars(host(dat), host(ref))
    return ("PASS" if CS.bars_met(b) else "FAIL"), b


def swipe_gate(f0, ref):
    """SWIPE' float32 against float64: chip_smoke.py's bars, on frames
    voiced in both (none voiced in both passes the two f0 bars)."""
    f0, ref = f0[0].double().cpu().numpy(), ref[0].double().cpu().numpy()
    both = (f0 > 0) & (ref > 0)
    rel = np.abs(f0[both] - ref[both]) / ref[both]
    b = {"vuv_agreement": float(((f0 > 0) == (ref > 0)).mean()),
         "median_rel_err": float(np.median(rel)) if rel.size else 0.0,
         "within_1pct": float((rel < 0.01).mean()) if rel.size else 1.0}
    ok = (b["vuv_agreement"] > SWIPE_BARS["vuv_agreement"]
          and b["median_rel_err"] < SWIPE_BARS["median_rel_err"]
          and b["within_1pct"] > SWIPE_BARS["within_1pct"])
    return ("PASS" if ok else "FAIL"), b


def waveform_ok(y) -> bool:
    import torch

    return bool(torch.isfinite(y).all()) and bool((y.abs().amax(dim=-1) > 0).all())


def run_path(name, fn, gate, audio_s, args, device, eager=None) -> dict:
    """The path's timed readings and gate; ``eager``, where given, is the
    same static code run eagerly, timed and gated the same way, under
    ``eager``."""
    stats, out = BT.timed_readings(fn, audio_s, args.readings, args.rounds, device)
    verdict, detail = gate(out)
    print(f"{name:18s} {stats['xrt']['median']:10.2f} xRT (min "
          f"{stats['xrt']['min']:.2f}, max {stats['xrt']['max']:.2f}), "
          f"{stats['ms_per_call']['median']:.2f} ms a call, gate {verdict}",
          flush=True)
    entry = dict(stats, gate=verdict, gate_detail=detail)
    if eager is not None:
        entry["eager"] = run_path(f"{name} eager", eager, gate, audio_s, args,
                                  device)
    return entry


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=None,
                    help="cut x16 to its first SECONDS")
    ap.add_argument("--readings", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batch", type=int, nargs="*", default=[1, 2, 4, 8, 16, 32])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.readings < 1 or args.rounds < 1:
        ap.error("--readings and --rounds must be at least 1")
    return args


def main(argv=None) -> dict:
    args = parse(argv)
    import torch

    from world_tpu_torch import DioClassic, HarvestRequiem, SwipeF0
    from world_tpu_torch.parallel.batch import (classic_caps, classic_tables,
                                                encode_classic_one, replays,
                                                table_identity)
    from world_tpu_torch.parallel.graphs import GraphCache
    from world_tpu_torch.synth.classic import standard_normal

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_paths_torch: no CUDA device; pass --device cpu "
                         "to run on the CPU")
    x, fs, g, full = BT.fixture(args.seconds)
    audio_s = x.shape[0] / fs
    f32, f64 = torch.float32, torch.float64
    x32 = torch.tensor(x, dtype=f32, device=device)[None]
    x64 = x32.double()
    paths = {}

    classic = DioClassic(fs, x.shape[0], FP, dtype=f32, device=device)
    tab32 = dict(classic.named_buffers())
    ref_dio = encode_classic_one(x64, fs, FP, classic_tables(fs, f64, device))
    encode = lambda x: encode_classic_one(x, fs, FP, tab32)     # noqa: E731
    encode_graphs = GraphCache()
    key = (str(device), tuple(x32.shape), table_identity(tab32))
    paths["dio_encode"] = run_path(
        "dio_encode", (lambda: encode_graphs.run(key, encode, (x32,), device))
        if replays(device) else (lambda: encode(x32)),
        lambda out: classic_gate(out, ref_dio), audio_s, args, device,
        eager=lambda: encode(x32))

    classic64 = DioClassic(fs, x.shape[0], FP, dtype=f64, device=device)
    _, max_pulses, max_noise = classic_caps(x.shape[0], fs, FP)
    noise = standard_normal((1, max_pulses, max_noise),
                            torch.Generator(device=device).manual_seed(1), f32,
                            device)
    ref_classic = classic64(x64, noise=noise.double())

    def classic_check(out):
        verdict, b = classic_gate(out, ref_classic)
        ok = waveform_ok(out["y"])
        return ("PASS" if verdict == "PASS" and ok else "FAIL"), dict(b, y_finite=ok)

    paths["classic_roundtrip"] = run_path(
        "classic_roundtrip", lambda: classic(x32, noise=noise), classic_check,
        audio_s, args, device,
        eager=lambda: BT.eager_classic_round_trip(classic, x32, noise))

    caps = BT.BENCH_CAPS if full else {}
    model = HarvestRequiem(fs, x.shape[0], FP, dtype=f32, device=device, **caps)
    paths["harvest_roundtrip"] = run_path(
        "harvest_roundtrip", lambda: model(x32),
        lambda out: BT.gate_rows(out, g, full), audio_s, args, device)

    swipe = SwipeF0(fs, x.shape[0], sTHR=0.3, dtype=f32, device=device)
    ref_sw = SwipeF0(fs, x.shape[0], sTHR=0.3, dtype=f64, device=device)(x64)["f0"]
    paths["swipe_f0"] = run_path(
        "swipe_f0", lambda: swipe(x32), lambda out: swipe_gate(out["f0"], ref_sw),
        audio_s, args, device)

    sweep = {}
    single = None
    for B in args.batch:
        xb = x32.expand(B, -1).contiguous()
        rounds = max(1, args.rounds // B)
        stats, out = BT.timed_readings(lambda: model(xb), audio_s * B,
                                       args.readings, rounds, device)
        if single is None:
            single = model(x32)
        flips = int((out["vuv"][0] != single["vuv"][0]).sum())
        off = int(((out["f0"][0] - single["f0"][0]).abs() > BATCH_F0_OFF_HZ).sum())
        n_frames = single["f0"].shape[1]
        ok = flips == 0 and off <= max(5, int(0.01 * n_frames)) and waveform_ok(out["y"])
        sweep[str(B)] = dict(stats, ms_per_utterance=stats["ms_per_call"]["median"] / B,
                             gate="PASS" if ok else "FAIL",
                             gate_detail={"vuv_flips_row0": flips,
                                          f"frames_off_gt_{BATCH_F0_OFF_HZ}hz_row0": off})
        print(f"harvest B={B:<3d} {stats['xrt']['median']:10.2f} xRT (min "
              f"{stats['xrt']['min']:.2f}, max {stats['xrt']['max']:.2f}), "
              f"{stats['ms_per_call']['median']:.2f} ms a call, "
              f"{stats['ms_per_call']['median'] / B:.2f} ms an utterance, gate "
              f"{sweep[str(B)]['gate']} (row 0: {flips} vuv flips, {off} frames off)",
              flush=True)

    doc = {
        "fixture": f"tests/golden/harvest_16k.npz x16 ({fs} Hz, {audio_s:.3f} s"
                   f"{'' if full else ', a cut'})",
        "dtype": "float32",
        "timing": "readings of `rounds` calls enqueued back to back (the batch "
                  "sweep: rounds // B, at least 1), CUDA events and one "
                  "synchronize a reading; min/median/max over readings; on the "
                  "card every path but swipe_f0 is a CUDA graph's replay, and "
                  "the classic paths' `eager` the same static code run eagerly",
        "gates": {"harvest_roundtrip": "golden " + json.dumps(BT.GATE_BARS),
                  "dio_encode, classic_roundtrip": "port float64 on the same "
                  "device " + json.dumps(CLASSIC_BARS),
                  "swipe_f0": "port float64 on the same device "
                  + json.dumps(SWIPE_BARS),
                  "batch": "row 0 keeps the single stream's decisions"},
        "paths": paths,
        "batch_sweep": sweep,
        **BT.environment(device),
    }
    line = json.dumps(doc)
    print(line)
    if args.out is not None:
        args.out.write_text(line + "\n")
    return doc


if __name__ == "__main__":
    main()
