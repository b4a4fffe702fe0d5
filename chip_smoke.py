#!/usr/bin/env python3
"""GPU smoke run of world_tpu_torch, the PyTorch/CUDA port of the WORLD vocoder.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):
  1. build the CUDA kernels from world_tpu_torch/csrc and print the card;
  2. K1 (event engine) against its plain PyTorch version on the card, in
     float32 and float64, at the main-path shape and at 22.05 kHz geometry;
  3. K2 (refinement) against its plain version, float32 and float64;
  4. the Harvest -> CheapTrick -> D4C-Requiem -> Requiem round trip in
     float32 on the 16 kHz golden utterance through World.encode/decode,
     held to the golden bars; both kernels must have launched;
  5. a batch of 4 utterances through encode_decode_one: row 0 must take the
     single-stream run's decisions;
  6. timings with CUDA events: xRT single and batch-4, and each kernel
     against its plain version.
The last line is {"ok": true, "device": {...}}.  There is no CPU fallback.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "harvest_16k.npz"

# K1: kernel and plain version evaluate the same IEEE operations in the same
# order, so the interpolated f0 may differ only by rounding of equal
# operations; bound it at 4 units in the last place.
K1_ULP_BOUND = 4
# K2 float64: the two versions differ only in the DFT sums' association.
K2_F64_RTOL, K2_F64_ATOL = 1e-9, 1e-12
# K2 float32: the 24 dot products are summed in another order (warp tree vs
# PyTorch's reduction), and the instantaneous-frequency numerator cancels:
# refined f0 agrees to K2_F32_RTOL where both gates pass, and the gate
# (score >= 2.5, floor <= f0 <= ceil) may flip on at most this share of the
# non-empty slots.
K2_F32_RTOL = 1e-4
K2_F32_GATE_SHARE = 1e-3


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn, by CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main_path_operands(x16: np.ndarray, fs: int, dtype):
    """The operands each kernel gets on the main path for the golden
    utterance: K1's (608, n) event rows and K2's seg, phase, f0."""
    import torch
    from world_tpu_torch.f0 import harvest as H
    from world_tpu_torch.f0.events import event_rows

    dev = torch.device("cuda")
    x = torch.tensor(x16, dtype=dtype, device=dev)[None]
    tables = H.harvest_tables(fs, 71.0, 800.0, dtype, dev)
    y, afs = H.downsample(x, fs, 8000, h=tables["decimator_ir"])
    filtered = H.band_filtered(y, tables["band_bank"], tables["band_bias"])
    rows = event_rows(filtered[0])
    n_frames = int(1000 * x.shape[1] / fs + 1)
    tq = torch.as_tensor(np.arange(n_frames) / 1000, dtype=dtype, device=dev)
    bfl = H.boundary_f0_list(71.0, 800.0)
    raw = H.raw_band_candidates(y, afs, tables["band_bank"],
                                tables["band_bias"], bfl, tq, 71.0, 800.0)
    cands0, _ = H.detect_candidates(raw, H.default_max_candidates())
    cands1 = H.overlap_candidates(cands0)
    compact, _ = H.compact_rows(cands1.transpose(-1, -2), cands1.transpose(-1, -2) != 0,
                                H.C2_SLOTS)
    max_half, S = H.refinement_geometry(afs, 71.0)
    seg, phase, f0 = H.refinement_inputs(y, afs, tq, compact.transpose(-1, -2),
                                         max_half)
    table = (tables["refine_cos"], tables["refine_sin"])
    return {"rows": rows, "tq": tq, "afs": afs, "stride": afs * 0.001,
            "seg": seg, "phase": phase, "f0": f0, "max_half": max_half, "S": S,
            "table": table}


def check_k1(rows, fs, tq, stride, label):
    import torch
    from world_tpu_torch.f0.events import batched_interval_interp
    from world_tpu_torch.ops.edge_interp import event_engine_cuda

    got, got_m = event_engine_cuda(rows, fs, tq, stride)
    want, want_m = batched_interval_interp(rows, fs, tq, stride)
    torch.cuda.synchronize()
    if not torch.equal(got_m, want_m):
        raise AssertionError(f"K1 {label}: interval counts differ in "
                             f"{int((got_m != want_m).sum())} rows")
    for name, f in (("NaN", torch.isnan), ("+inf", torch.isposinf),
                    ("-inf", torch.isneginf)):
        if not torch.equal(f(got), f(want)):
            raise AssertionError(f"K1 {label}: {name} positions differ")
    fin = torch.isfinite(want)
    g, w = got[fin].double(), want[fin].double()
    eps = torch.finfo(rows.dtype).eps
    ulp = ((g - w).abs() / (eps * w.abs().clamp(min=torch.finfo(rows.dtype).tiny)))
    max_ulp = float(ulp.max()) if ulp.numel() else 0.0
    max_abs = float((g - w).abs().max()) if g.numel() else 0.0
    print(f"K1 {label}: rows {tuple(rows.shape)} Q {tq.shape[0]}: counts equal, "
          f"NaN/inf equal, max {max_ulp:.3g} ulp, max abs err {max_abs:.3g} Hz, "
          f"bitwise {torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))}")
    if max_ulp > K1_ULP_BOUND:
        raise AssertionError(f"K1 {label}: {max_ulp} ulp > {K1_ULP_BOUND}")
    return max_abs


def k1_geometry_22k(dtype):
    """Rows at the 22.05 kHz geometry (actual_fs 7350, stride 147/20):
    noisy tones over the band range, noise rows and an all-zero row."""
    import torch

    rng = np.random.RandomState(1)
    fs = 7350.0
    n = int(4.644 * fs)
    Q = int(1000 * n / fs + 1)
    t = np.arange(n) / fs
    rows = []
    for f in (80.0, 125.0, 333.0, 707.0):
        rows.extend([np.sin(2 * np.pi * f * t + rng.rand() * 6)
                     + 0.05 * rng.randn(n) for _ in range(12)])
    rows.extend([rng.randn(n) for _ in range(8)])
    rows.append(rng.randn(n) * 1e-6)
    rows.append(np.zeros(n))
    x = torch.tensor(np.stack(rows), dtype=dtype, device="cuda")
    tq = torch.as_tensor(np.arange(Q) / 1000, dtype=dtype, device="cuda")
    return x, fs, tq, fs * 0.001


def check_k2(ops, label):
    import torch
    from world_tpu_torch.ops.refine_dft import refine_cuda, refine_plain

    args = (ops["seg"], ops["phase"], ops["f0"], ops["afs"], ops["max_half"],
            ops["S"], 71.0, 800.0, ops["table"])
    got_r, got_s = refine_cuda(*args)
    want_r, want_s = refine_plain(*args)
    torch.cuda.synchronize()
    nonempty = int((ops["f0"] > 1e-6).sum())
    C, F = ops["f0"].shape
    W = ops["seg"].shape[1]
    if ops["seg"].dtype == torch.float64:
        for name, g, w in (("refined", got_r, want_r), ("score", got_s, want_s)):
            if not torch.allclose(g, w, rtol=K2_F64_RTOL, atol=K2_F64_ATOL):
                bad = int((~torch.isclose(g, w, rtol=K2_F64_RTOL,
                                          atol=K2_F64_ATOL)).sum())
                raise AssertionError(f"K2 {label}: {name} differs in {bad} slots")
        err = float((got_r - want_r).abs().max())
        print(f"K2 {label}: (C2, F, W, S) = ({C}, {F}, {W}, {ops['S']}), "
              f"{nonempty} non-empty slots: within rtol {K2_F64_RTOL}, "
              f"max abs err {err:.3g} Hz")
        return err
    both = (got_r > 0) & (want_r > 0)
    rel = ((got_r - want_r).abs() / want_r.abs().clamp(min=1e-30))[both]
    max_rel = float(rel.max()) if rel.numel() else 0.0
    flips = int(((got_r > 0) != (want_r > 0)).sum())
    share = flips / max(nonempty, 1)
    err = float((got_r - want_r).abs()[both].max()) if rel.numel() else 0.0
    print(f"K2 {label}: (C2, F, W, S) = ({C}, {F}, {W}, {ops['S']}), "
          f"{nonempty} non-empty slots: refined max rel err {max_rel:.3g} "
          f"(bar {K2_F32_RTOL}), max abs err {err:.3g} Hz, gate flips {flips} "
          f"= {share:.3g} of non-empty (bar {K2_F32_GATE_SHARE})")
    if max_rel > K2_F32_RTOL or share > K2_F32_GATE_SHARE:
        raise AssertionError(f"K2 {label}: outside its bars")
    return err


def golden_bars(dat, g):
    f0 = np.asarray(dat["f0"])
    vuv = np.asarray(dat["vuv"]) > 0
    gvuv = np.asarray(g["vuv"]) > 0
    both = vuv & gvuv
    agree = float(np.mean(vuv == gvuv))
    rmse = float(np.sqrt(np.mean((f0[both] - g["f0"][both]) ** 2)))
    spec = np.asarray(dat["spectrogram"], np.float64)
    lsd = float(np.sqrt(np.mean((10 * np.log10(spec[:, both] + 1e-12)
                                 - 10 * np.log10(g["spectrogram"][:, both]
                                                 + 1e-12)) ** 2)))
    ap = np.asarray(dat["aperiodicity"], np.float64)
    ap_err = float(np.max(np.abs(ap[:, both] - g["band_aperiodicity"][:, both])))
    return agree, rmse, lsd, ap_err


def main(phases=(1, 2, 3, 4, 5, 6)) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from world_tpu_torch import HarvestRequiem, World
    from world_tpu_torch._backend import kernel_library
    from world_tpu_torch.f0.events import batched_interval_interp
    from world_tpu_torch.ops import edge_interp, refine_dft

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    g = np.load(GOLDEN)
    x16 = np.asarray(g["x16"])
    fs = int(g["fs"])
    duration = x16.shape[0] / fs
    kernels = {
        "event_engine": {"name": "event_engine", "route": "cuda",
                         "source": "world_tpu_torch/csrc/event_engine.cu",
                         "replaces": "world_tpu/ops/edge_interp.py:181"},
        "refine_dft": {"name": "refine_dft", "route": "cuda",
                       "source": "world_tpu_torch/csrc/refine_dft.cu",
                       "replaces": "world_tpu/ops/refine_dft.py:125"},
    }

    # 1. build
    t0 = time.perf_counter()
    _, build_s = kernel_library()
    print(f"phase 1 build: nvcc {build_s:.2f} s, load {time.perf_counter() - t0:.2f} s "
          f"[{card}]")

    ops32 = None
    if 2 in phases or 3 in phases or 6 in phases:
        ops32 = main_path_operands(x16, fs, torch.float32)
    if 2 in phases or 3 in phases:
        ops64 = main_path_operands(x16, fs, torch.float64)
    if 2 in phases:
        for dt, ops in (("float32", ops32), ("float64", ops64)):
            err = check_k1(ops["rows"], ops["afs"], ops["tq"], ops["stride"],
                           f"{dt} main path (stride 8/1)")
            if dt == "float32":
                kernels["event_engine"]["max_abs_err"] = err
            x, fsa, tq, stride = k1_geometry_22k(ops["rows"].dtype)
            check_k1(x, fsa, tq, stride, f"{dt} 22.05 kHz geometry (stride 147/20)")
        print("phase 2 K1: ok")
    if 3 in phases:
        for dt, ops in (("float32", ops32), ("float64", ops64)):
            err = check_k2(ops, f"{dt} main path")
            if dt == "float32":
                kernels["refine_dft"]["max_abs_err"] = err
        print("phase 3 K2: ok")

    if 4 in phases:
        w = World(device="cuda", dtype=torch.float32)
        edge_interp.counter.launches = 0
        refine_dft.counter.launches = 0
        dat = w.encode(fs, x16, f0_method="harvest", is_requiem=True)
        out = w.decode(dat)
        torch.cuda.synchronize()
        kernels["event_engine"]["launches"] = edge_interp.counter.launches
        kernels["refine_dft"]["launches"] = refine_dft.counter.launches
        if edge_interp.counter.launches == 0 or refine_dft.counter.launches == 0:
            raise AssertionError("the main path did not launch both kernels: "
                                 f"K1 {edge_interp.counter.launches}, "
                                 f"K2 {refine_dft.counter.launches}")
        agree, rmse, lsd, ap_err = golden_bars(dat, g)
        y = np.asarray(out["out"])
        print(f"phase 4 slice float32 on x16: vuv agreement {agree:.6f} (> 0.99), "
              f"voiced F0 RMSE {rmse:.6g} Hz (< 1), LSD {lsd:.6g} dB (< 1), "
              f"band-ap max err {ap_err:.6g} dB (< 1), y {y.shape} "
              f"max|y| {np.abs(y).max():.4g}; launches K1 "
              f"{edge_interp.counter.launches}, K2 {refine_dft.counter.launches}")
        if not (agree > 0.99 and rmse < 1.0 and lsd < 1.0 and ap_err < 1.0):
            raise AssertionError("phase 4: golden bars not met")
        if not (np.all(np.isfinite(y)) and np.abs(y).max() > 0):
            raise AssertionError("phase 4: output waveform not finite or all zero")

    model = None
    if 5 in phases or 6 in phases:
        model = HarvestRequiem(fs, x16.shape[0], dtype=torch.float32,
                               device="cuda")
        rng = np.random.RandomState(0)
        xs = np.stack([x16] + [x16 + 1e-3 * rng.randn(x16.shape[0])
                               for _ in range(3)])
        xs_t = torch.tensor(xs, dtype=torch.float32, device="cuda")
    if 5 in phases:
        single = model(xs_t[:1])
        batch = model(xs_t)
        torch.cuda.synchronize()
        flips = int((single["vuv"][0] != batch["vuv"][0]).sum())
        off = int(((single["f0"][0] - batch["f0"][0]).abs() > 0.5).sum())
        bitwise = all(torch.equal(single[k][0], batch[k][0])
                      for k in ("f0", "vuv", "spectrogram", "band_aperiodicity"))
        print(f"phase 5 batch of 4: row 0 vs single stream: {flips} vuv flips, "
              f"{off} frames off by > 0.5 Hz, analysis bitwise equal: {bitwise}; "
              f"overflow flags {batch['_overflow'].tolist()}")
        if flips or off:
            raise AssertionError("phase 5: batched row 0 changed decisions")
        if not all(torch.isfinite(batch["y"][b]).all() for b in range(4)):
            raise AssertionError("phase 5: non-finite batched output")

    if 6 in phases:
        t_single = cuda_ms(lambda: model(xs_t[:1]), iters=3)
        t_batch = cuda_ms(lambda: model(xs_t), iters=3)
        print(f"phase 6 round trip float32 (4.644 s utterance) [{card}]: "
              f"single {t_single:.2f} ms = {duration / (t_single / 1e3):.2f} xRT; "
              f"batch-4 {t_batch:.2f} ms = {4 * duration / (t_batch / 1e3):.2f} xRT")
        o = ops32
        k1_args = (o["rows"], o["afs"], o["tq"], o["stride"])
        k2_args = (o["seg"], o["phase"], o["f0"], o["afs"], o["max_half"],
                   o["S"], 71.0, 800.0, o["table"])
        timings = [
            ("event_engine", lambda: edge_interp.event_engine_cuda(*k1_args),
             lambda: batched_interval_interp(*k1_args)),
            ("refine_dft", lambda: refine_dft.refine_cuda(*k2_args),
             lambda: refine_dft.refine_plain(*k2_args)),
        ]
        saved = (edge_interp.counter.launches, refine_dft.counter.launches)
        for name, kern, plain in timings:
            # plain, kernel, kernel, plain: report the mean of each pair
            p1 = cuda_ms(plain, iters=5)
            k1 = cuda_ms(kern, iters=20)
            k2 = cuda_ms(kern, iters=20)
            p2 = cuda_ms(plain, iters=5)
            kernels[name]["ms"] = (k1 + k2) / 2
            kernels[name]["plain_ms"] = (p1 + p2) / 2
            print(f"phase 6 {name} float32 main-path shape [{card}]: kernel "
                  f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
        edge_interp.counter.launches, refine_dft.counter.launches = saved

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
