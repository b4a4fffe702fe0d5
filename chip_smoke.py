#!/usr/bin/env python3
"""GPU smoke run of world_tpu_torch, the PyTorch/CUDA port of the WORLD vocoder.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):
  1. build the CUDA kernels from world_tpu_torch/csrc, print the card and
     each kernel's registers, shared memory and spills as ptxas reports
     them;
  2. K1 (event engine) against its plain PyTorch version on the card, in
     float32 and float64: at Harvest's main-path shape, at the 22.05 kHz
     geometry, and at DIO's geometry on the real DIO event rows of the
     16 kHz golden utterance and of dio.npz's decimated signal;
  3. K2 (refinement) against its plain version, float32 and float64, on
     the main path's operands and on real frames with adversarial slot
     layouts (all 48 slots live at 71 Hz, only the last slot live, none
     live, all at 800 Hz, 48 distinct long windows, a random half live);
  4. the Harvest -> CheapTrick -> D4C-Requiem -> Requiem round trip in
     float32 on the 16 kHz golden utterance through World.encode/decode,
     held to the golden bars; both kernels must have launched;
  5. a batch of 4 utterances through encode_decode_one: row 0 must take the
     single-stream run's decisions;
  6. timings with CUDA events: xRT of both round trips, each kernel against
     its plain version at each geometry and at batch 4, K1's passes apart
     and its launches per call (torch.profiler),
     where the classic round trip's time goes (the stage functions of
     world_tpu_torch.parallel.batch) and the device's idle share;
  7. DIO's stages after the decimation in float32 on dio.npz's decimated
     signal, held to tests/test_dio.py's golden bars;
  8. the classic DIO -> StoneMask -> CheapTrick -> D4C -> classic synthesis
     round trip in float32 on the 16 kHz golden utterance through
     World.encode/decode, held to the port's own float64 run on the card;
     K1 must have launched and K2 not;
  9. classic synthesis in float32 on the golden parameters against
     synthesis.npz's waveform;
 10. a batch of 4 utterances through the DioClassic module with one
     explicit noise draw from a generator on the card: row 0 must take the
     single-stream run's decisions; K1 must have launched and K2 not.
The last line is {"ok": true, "device": {...}}.  There is no CPU fallback.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN_DIR = ROOT / "tests" / "golden"
GOLDEN = GOLDEN_DIR / "harvest_16k.npz"
ALL_PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10)

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
# DIO's raw candidates in float32: K1 places each crossing at (i+1) - frac,
# so a position in a 4 kHz row of n < 32768 samples carries up to
# ulp(n) = 2**-9 samples of rounding, and the shortest interval (800 Hz) is
# 5 samples: relative error up to 2 * 2**-9 / 5 = 7.8e-4.  test_dio.py's
# float64 tolerance (rtol 1e-6, atol 1e-4) is printed beside this one.
DIO_F32_RAW_RTOL, DIO_RAW_ATOL = 1e-3, 1e-4

# The least time of a kernel's work on one H100 SXM (NVIDIA's data sheet):
# device memory at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations counted per unit of work, fixed when the kernels were first
# timed, so that their times compare across designs.  K1: the crossing test
# and position of each input sample (4), and for each (row, frame) the
# search for its edges and interval_select's arithmetic (64).  K2: for each
# sample of a slot's own window, the two window cosines and their blend, the
# two windowed samples and 24 multiply-adds (60).
K1_OPS_PER_SAMPLE, K1_OPS_PER_FRAME = 4, 64
K2_OPS_PER_WINDOW_SAMPLE = 60


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


def host_us(fn, iters: int = 200) -> float:
    """Mean host microseconds to enqueue one call of fn (no synchronize
    inside the timed loop): where it exceeds the device time, the host sets
    the pace of back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def bound(n_bytes: float, n_ops: float):
    """(least ms, what bounds it) for moving n_bytes and doing n_ops."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(rows, tq):
    """K1 reads the rows and frame times once and writes f0 (S, Q) and the
    counts (S,)."""
    S, n = rows.shape
    Q = tq.shape[0]
    isz = rows.element_size()
    return bound((S * n + Q + S * Q) * isz + 4 * S,
                 K1_OPS_PER_SAMPLE * S * n + K1_OPS_PER_FRAME * S * Q)


def k2_bound(ops):
    """K2 reads seg, phase (F, W), the candidates (C, F) and the DFT table,
    and writes refined f0 and score (C, F); the work is each non-empty
    slot's own window, as this run's candidates set it."""
    import torch

    f0 = ops["f0"]
    F, W = ops["seg"].shape
    C = f0.shape[0]
    isz = ops["seg"].element_size()
    live = f0[f0 > 1e-6].double()
    half = torch.clamp(torch.ceil(3 * ops["afs"] / live / 2), max=ops["max_half"])
    window_samples = float((2 * half + 1).sum())
    return bound((2 * F * W + 3 * C * F + 2 * ops["S"]) * isz,
                 K2_OPS_PER_WINDOW_SAMPLE * window_samples)


def main_path_operands(x16: np.ndarray, fs: int, dtype):
    """The operands each kernel gets on the Harvest path for utterances x16,
    (n,) or (B, n): K1's (608 B, n) event rows and K2's seg, phase (B F, W)
    and f0 (48, B F)."""
    import torch
    from world_tpu_torch.f0 import harvest as H
    from world_tpu_torch.f0.events import event_rows

    dev = torch.device("cuda")
    x = torch.tensor(np.atleast_2d(x16), dtype=dtype, device=dev)
    tables = H.harvest_tables(fs, 71.0, 800.0, dtype, dev)
    y, afs = H.downsample(x, fs, 8000, h=tables["decimator_ir"])
    filtered = H.band_filtered(y, tables["band_bank"], tables["band_bias"])
    rows = event_rows(filtered.reshape(-1, filtered.shape[-1]))
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


def adversarial_k2_operands(ops, n_frames: int = 600):
    """K2's operands on the main path's first real frames, with the slot
    layouts a frame can take: frame f takes layout f % 6 of all 48 slots
    live at 71 Hz (the full 341-sample window), only the last slot live, no
    slot live, all at 800 Hz, 48 distinct long windows (71-90 Hz, more than
    one pool of windows), and a random half of the slots live at 71-800 Hz."""
    import torch

    rng = np.random.RandomState(3)
    C = ops["f0"].shape[0]
    F = min(n_frames, ops["seg"].shape[0])
    f0 = np.full((C, F), 1e-12)
    for f in range(F):
        kind = f % 6
        if kind == 0:
            f0[:, f] = 71.0
        elif kind == 1:
            f0[-1, f] = 100.0 + f % 200
        elif kind == 3:
            f0[:, f] = 800.0
        elif kind == 4:
            f0[:, f] = rng.permutation(np.linspace(71.0, 90.0, C))
        elif kind == 5:
            live = rng.rand(C) < 0.5
            f0[live, f] = rng.uniform(71.0, 800.0, int(live.sum()))
    seg = ops["seg"]
    return dict(ops, seg=seg[:F].contiguous(), phase=ops["phase"][:F].contiguous(),
                f0=torch.tensor(f0, dtype=seg.dtype, device=seg.device))


def dio_event_operands(signal: np.ndarray, fs: int, n_frames: int, dtype):
    """K1's operands on the DIO path: the (28, n) event rows of the 7 band
    signals of the decimated input at 4 kHz, and the 5 ms frame grid
    (stride 20/1).  A 4 kHz signal is taken as already decimated."""
    import torch
    from world_tpu_torch.dsp.fir import band_filtered
    from world_tpu_torch.dsp.iir import decimate_world
    from world_tpu_torch.f0.dio import dio_tables
    from world_tpu_torch.f0.events import event_rows

    dev = torch.device("cuda")
    x = torch.tensor(signal, dtype=dtype, device=dev)[None]
    tables = dio_tables(fs, 71.0, 800.0, 2, 4000, dtype, dev)
    y = x if fs == 4000 else decimate_world(x, int(fs / 4000),
                                            h=tables["dio_decimator_ir"])
    filtered = band_filtered(y, tables["dio_bank"], tables["dio_offsets"])
    tq = torch.as_tensor(np.arange(n_frames) * 5.0 / 1000, dtype=dtype, device=dev)
    return {"rows": event_rows(filtered[0]), "tq": tq, "afs": 4000.0,
            "stride": 20.0}


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


def classic_bars(dat, ref):
    """The float32 classic analysis against the float64 one: vuv agreement,
    voiced F0 error (median, RMSE and the RMSE of the best 99% of frames),
    LSD and the aperiodicity's largest dB error, on frames voiced in both."""
    vuv, rvuv = dat["vuv"] > 0, ref["vuv"] > 0
    both = vuv & rvuv
    err = np.abs(dat["f0"][both].astype(np.float64) - ref["f0"][both])
    keep = np.sort(err)[:int(np.ceil(0.99 * err.size))]
    spec = np.asarray(dat["spectrogram"], np.float64)[:, both]
    rspec = np.asarray(ref["spectrogram"], np.float64)[:, both]
    ap = np.asarray(dat["aperiodicity"], np.float64)[:, both]
    rap = np.asarray(ref["aperiodicity"], np.float64)[:, both]
    return {"vuv_agreement": float(np.mean(vuv == rvuv)),
            "f0_median_err": float(np.median(err)),
            "f0_rmse": float(np.sqrt(np.mean(err ** 2))),
            "f0_rmse_trimmed99": float(np.sqrt(np.mean(keep ** 2))),
            "lsd": float(np.sqrt(np.mean((10 * np.log10(spec + 1e-12)
                                          - 10 * np.log10(rspec + 1e-12)) ** 2))),
            "ap_max_db": float(np.max(np.abs(20 * np.log10(ap / rap))))}


K1_PASSES = ("scan_crossings", "select_intervals")


def k1_pass_times(cases, iters: int = 20) -> dict:
    """Mean device microseconds of each pass of K1 (K1_PASSES), apart, and
    the device kernels per call, from torch.profiler over ``iters`` calls of
    each case; None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from world_tpu_torch.ops.edge_interp import event_engine_cuda

    out = {}
    for label, ops in cases:
        args = (ops["rows"], ops["afs"], ops["tq"], ops["stride"])
        event_engine_cuda(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                event_engine_cuda(*args)
            torch.cuda.synchronize()
        times = {}
        for ev in prof.key_averages():
            for name in K1_PASSES:
                if name in ev.key:
                    times[name] = times.get(name, 0.0) + _device_us(ev) / iters
        out[label] = {name: times.get(name) or None for name in K1_PASSES}
        n_events = device_totals(prof)[1]
        out[label]["device_kernels_per_call"] = n_events / iters if n_events else None
    return out


def _device_us(ev) -> float:
    return float(getattr(ev, "device_time_total", None)
                 or getattr(ev, "cuda_time_total", 0.0) or 0.0)


def device_totals(prof):
    """(device microseconds, number of device events) of a torch.profiler
    run: the sum over the events that ran on the device."""
    import torch

    us, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us += _device_us(ev)
            count += ev.count
    return us, count


def classic_stages(x16: np.ndarray, fs: int) -> dict:
    """Each stage of one float32 classic round trip on the card, by the
    stage functions encode_decode_classic_one composes: its milliseconds
    (CUDA events around each stage, after one warm-up run) and its device
    kernels and copies (torch.profiler, one more run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from world_tpu_torch.f0.dio import dio_core
    from world_tpu_torch.parallel import batch as PB
    from world_tpu_torch.synth.classic import standard_normal

    dev = torch.device("cuda")
    x = torch.tensor(x16, dtype=torch.float32, device=dev)[None]
    tables = PB.classic_tables(fs, torch.float32, dev)
    _, max_pulses, max_noise = PB.classic_caps(x.shape[1], fs, 5)
    state = {}

    def dio():
        state["dio"] = dio_core(x, fs, tables=tables)

    def stonemask():
        state["src"] = PB.stonemask_refine(x, fs, state["dio"], tables=tables)

    def cheaptrick():
        state["env"], _, state["f0_d4c"] = PB.spectral_envelope(
            x, fs, state["src"], 5)

    def d4c():
        state["ap"] = PB.d4c_aperiodicity(x, fs, state["f0_d4c"],
                                          state["src"]["temporal_positions"], 5,
                                          False)

    def synthesis():
        dat = dict(state["src"], f0=state["f0_d4c"],
                   spectrogram=state["env"].transpose(1, 2),
                   aperiodicity=state["ap"].transpose(1, 2))
        noise = standard_normal((1, max_pulses, max_noise), None, torch.float32,
                                dev)
        PB.synthesize_classic(dat, noise, fs, x.shape[1], 5)

    stages = (("DIO", dio), ("StoneMask", stonemask), ("CheapTrick", cheaptrick),
              ("D4C", d4c), ("classic synthesis", synthesis))
    for _, fn in stages:
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
    events[0].record()
    for i, (_, fn) in enumerate(stages):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    out = {name: {"ms": events[i].elapsed_time(events[i + 1])}
           for i, (name, _) in enumerate(stages)}
    for name, fn in stages:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[name]["device_events"] = device_totals(prof)[1]
    return out


def main(phases=ALL_PHASES) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from world_tpu_torch import DioClassic, HarvestRequiem, World
    from world_tpu_torch.parallel.batch import classic_caps
    from world_tpu_torch.synth.classic import standard_normal
    from world_tpu_torch._backend import kernel_library, kernel_resources
    from world_tpu_torch.f0.events import batched_interval_interp
    from world_tpu_torch.ops import edge_interp, refine_dft

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    g = np.load(GOLDEN)
    x16 = np.asarray(g["x16"])
    fs = int(g["fs"])
    duration = x16.shape[0] / fs
    n_frames_5ms = int(1000 * x16.shape[0] / fs / 5 + 1)
    gdio = np.load(GOLDEN_DIR / "dio.npz")
    kernels = {
        "event_engine": {"name": "event_engine", "route": "cuda",
                         "source": "world_tpu_torch/csrc/event_engine.cu",
                         "replaces": "world_tpu/ops/edge_interp.py:181",
                         "library_ms": None, "launches_by_path": {},
                         "geometries": {}},
        "refine_dft": {"name": "refine_dft", "route": "cuda",
                       "source": "world_tpu_torch/csrc/refine_dft.cu",
                       "replaces": "world_tpu/ops/refine_dft.py:125",
                       "library_ms": None, "launches_by_path": {},
                       "geometries": {}},
    }

    def path_launches(path: str):
        """Read and record the launch counts of the path just driven."""
        counts = {"event_engine": edge_interp.counter.launches,
                  "refine_dft": refine_dft.counter.launches}
        for name, n in counts.items():
            kernels[name]["launches_by_path"][path] = n
            kernels[name]["launches"] = sum(
                kernels[name]["launches_by_path"].values())
        return counts

    def reset_counts():
        edge_interp.counter.launches = 0
        refine_dft.counter.launches = 0

    # 1. build
    t0 = time.perf_counter()
    _, build_s = kernel_library()
    print(f"phase 1 build: nvcc {build_s:.2f} s, load {time.perf_counter() - t0:.2f} s "
          f"[{card}]")
    for k in kernel_resources():
        print(f"phase 1 ptxas {k['name']}: {k['registers']} registers, "
              f"{k['smem_bytes']} bytes static smem, {k['stack_bytes']} bytes "
              f"stack, spill stores "
              f"{k['spill_stores']} bytes, spill loads {k['spill_loads']} bytes")

    ops32 = dio32 = None
    if 2 in phases or 3 in phases or 6 in phases:
        ops32 = main_path_operands(x16, fs, torch.float32)
        dio32 = dio_event_operands(x16, fs, n_frames_5ms, torch.float32)
    if 2 in phases or 3 in phases:
        ops64 = main_path_operands(x16, fs, torch.float64)
    if 2 in phases:
        for dt, ops in (("float32", ops32), ("float64", ops64)):
            err = check_k1(ops["rows"], ops["afs"], ops["tq"], ops["stride"],
                           f"{dt} Harvest main path (stride 8/1)")
            if dt == "float32":
                kernels["event_engine"]["max_abs_err"] = err
            x, fsa, tq, stride = k1_geometry_22k(ops["rows"].dtype)
            check_k1(x, fsa, tq, stride, f"{dt} 22.05 kHz geometry (stride 147/20)")
            dtype = ops["rows"].dtype
            for label, sig, sfs, nf in (
                    ("x16", x16, fs, n_frames_5ms),
                    ("dio.npz y_decimated", np.asarray(gdio["y_decimated"]), 4000,
                     gdio["temporal_positions"].shape[0])):
                d = dio32 if (label == "x16" and dt == "float32") else \
                    dio_event_operands(sig, sfs, nf, dtype)
                err = check_k1(d["rows"], d["afs"], d["tq"], d["stride"],
                               f"{dt} DIO geometry, {label} (stride 20/1)")
                if dt == "float32" and label == "x16":
                    kernels["event_engine"]["geometries"]["dio_x16"] = {
                        "rows": list(d["rows"].shape), "Q": d["tq"].shape[0],
                        "max_abs_err": err}
        print("phase 2 K1: ok")
    if 3 in phases:
        for dt, ops in (("float32", ops32), ("float64", ops64)):
            err = check_k2(ops, f"{dt} main path")
            if dt == "float32":
                kernels["refine_dft"]["max_abs_err"] = err
            check_k2(adversarial_k2_operands(ops), f"{dt} adversarial slot layouts")
        print("phase 3 K2: ok")

    if 4 in phases:
        w = World(device="cuda", dtype=torch.float32)
        reset_counts()
        dat = w.encode(fs, x16, f0_method="harvest", is_requiem=True)
        out = w.decode(dat)
        torch.cuda.synchronize()
        counts = path_launches("harvest_requiem")
        if counts["event_engine"] == 0 or counts["refine_dft"] == 0:
            raise AssertionError(f"the Harvest path did not launch both kernels: "
                                 f"{counts}")
        agree, rmse, lsd, ap_err = golden_bars(dat, g)
        y = np.asarray(out["out"])
        print(f"phase 4 slice float32 on x16: vuv agreement {agree:.6f} (> 0.99), "
              f"voiced F0 RMSE {rmse:.6g} Hz (< 1), LSD {lsd:.6g} dB (< 1), "
              f"band-ap max err {ap_err:.6g} dB (< 1), y {y.shape} "
              f"max|y| {np.abs(y).max():.4g}; launches K1 "
              f"{counts['event_engine']}, K2 {counts['refine_dft']}")
        if not (agree > 0.99 and rmse < 1.0 and lsd < 1.0 and ap_err < 1.0):
            raise AssertionError("phase 4: golden bars not met")
        if not (np.all(np.isfinite(y)) and np.abs(y).max() > 0):
            raise AssertionError("phase 4: output waveform not finite or all zero")

    model = classic = None
    if 5 in phases or 6 in phases or 10 in phases:
        rng = np.random.RandomState(0)
        xs = np.stack([x16] + [x16 + 1e-3 * rng.randn(x16.shape[0])
                               for _ in range(3)])
        xs_t = torch.tensor(xs, dtype=torch.float32, device="cuda")
    if 5 in phases or 6 in phases:
        model = HarvestRequiem(fs, x16.shape[0], dtype=torch.float32,
                               device="cuda")
    if 10 in phases or 6 in phases:
        classic = DioClassic(fs, x16.shape[0], dtype=torch.float32, device="cuda")
        _, max_pulses, max_noise = classic_caps(x16.shape[0], fs, 5)
        noise = standard_normal((4, max_pulses, max_noise),
                                torch.Generator(device="cuda").manual_seed(1),
                                torch.float32, "cuda")
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

    if 7 in phases:
        from world_tpu_torch.f0.dio import dio_stages

        y_dec = torch.tensor(np.asarray(gdio["y_decimated"]), dtype=torch.float32,
                             device="cuda")[None]
        st = dio_stages(y_dec, 4000.0, 71.0, 800.0, 2, 5.0, 0.1,
                        gdio["temporal_positions"].shape[0])
        st = {k: (v if k == "temporal_positions" else v[0]).cpu().numpy()
              for k, v in st.items()}
        raw, graw = st["raw_f0_candidates"], gdio["raw_f0_candidate"]
        raw_agree = float(np.isclose(raw, graw, rtol=DIO_F32_RAW_RTOL,
                                     atol=DIO_RAW_ATOL).mean())
        raw_agree_f64_tol = float(np.isclose(raw, graw, rtol=1e-6,
                                             atol=DIO_RAW_ATOL).mean())
        vuv_agree = float(np.mean(st["vuv"] == gdio["vuv"]))
        both = (st["vuv"] == 1) & (gdio["vuv"] == 1)
        rmse = float(np.sqrt(np.mean((st["f0"][both] - gdio["f0"][both]) ** 2)))
        print(f"phase 7 DIO stages float32 on dio.npz y_decimated: raw candidates "
              f"agree on {raw_agree:.6f} at rtol {DIO_F32_RAW_RTOL} (> 0.999) and "
              f"on {raw_agree_f64_tol:.6f} at test_dio.py's rtol 1e-6; vuv "
              f"agreement {vuv_agree:.6f} (> 0.99), voiced F0 RMSE {rmse:.6g} Hz "
              f"(< 0.1)")
        if not (raw_agree > 0.999 and vuv_agree > 0.99 and rmse < 0.1):
            raise AssertionError("phase 7: DIO golden bars not met")

    w32 = None
    if 8 in phases or 6 in phases:
        w32 = World(device="cuda", dtype=torch.float32)
    if 8 in phases:
        w64 = World(device="cuda", dtype=torch.float64)
        ref = w64.encode(fs, x16, f0_method="dio", is_requiem=False)
        reset_counts()
        dat = w32.encode(fs, x16, f0_method="dio", is_requiem=False)
        out = w32.decode(dat)
        torch.cuda.synchronize()
        counts = path_launches("dio_classic")
        if counts["event_engine"] == 0 or counts["refine_dft"] != 0:
            raise AssertionError(f"the classic path must launch K1 and not K2: "
                                 f"{counts}")
        b = classic_bars(dat, ref)
        y = np.asarray(out["out"])
        print(f"phase 8 classic float32 on x16 vs the port's float64 on the card: "
              f"vuv agreement {b['vuv_agreement']:.6f} (> 0.99), voiced F0 median "
              f"err {b['f0_median_err']:.6g} Hz (< 0.01), RMSE {b['f0_rmse']:.6g} Hz "
              f"(< 1), trimmed-99% RMSE {b['f0_rmse_trimmed99']:.6g} Hz, LSD "
              f"{b['lsd']:.6g} dB (< 1), aperiodicity max err {b['ap_max_db']:.6g} "
              f"dB (< 1), y {y.shape} max|y| {np.abs(y).max():.4g}; launches K1 "
              f"{counts['event_engine']}, K2 {counts['refine_dft']}")
        if not (b["vuv_agreement"] > 0.99 and b["f0_median_err"] < 0.01
                and b["f0_rmse"] < 1.0 and b["lsd"] < 1.0 and b["ap_max_db"] < 1.0):
            raise AssertionError("phase 8: classic bars not met")
        if not (np.all(np.isfinite(y)) and np.abs(y).max() > 0):
            raise AssertionError("phase 8: output waveform not finite or all zero")

    if 10 in phases:
        # the single stream draws its noise from a generator seeded 0 on
        # the card; the batch takes the explicit draw
        single = classic(xs_t[:1])
        reset_counts()
        batch = classic(xs_t, noise=noise)
        torch.cuda.synchronize()
        counts = path_launches("dio_classic_batch")
        flips = int((single["vuv"][0] != batch["vuv"][0]).sum())
        off = int(((single["f0"][0] - batch["f0"][0]).abs() > 0.5).sum())
        bitwise = all(torch.equal(single[k][0], batch[k][0])
                      for k in ("f0", "vuv", "spectrogram", "aperiodicity"))
        print(f"phase 10 classic batch of 4 through DioClassic: row 0 vs single "
              f"stream: {flips} vuv flips, {off} frames off by > 0.5 Hz, "
              f"analysis bitwise equal: {bitwise}; y {tuple(batch['y'].shape)}, "
              f"overflow flags {batch['_overflow'].tolist()}; launches K1 "
              f"{counts['event_engine']}, K2 {counts['refine_dft']}")
        if flips or off:
            raise AssertionError("phase 10: batched row 0 changed decisions")
        if counts["event_engine"] == 0 or counts["refine_dft"] != 0:
            raise AssertionError(f"phase 10: the classic batch must launch K1 and "
                                 f"not K2: {counts}")
        if not (torch.isfinite(batch["y"]).all() and torch.isfinite(single["y"]).all()
                and bool((batch["y"].abs().amax(dim=1) > 0).all())):
            raise AssertionError("phase 10: non-finite or all-zero batched output")

    if 9 in phases:
        from world_tpu_torch.synth.classic import synthesis

        src = np.load(GOLDEN_DIR / "source_dio.npz")
        d4 = np.load(GOLDEN_DIR / "d4c.npz")
        gdat = {"f0": d4["f0_after_mutation"], "vuv": src["vuv"],
                "temporal_positions": src["temporal_positions"],
                "spectrogram": np.load(GOLDEN_DIR / "cheaptrick.npz")["spectrogram"],
                "aperiodicity": d4["aperiodicity"], "fs": 22050}
        ref_y = np.load(GOLDEN_DIR / "synthesis.npz")["y_det"]
        y = synthesis(gdat, gdat, noise_mode="constant", dtype=torch.float32,
                      device="cuda").cpu().numpy().astype(np.float64)
        corr = float(np.corrcoef(y, ref_y)[0, 1])
        rel = float(np.linalg.norm(y - ref_y) / np.linalg.norm(ref_y))
        print(f"phase 9 classic synthesis float32 on the golden parameters: "
              f"correlation {corr:.7f} (> 0.999), relative L2 {rel:.4g} (< 1e-2)")
        if not (y.shape == ref_y.shape and corr > 0.999 and rel < 1e-2):
            raise AssertionError("phase 9: golden synthesis bars not met")

    if 6 in phases:
        # K1's passes apart, first: the profiler is used again below
        passes = k1_pass_times([("harvest_8k", ops32), ("dio_x16", dio32)])
        kernels["event_engine"]["pass_us"] = passes
        for geo, t in passes.items():
            print(f"phase 6 event_engine passes at {geo} (torch.profiler) [{card}]: "
                  + ", ".join(f"{k} {'not measured' if t[k] is None else f'{t[k]:.2f} us'}"
                              for k in K1_PASSES)
                  + f"; device kernels per call {t['device_kernels_per_call']}")
            if (t["device_kernels_per_call"] or 0) > 2:
                raise AssertionError(f"K1 at {geo}: more than two launches per call")
        t_single = cuda_ms(lambda: model(xs_t[:1]), iters=3)
        t_batch = cuda_ms(lambda: model(xs_t), iters=3)
        print(f"phase 6 Harvest/Requiem round trip float32 (4.644 s utterance) "
              f"[{card}]: single {t_single:.2f} ms = "
              f"{duration / (t_single / 1e3):.2f} xRT; batch-4 {t_batch:.2f} ms = "
              f"{4 * duration / (t_batch / 1e3):.2f} xRT")
        saved = (edge_interp.counter.launches, refine_dft.counter.launches)
        reset_counts()
        t_classic = cuda_ms(lambda: w32.decode(w32.encode(
            fs, x16, f0_method="dio", is_requiem=False)), iters=3)
        per_call = edge_interp.counter.launches / 4
        t_cbatch = cuda_ms(lambda: classic(xs_t, noise=noise), iters=3)
        print(f"phase 6 classic round trip float32 (4.644 s utterance) [{card}]: "
              f"single {t_classic:.2f} ms = {duration / (t_classic / 1e3):.2f} xRT "
              f"(World.encode/decode); batch-4 {t_cbatch:.2f} ms = "
              f"{4 * duration / (t_cbatch / 1e3):.2f} xRT (DioClassic); K1 launches "
              f"per single round trip {per_call:g}, K2 "
              f"{refine_dft.counter.launches / 4:g}")
        stages = classic_stages(x16, fs)
        print(f"phase 6 classic stages float32 [{card}]: "
              + ", ".join(f"{k} {v['ms']:.2f} ms ({v['device_events']} device "
                          f"events)" for k, v in stages.items()))
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            w32.decode(w32.encode(fs, x16, f0_method="dio", is_requiem=False))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_us, n_kernels = device_totals(prof)
        if n_kernels:
            # the profiler slows the host: the idle share is taken against the
            # unprofiled round trip's CUDA-event time above
            print(f"phase 6 classic round trip under torch.profiler [{card}]: "
                  f"{n_kernels} device kernels and copies, {dev_us / 1e3:.3f} ms "
                  f"device time; device idle share {1 - dev_us / 1e3 / t_classic:.3f} "
                  f"of the unprofiled {t_classic:.2f} ms (CUDA events), "
                  f"{1 - dev_us / 1e3 / wall_ms:.3f} of the profiled {wall_ms:.2f} "
                  f"ms wall")
        else:
            print(f"phase 6 classic round trip under torch.profiler [{card}]: "
                  f"no device events recorded; device time not measured")

        o = ops32
        b4 = main_path_operands(xs, fs, torch.float32)

        def k1_case(geo, ops, plain_iters=5):
            return ("event_engine", geo, (ops["rows"], ops["afs"], ops["tq"],
                                          ops["stride"]),
                    k1_bound(ops["rows"], ops["tq"]), plain_iters)

        def k2_case(geo, ops, plain_iters=5):
            return ("refine_dft", geo, (ops["seg"], ops["phase"], ops["f0"],
                                        ops["afs"], ops["max_half"], ops["S"],
                                        71.0, 800.0, ops["table"]),
                    k2_bound(ops), plain_iters)

        cases = [k1_case("harvest_8k", o), k1_case("dio_x16", dio32),
                 k1_case("harvest_8k_batch4", b4, 2),
                 k2_case("harvest_8k", o), k2_case("harvest_8k_batch4", b4, 2)]
        fns = {"event_engine": (edge_interp.event_engine_cuda,
                                batched_interval_interp),
               "refine_dft": (refine_dft.refine_cuda, refine_dft.refine_plain)}
        for name, geo, args, (b_ms, b_by), plain_iters in cases:
            kern, plain = fns[name]
            # plain, kernel, kernel, plain: report the mean of each pair
            p1 = cuda_ms(lambda: plain(*args), iters=plain_iters)
            k1 = cuda_ms(lambda: kern(*args), iters=20)
            k2 = cuda_ms(lambda: kern(*args), iters=20)
            p2 = cuda_ms(lambda: plain(*args), iters=plain_iters)
            h_us = host_us(lambda: kern(*args))
            entry = kernels[name]["geometries"].setdefault(geo, {})
            entry.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=b_ms,
                         bound_by=b_by, host_us=h_us)
            if geo == "harvest_8k":
                kernels[name].update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                                     bound_ms=b_ms, bound_by=b_by)
            print(f"phase 6 {name} float32 at {geo} [{card}]: kernel "
                  f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}), share of bound "
                  f"{b_ms / ((k1 + k2) / 2):.3f}; the wrapper's host time "
                  f"{h_us:.1f} us a call")
        del b4
        edge_interp.counter.launches, refine_dft.counter.launches = saved

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
