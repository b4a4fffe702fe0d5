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
     16 kHz golden utterance and of dio.npz's decimated signal; K3 (DIO's
     extension scans), both scans, bitwise against its plain version in
     both types on DIO's own operands of x16 (929 frames), of a batch of 4
     and of the 60 s glide (12,001 frames), and on contours of 1-3 frame
     sections, none voiced, voiced to the end;
  3. K2 (refinement) against its plain version, float32 and float64, on
     the main path's operands and on real frames with adversarial slot
     layouts (all 48 slots live at 71 Hz, only the last slot live, none
     live, all at 800 Hz, 48 distinct long windows, a random half live);
  4. the Harvest -> CheapTrick -> D4C-Requiem -> Requiem round trip in
     float32 on the 16 kHz golden utterance through World.encode/decode,
     held to the golden bars; both kernels must have launched;
  5. a batch of 4 utterances through HarvestRequiem (a CUDA graph per batch
     size from its second call): row 0 must take the single-stream run's
     decisions;
 18. the static round trip and its graph, float32, single and batch 4: the
     eager static call from the upload to the output makes no host sync
     (set_sync_debug_mode "error"), the graph's replay is bitwise the eager
     call and itself, meets phase 4's golden bars, and launches K1 and K2
     once; the first call (eager) and the second (capture), the pool, the
     replay beside the eager call and its device events; a function that
     syncs fails to capture;
 19. the classic round trip on static shapes and its graph, float32,
     through DioClassic: x16 single and batch 4, then the 60 s glide; the
     eager static call from the upload to the output makes no host sync,
     the module's first call runs eagerly, its second captures, and its
     replays are bitwise the eager call and each other (f0, vuv, envelope,
     aperiodicity, y, flags), launch K1 once, K3 twice and K2 never, and
     row 0 meets phase 8's bars against float64 on the card; the first
     call, the capture, the pool, the replay beside the eager call and its
     device events; at 60 s the classic synthesis' peak memory inside the
     stage budget;
  6. timings with CUDA events: xRT of both round trips (each as a graph
     replay and eagerly), the classic stages' host syncs (all 0), each
     kernel against
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
     single-stream run's decisions; K1 must have launched and K2 not;
 11. path A, SWIPE': float32 against the port's float64 run on the card at
     tests/test_swipe.py's bars, then World.encode(f0_method="swipe") ->
     decode; neither kernel may launch;
 12. path B, voice conversion and prosody: Harvest and DIO analyses (the
     default and with fft_size=2048, float32 against float64 on the card,
     both kernels held against their plain versions at that geometry), the
     MCEP and filterbank codecs, the VAE MLP pair through encode_vae against
     a numpy forward pass, scale_pitch, modify_duration and warp_spectrum,
     then decode on the warped frame grid (classic and Requiem),
     encode_w_gvn_f0 on the golden contour, save -> load;
 13. path C, ragged serving: six utterances of 0.9-4.644 s through
     batch_encode_decode_ragged in five length buckets; each row against a
     one-utterance call at the same padded length; the first call runs
     eagerly, the second captures each bucket's graph, and the next replays
     them, launching both kernels once per bucket; both are held against
     their plain versions at every bucket's geometry;
 14. long audio: check_long_audio.py's 60 s glide at 22.05 kHz in float32
     through World.encode(harvest, requiem) -> decode with that script's
     asserts, against the float64 analysis on the card, and blocked against
     unblocked (vuv equal); both kernels against their plain versions at the
     band chunk's and the frame chunk's geometry in both types (K1
     bitwise); harvest()'s peak memory blocked and unblocked; the same 60 s
     through DIO and classic synthesis; LONG_SECONDS of the glide at 16 kHz
     through Harvest alone, blocked, and unblocked where it fits;
 15. rows and devices: 110 utterances of 0.5 s through batch_encode_decode
     (more rows than one K1 launch takes); phase 5's batch over
     devices=["cuda:0", "cuda:0"], each shard bitwise its one-device call,
     its waveform too, and one call run twice bitwise equal;
     frame_sharded_cheaptrick over two and four shards against cheaptrick;
 16. Harvest on 22.05 kHz speech: the stages after the downsampler in
     float32 from tests/golden/harvest.npz's decimated signal, each stage's
     agreement with the golden printed, the final contour held to the
     golden bars; both kernels against their plain versions at that
     geometry (K1 bitwise) in float32 and float64;
 17. the benchmarks: bench_torch.py, tools/bench_paths_torch.py (few
     readings, batches 1 and 4) and tools/profile_stages_torch.py at
     4.644 s; every gate must pass, every JSON line parse, and no stage of
     the eager round trip may sync the host.
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
ALL_PHASES = (1, 2, 3, 4, 5, 18, 19, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17)

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
# K3: the carry's test and update at every frame (4), and at each frame an
# extension runs through, the prediction (3), one subtraction, absolute
# value and comparison per candidate, and the relative-error test (5).
K3_OPS_PER_FRAME, K3_OPS_PER_EXTENSION_FRAME, K3_OPS_PER_CANDIDATE = 4, 8, 3

F0_FLOOR, F0_CEIL = 71.0, 800.0
# path B's explicit fft_size: at 16 kHz it lowers Harvest's floor to
# 3 * 16000 / 2048 = 23.4 Hz: 216 bands (864 event rows), W 1025, S 4096
FFT_SIZE_B = 2048
# path C's utterances (seconds, cut from the golden utterance) and bucket
RAGGED_SECONDS = (0.9, 1.7, 2.4, 2.6, 3.5, 4.644)
RAGGED_QUANTUM_S = 1.0
# the VAE MLP pair of the reference's voice conversion: 39-256-256-256-12
VAE_SIZES = (39, 256, 256, 256, 12)
VAE_ACTS = ("relu", "relu", "relu", "linear")
# phase 14: the JAX package's long-audio probe (tools/check_long_audio.py, a
# 60 s glide at 22.05 kHz) and what it found there (LONGAUDIO_r05.json):
# results, not times
GLIDE_FS, GLIDE_SECONDS = 22050, 60.0
GLIDE_REFERENCE = {"frames": 12001, "voiced_frames": 11084,
                   "median_voiced_f0_hz": 155.785, "resynth_rms": 0.2774}
# the length that shows the memory bound, at 16 kHz through Harvest alone
LONG_FS, LONG_SECONDS = 16000, 600.0
# blocked against unblocked analysis of the 60 s glide in float32: vuv
# equal, and these bars (path C's row bars for f0 and the envelope).  The
# stages are bitwise from the refinement on; the FIR bank's blocks and band
# chunks give the matrix products other shapes, so the filtered signals may
# differ in their last places.
BLOCKED_F0_HZ, BLOCKED_ENV_DB, BLOCKED_AP_DB = 1e-3, 0.05, 0.1
# phase 15: more rows than one K1 launch takes (65,535 = 107 utterances'
# 608 event rows)
MANY_ROWS, MANY_ROWS_SECONDS = 110, 0.5
MAX_K1_ROWS = 65535
# phase 16: harvest.npz's utterance, 102,400 samples at 22.05 kHz (the only n
# with ceil(n / 3) = 34,134 decimated samples and 4,644 frames of 1 ms), and
# the bars tests/test_harvest.py holds each stage to: (rtol, atol, share)
HARVEST22_LENGTH = 102400
HARVEST22_STAGE_BARS = {
    "raw candidates": (2e-5, 1e-2, 0.999), "detected": (1e-6, 1e-4, 0.999),
    "overlap": (1e-6, 1e-4, 0.999), "refined": (1e-5, 1e-3, 0.995),
    "refined scores": (1e-3, 1e-2, 0.99), "clean": (1e-5, 1e-3, 0.995),
    "f0_base": (1e-5, 1e-3, 0.99), "f0_step1": (1e-5, 1e-3, 0.99),
    "f0_step2": (1e-5, 1e-3, 0.99), "f0_step3": (1e-5, 1e-3, 0.99),
    "f0_step4": (1e-5, 1e-3, 0.99), "smoothed": (1e-5, 1e-3, 0.99)}
# float32 raw band candidates on the card when the FIR bank's matrix products
# get other shapes (chunks of bands, blocks of samples): the share of entries
# live in one call only, and the share of the others within DIO_F32_RAW_RTOL;
# the filtered signals themselves to FIR_BLOCK_REL of their scale (a float32
# dot product of 461 terms in two orders)
FIR_BLOCK, FIR_BLOCK_REL = 65536, 2e-6
RAW_FLIPS_SHARE, RAW_CLOSE_SHARE = 1e-3, 0.999


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


def glide_signal(fs: int, seconds: float) -> np.ndarray:
    """The vowel-like probe of tools/check_long_audio.py: an f0 glide over
    one octave from 110 Hz with four harmonics, 200 ms of silence every 2 s,
    and seeded noise of 1e-4."""
    n = int(fs * seconds)
    t = np.arange(n) / fs
    f0 = 110.0 * 2 ** (t / max(t[-1], 1e-9))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = np.zeros(n)
    for h, a in [(1, 1.0), (2, 0.5), (3, 0.3), (4, 0.2)]:
        x += a * np.sin(h * phase)
    gate = np.floor(t / 2.0) != np.floor((t + 0.2) / 2.0)
    x *= np.where(gate, 0.0, 1.0)
    x += 1e-4 * np.random.RandomState(0).randn(n)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def harvest_blocking(n_samples: int, fs: int, dtype, n_rows: int = 1,
                     f0_floor: float = F0_FLOOR) -> dict:
    """The blocking harvest_core chooses for n_rows signals of n_samples, and
    the K1 and K2 launches that follow from it."""
    import torch
    from world_tpu_torch.f0 import harvest as H
    from world_tpu_torch.f0.events import launch_pieces

    ratio, afs = H.decimation(fs)
    y_len = H.downsample(torch.zeros((1, n_samples), device="cuda"), fs)[0].shape[1]
    n_frames = int(1000 * n_samples / fs + 1)
    bank, _ = H.band_filter_bank(H.boundary_f0_list(f0_floor, F0_CEIL), afs)
    max_half, _ = H.refinement_geometry(afs, f0_floor)
    blk = H.stage_blocking(n_rows, y_len, n_frames, bank.shape[0], bank.shape[1],
                           max_half, H.C2_SLOTS,
                           H.default_max_sections(n_samples, fs),
                           torch.empty((), dtype=dtype).element_size())
    chunks = lambda n, c: 1 if c is None else -(-n // c)   # noqa: E731
    # the bands of one K1 launch: the chunk by bytes, cut to K1's row limit
    _, k1_bands = launch_pieces(n_rows, bank.shape[0], blk["band_chunk"])
    return dict(blk, y_len=y_len, n_frames=n_frames, n_bands=bank.shape[0],
                k1_bands=k1_bands, k1_launches=chunks(bank.shape[0], k1_bands),
                k2_launches=chunks(n_frames, blk["refine_chunk"]))


def main_path_operands(x16: np.ndarray, fs: int, dtype, f0_floor: float = F0_FLOOR,
                       blocking: dict = None):
    """The operands each kernel gets on the Harvest path for utterances x16,
    (n,) or (B, n): K1's (4 bands B, n) event rows and K2's seg, phase
    (B F, W) and f0 (48, B F); 608 rows and W 341 at the default floor.
    The operands are those of one launch: the event rows of the first
    chunk of bands (``blocking``'s, harvest_core's; never more rows than a
    K1 launch takes), and the first chunk of frames."""
    import torch
    from world_tpu_torch.f0 import harvest as H

    dev = torch.device("cuda")
    x = torch.tensor(np.atleast_2d(x16), dtype=dtype, device=dev)
    tables = H.harvest_tables(fs, f0_floor, F0_CEIL, dtype, dev)
    y, afs = H.downsample(x, fs, 8000, h=tables["decimator_ir"])
    return decimated_operands(y, afs, x.shape[1], fs, tables, f0_floor, blocking)


def decimated_operands(y, afs: float, signal_length: int, fs: int, tables: dict,
                       f0_floor: float = F0_FLOOR, blocking: dict = None):
    """main_path_operands from the downsampler on: rows y (B, ny) at
    actual_fs ``afs`` of signals of ``signal_length`` samples at ``fs``."""
    import torch
    from world_tpu_torch.f0 import harvest as H
    from world_tpu_torch.f0.events import event_rows, launch_pieces

    blk = (blocking or {}).get
    dtype, dev = y.dtype, y.device
    bands = slice(0, launch_pieces(y.shape[0], tables["band_bank"].shape[0],
                                   blk("band_chunk"))[1])
    filtered = H.band_filtered(y, tables["band_bank"][bands],
                               tables["band_bias"][bands], blk("block"))
    rows = event_rows(filtered.reshape(-1, filtered.shape[-1]))
    del filtered
    n_frames = int(1000 * signal_length / fs + 1)
    tq = torch.as_tensor(np.arange(n_frames) / 1000, dtype=dtype, device=dev)
    bfl = H.boundary_f0_list(f0_floor, F0_CEIL)
    raw = H.raw_band_candidates(y, afs, tables["band_bank"],
                                tables["band_bias"], bfl, tq, f0_floor, F0_CEIL,
                                blk("band_chunk"), blk("block"))
    cands0, _ = H.detect_candidates(raw, H.default_max_candidates(f0_floor,
                                                                  F0_CEIL))
    cands1 = H.overlap_candidates(cands0)
    compact, _ = H.compact_rows(cands1.transpose(-1, -2), cands1.transpose(-1, -2) != 0,
                                H.C2_SLOTS)
    max_half, S = H.refinement_geometry(afs, f0_floor)
    frames = slice(0, blk("refine_chunk"))
    seg, phase, f0 = H.refinement_inputs(
        y, afs, tq[frames], compact.transpose(-1, -2)[..., frames], max_half)
    table = (tables["refine_cos"], tables["refine_sin"])
    return {"rows": rows, "tq": tq, "afs": afs, "stride": afs * 0.001,
            "seg": seg, "phase": phase, "f0": f0, "max_half": max_half, "S": S,
            "table": table, "f0_floor": f0_floor, "raw": raw}


def k2_args(ops):
    return (ops["seg"], ops["phase"], ops["f0"], ops["afs"], ops["max_half"],
            ops["S"], ops["f0_floor"], F0_CEIL, ops["table"])


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


def dio_event_operands(signal: np.ndarray, fs: int, n_frames: int, dtype,
                       f0_floor: float = F0_FLOOR):
    """K1's operands on the DIO path: the (4 bands, n) event rows of the band
    signals of the decimated input at 4 kHz, and the 5 ms frame grid
    (stride 20/1): 7 bands, 28 rows at the default floor, 11 bands, 44 rows
    at the 23.4 Hz floor of fft_size 2048.  A 4 kHz signal is taken as
    already decimated."""
    import torch
    from world_tpu_torch.dsp.fir import band_filtered
    from world_tpu_torch.dsp.iir import decimate_world
    from world_tpu_torch.f0.dio import dio_tables
    from world_tpu_torch.f0.events import event_rows

    dev = torch.device("cuda")
    x = torch.tensor(signal, dtype=dtype, device=dev)[None]
    tables = dio_tables(fs, f0_floor, F0_CEIL, 2, 4000, dtype, dev)
    y = x if fs == 4000 else decimate_world(x, int(fs / 4000),
                                            h=tables["dio_decimator_ir"])
    filtered = band_filtered(y, tables["dio_bank"], tables["dio_offsets"])
    tq = torch.as_tensor(np.arange(n_frames) * 5.0 / 1000, dtype=dtype, device=dev)
    return {"rows": event_rows(filtered[0]), "tq": tq, "afs": 4000.0,
            "stride": 20.0}


def check_k1(rows, fs, tq, stride, label, bitwise: bool = False):
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
    equal = torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    print(f"K1 {label}: rows {tuple(rows.shape)} Q {tq.shape[0]}: counts equal, "
          f"NaN/inf equal, max {max_ulp:.3g} ulp, max abs err {max_abs:.3g} Hz, "
          f"bitwise {equal}")
    if max_ulp > K1_ULP_BOUND:
        raise AssertionError(f"K1 {label}: {max_ulp} ulp > {K1_ULP_BOUND}")
    if bitwise and not equal:
        raise AssertionError(f"K1 {label}: not bitwise equal to its plain version")
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

    got_r, got_s = refine_cuda(*k2_args(ops))
    want_r, want_s = refine_plain(*k2_args(ops))
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


def capture_k3(fn) -> list:
    """The (base, flags, limits, cands, allowed_range, backward) of every K3
    call fn makes (DIO's two scans a call), the scans run as they are."""
    from world_tpu_torch.ops import extension_scan as K3

    real, got = K3.extension_scan, []

    def capture(base, flags, limits, cands, allowed_range, backward=False):
        got.append((base.clone(), flags.clone(), limits.clone(), cands.clone(),
                    allowed_range, backward))
        return real(base, flags, limits, cands, allowed_range, backward)

    K3.extension_scan = capture
    try:
        fn()
    finally:
        K3.extension_scan = real
    return got


def k3_operands(signal: np.ndarray, fs: int, dtype, n_rows: int = 1) -> list:
    """K3's operands on the DIO path, both scans, for ``n_rows`` copies of
    signal (the copies after the first with noise of 1e-3, as phase 5's
    batch): captured from dio_core on the card."""
    import torch
    from world_tpu_torch.f0.dio import dio_core

    rng = np.random.RandomState(0)
    xs = np.stack([signal] + [signal + 1e-3 * rng.randn(signal.shape[0])
                              for _ in range(n_rows - 1)])
    x = torch.tensor(xs, dtype=dtype, device="cuda")
    return capture_k3(lambda: dio_core(x, fs))


def k3_short_section_operands(dtype) -> list:
    """K3's operands on contours of 929 frames whose voiced sections are
    1-3 frames long (one section's extension writes the values the next
    one starts from), no voiced frame, voiced to the last frame and only
    the last frame voiced; 7 candidates a frame, a fifth of them empty."""
    import torch
    from world_tpu_torch.f0.dio import fix_step3, fix_step4

    rng = np.random.RandomState(7)
    n, C = 929, 7
    rows = np.zeros((4, n))
    for s0, length in ((10, 1), (13, 2), (17, 3), (22, 1), (40, 5), (47, 1),
                       (90, 3), (95, 2), (300, 1), (302, 1)):
        rows[0, s0:s0 + length] = 190.0 + rng.rand(length)
    rows[2, 700:] = 185.0 + rng.rand(n - 700)
    rows[3, -1] = 200.0
    cands = 180 + rng.rand(4, C, n) * 20
    cands[rng.rand(4, C, n) < 0.2] = 0.0
    f0 = torch.tensor(rows, dtype=dtype, device="cuda")
    cd = torch.tensor(cands, dtype=dtype, device="cuda")
    return capture_k3(lambda: fix_step4(fix_step3(f0, cd, 0.1), f0, cd, 0.1))


def k3_extension_frames(args, out) -> int:
    """The frames the scan of ``args`` runs an extension through, read off
    its output ``out`` (the carry's rule on the host): the work this run's
    data needs."""
    base, flags, limits, _, _, backward = args
    flags, limits = flags.cpu().numpy(), limits.cpu().numpy()
    out = out.cpu().numpy()
    n = out.shape[1]
    count = 0
    for b in range(out.shape[0]):
        active, limit = False, 0
        for p in (range(n - 1, -1, -1) if backward else range(n)):
            in_ext = active and (p >= limit - 1 if backward else p <= limit)
            count += in_ext
            active = in_ext and out[b, p] != 0
            if flags[b, p]:
                active, limit = True, int(limits[b, p])
    return count


def k3_bound(args, out):
    """K3 reads the contour, the flags, the limits and the candidates once
    and writes the contour; its operations are the carry's at every frame
    and the candidates' search at the frames this run extends through."""
    base, _, _, cands, _, _ = args
    B, n = base.shape
    C = cands.shape[1]
    isz = base.element_size()
    ext = k3_extension_frames(args, out)
    return bound(B * n * (2 * isz + 1 + 8) + cands.numel() * isz,
                 K3_OPS_PER_FRAME * B * n
                 + ext * (K3_OPS_PER_EXTENSION_FRAME + K3_OPS_PER_CANDIDATE * C))


def check_k3(args, label) -> float:
    """K3 against its plain version on one scan's operands: bitwise."""
    import torch
    from world_tpu_torch.ops.extension_scan import (extension_scan_cuda,
                                                    extension_scan_plain)

    got = extension_scan_cuda(*args)
    want = extension_scan_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    equal = torch.equal(got, want)
    base = args[0]
    print(f"K3 {label}: {'backward' if args[5] else 'forward'} scan of "
          f"{tuple(base.shape)} frames, {args[3].shape[1]} candidates, "
          f"{k3_extension_frames(args, got)} frames extended: bitwise {equal}, "
          f"max abs err {err:.3g} Hz, {int((got != base).sum())} frames written")
    if not equal:
        raise AssertionError(f"K3 {label}: not bitwise equal to its plain version")
    return err


def record_syncs(fn) -> list:
    """Every host sync fn makes, by the stack it was made from
    (``torch.cuda.set_sync_debug_mode("warn")``, restored after)."""
    import traceback
    import warnings

    import torch

    mode = torch.cuda.get_sync_debug_mode()
    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            syncs.append(" <- ".join(
                f"{Path(f.filename).name}:{f.lineno} {f.name}"
                for f in traceback.extract_stack()[-8:-1][::-1]))

    # (switching the mode warns by itself: the recorder is installed inside)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    return syncs


def no_sync_call(fn):
    """fn() under ``set_sync_debug_mode("error")``: a host sync raises."""
    import torch

    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    return out


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


def harvest22_agreements(hv, gh) -> dict:
    """Each Harvest stage of phase 16 against harvest.npz: the share within
    HARVEST22_STAGE_BARS' (rtol, atol); the candidate stages compare the
    golden's 7 blocks of n_detected rows with the first rows of the port's
    7 blocks."""
    def share(got, ref, name):
        rtol, atol, _ = HARVEST22_STAGE_BARS[name]
        return float(np.isclose(got, ref, rtol=rtol, atol=atol).mean())

    def blocks(got, ref, name):
        mc_ref, mc = ref.shape[0] // 7, got.shape[0] // 7
        return min(share(got[i * mc:i * mc + mc_ref],
                         ref[i * mc_ref:(i + 1) * mc_ref], name) for i in range(7))

    out = {"raw candidates": share(hv["_raw_candidates"],
                                   gh["raw_f0_candidates"].astype(np.float64),
                                   "raw candidates"),
           "detected": share(hv["_cands_detected"], gh["f0_candidates_detected"],
                             "detected")}
    for name, key, gkey in (("overlap", "_cands_overlap", "f0_candidates_overlap"),
                            ("refined", "_cands_refined", "f0_candidates_refined"),
                            ("refined scores", "_scores_refined", "f0_scores_refined"),
                            ("clean", "_cands_clean", "f0_candidates_clean")):
        out[name] = blocks(hv[key], gh[gkey], name)
    for name in ("f0_base", "f0_step1", "f0_step2", "f0_step3", "f0_step4"):
        out[name] = share(hv[f"_{name}"], gh[name], name)
    out["smoothed"] = share(hv["_smoothed"], gh["smoothed_f0"], "smoothed")
    return out


def classic_bars(dat, ref):
    """The float32 analysis against the float64 one: vuv agreement, voiced
    F0 error (median, RMSE and the RMSE of the best 99% of frames), LSD and
    the aperiodicity's largest dB error (classic D4C's linear amplitude as
    20 log10 of the ratio, D4C-Requiem's band dB as the difference), on
    frames voiced in both."""
    vuv, rvuv = dat["vuv"] > 0, ref["vuv"] > 0
    both = vuv & rvuv
    err = np.abs(dat["f0"][both].astype(np.float64) - ref["f0"][both])
    keep = np.sort(err)[:int(np.ceil(0.99 * err.size))]
    spec = np.asarray(dat["spectrogram"], np.float64)[:, both]
    rspec = np.asarray(ref["spectrogram"], np.float64)[:, both]
    ap = np.asarray(dat["aperiodicity"], np.float64)[:, both]
    rap = np.asarray(ref["aperiodicity"], np.float64)[:, both]
    ap_err = np.abs(ap - rap) if dat.get("is_requiem") else np.abs(
        20 * np.log10(ap / rap))
    return {"vuv_agreement": float(np.mean(vuv == rvuv)),
            "f0_median_err": float(np.median(err)),
            "f0_rmse": float(np.sqrt(np.mean(err ** 2))),
            "f0_rmse_trimmed99": float(np.sqrt(np.mean(keep ** 2))),
            "lsd": float(np.sqrt(np.mean((10 * np.log10(spec + 1e-12)
                                          - 10 * np.log10(rspec + 1e-12)) ** 2))),
            "ap_max_db": float(np.max(ap_err))}


def bars_line(b) -> str:
    return (f"vuv agreement {b['vuv_agreement']:.6f} (> 0.99), voiced F0 median "
            f"err {b['f0_median_err']:.6g} Hz (< 0.01), RMSE {b['f0_rmse']:.6g} Hz "
            f"(< 1), LSD {b['lsd']:.6g} dB (< 1), aperiodicity max err "
            f"{b['ap_max_db']:.6g} dB (< 1)")


def bars_met(b) -> bool:
    return (b["vuv_agreement"] > 0.99 and b["f0_median_err"] < 0.01
            and b["f0_rmse"] < 1.0 and b["lsd"] < 1.0 and b["ap_max_db"] < 1.0)


def swipe_bars(f0, ref):
    """tests/test_swipe.py's bars: (vuv agreement, median relative f0 error,
    share within 1%) of f0 against ref."""
    f0, ref = np.asarray(f0, np.float64), np.asarray(ref, np.float64)
    n = min(f0.shape[0], ref.shape[0])
    f0, ref = f0[:n], ref[:n]
    both = (f0 > 0) & (ref > 0)
    rel = np.abs(f0[both] - ref[both]) / ref[both]
    return (float(((f0 > 0) == (ref > 0)).mean()), float(np.median(rel)),
            float((rel < 0.01).mean()))


def mcep_lsd(A, B) -> float:
    """tests/test_api.py::test_mcep_roundtrip_lsd's distance of two
    magnitude spectrograms (frames, bins)."""
    return float(np.mean(np.sqrt(np.mean((20 * np.log10(A / B)) ** 2, axis=1))))


def vae_weights(sizes, seed: int):
    rng = np.random.RandomState(seed)
    return [((rng.randn(a, b) / np.sqrt(a)).astype(np.float32),
             (0.1 * rng.randn(b)).astype(np.float32))
            for a, b in zip(sizes[:-1], sizes[1:])]


def numpy_mlp(weights, acts, X):
    """The forward pass of features/vae.py's MLP in numpy float64."""
    h = np.asarray(X, np.float64)
    for (w, b), act in zip(weights, acts):
        h = h @ w.astype(np.float64) + b.astype(np.float64)
        if act == "relu":
            h = np.maximum(h, 0.0)
    return h


def ragged_utterances(x16: np.ndarray, fs: int):
    """Path C's six utterances: the first RAGGED_SECONDS of the golden
    utterance, each with its own seeded noise of 1e-3."""
    rng = np.random.RandomState(13)
    out = []
    for sec in RAGGED_SECONDS:
        n = min(int(round(sec * fs)), x16.shape[0])
        out.append((x16[:n] + 1e-3 * rng.randn(n)).astype(np.float32))
    return out


def expected_length(tp, fs: int) -> int:
    return len(np.arange(tp[0], tp[-1] + 1 / fs, 1.0 / fs))


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
    (CUDA events around each stage, after one warm-up run), its host syncs
    (:func:`record_syncs`, one more run) and its device kernels and copies
    (torch.profiler, one more run)."""
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

    noise = standard_normal((1, max_pulses, max_noise), None, torch.float32, dev)

    def synthesis():
        dat = dict(state["src"], f0=state["f0_d4c"],
                   spectrogram=state["env"].transpose(1, 2),
                   aperiodicity=state["ap"].transpose(1, 2))
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
        syncs = record_syncs(fn)
        out[name].update(host_syncs=len(syncs), sync_at=syncs[:5])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[name]["device_events"] = device_totals(prof)[1]
    return out


def index_add_ola(resp, starts, y_length: int):
    """The pulses' overlap-add by index_add_, as the port had it before its
    fixed-order form: atomic adds on the card, whose order changes from run
    to run.  The yardstick of phase 6's overlap-add times."""
    import torch

    W = resp.shape[1]
    idx = starts.to(torch.int64)[:, None] + torch.arange(W, device=resp.device)
    ok = (idx >= 0) & (idx < y_length)
    out = torch.zeros(y_length, dtype=resp.dtype, device=resp.device)
    return out.index_add_(0, idx[ok], resp[ok])


def captured_ola(fn):
    """The (responses (P, W), starts (P,), y_length, max_rank) of the first
    row of the first overlap-add of the pulses that an eager call of fn
    makes (Requiem synthesis)."""
    from world_tpu_torch.synth import requiem

    real, got = requiem.slot_ola, []

    def capture(resp, starts, y_length, max_rank):
        got.append((resp.reshape(-1, *resp.shape[-2:])[0],
                    starts.reshape(-1, starts.shape[-1])[0], y_length, max_rank))
        return real(resp, starts, y_length, max_rank)

    requiem.slot_ola = capture
    try:
        fn()
    finally:
        requiem.slot_ola = real
    return got[0]


def static_round_trip_and_graph(xs, fs, g, card, reset_counts,
                                path_launches) -> dict:
    """Phase 18: the round trip on static shapes, eager and as a CUDA graph,
    float32, single and batch 4, through a HarvestRequiem of its own (its
    graphs are captured here).  Returns the numbers it printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench_torch import eager_round_trip
    from world_tpu_torch import HarvestRequiem
    from world_tpu_torch.parallel.graphs import GraphCache, GraphCaptureError

    model = HarvestRequiem(fs, xs.shape[1], dtype=torch.float32, device="cuda")
    eager_call = lambda t: eager_round_trip(model, t)     # noqa: E731

    duration = xs.shape[1] / fs
    keys = ("f0", "vuv", "spectrogram", "band_aperiodicity", "y", "_overflow")
    pinned = torch.tensor(xs, dtype=torch.float32).pin_memory()
    found = {}
    for label, n_rows in (("single", 1), ("batch4", 4)):
        host = pinned[:n_rows]
        eager_call(host.to("cuda"))       # kept tables, plans and kernels built
        torch.cuda.synchronize()
        # the eager static call from the upload to the output: first every
        # sync it makes, by file and line, then under "error"
        syncs = record_syncs(lambda: eager_call(host.to("cuda", non_blocking=True)))
        if syncs:
            raise AssertionError(f"phase 18: the eager static round trip syncs "
                                 f"the host {len(syncs)} times: {syncs[:20]}")
        x, eager = no_sync_call(lambda: (lambda t: (t, eager_call(t)))(
            host.to("cuda", non_blocking=True)))
        # the module: its first call of a batch size runs eagerly, the
        # second captures the graph and replays it, later calls replay it
        before = dict(model.graphs.calls)
        took = []
        for _ in range(2):
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            took.append(time.perf_counter() - t0)
        first_s, capture_call_s = took
        ran = {k: n - before[k] for k, n in model.graphs.calls.items()}
        if ran != {"eager": 1, "captured": 1, "replayed": 1}:
            raise AssertionError(f"phase 18 {label}: the module's first two "
                                 f"calls ran {ran}")
        graph = model.graphs.graphs()[-1]
        reset_counts()
        r1 = model(x)
        r2 = model(x)
        torch.cuda.synchronize()
        counts = path_launches(f"graph_{label}")
        same_eager = [k for k in keys if not torch.equal(r1[k], eager[k])]
        same_twice = all(torch.equal(r1[k], r2[k]) for k in keys)
        bars = golden_bars({"f0": r1["f0"][0].cpu().numpy(),
                            "vuv": r1["vuv"][0].cpu().numpy(),
                            "spectrogram": r1["spectrogram"][0].T.cpu().numpy(),
                            "aperiodicity": r1["band_aperiodicity"][0].T.cpu().numpy()},
                           g)
        # the replay against the eager static call: graph, eager, eager, graph
        g1 = cuda_ms(lambda: model(x), iters=10)
        e1 = cuda_ms(lambda: eager_call(x), iters=3)
        e2 = cuda_ms(lambda: eager_call(x), iters=3)
        g2 = cuda_ms(lambda: model(x), iters=10)
        t_graph, t_eager = (g1 + g2) / 2, (e1 + e2) / 2
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
        dev_us, n_events = device_totals(prof)
        idle = (f"{1 - dev_us / 1e3 / t_graph:.3f}" if n_events else "not measured")
        audio = n_rows * duration
        print(f"phase 18 static round trip float32 {label} ({n_rows} x "
              f"{duration:.3f} s) [{card}]: eager static call from the upload to "
              f"the output: 0 host syncs (set_sync_debug_mode error); the "
              f"module's first call (eager) {first_s:.3f} s, second (warm-up, "
              f"capture, replay) {capture_call_s:.3f} s, capture "
              f"{graph.capture_s:.3f} s, pool {graph.pool_bytes / 2**20:.1f} MiB; "
              f"replay bitwise the eager call for {len(keys) - len(same_eager)} "
              f"of {len(keys)} outputs {same_eager or ''}, two replays bitwise "
              f"{same_twice}; launches per replay K1 {counts['event_engine'] / 2:g}"
              f", K2 {counts['refine_dft'] / 2:g}; row 0 against the golden: vuv "
              f"agreement {bars[0]:.6f}, voiced F0 RMSE {bars[1]:.6g} Hz, LSD "
              f"{bars[2]:.6g} dB, band-ap max err {bars[3]:.6g} dB; replay "
              f"{g1:.2f}/{g2:.2f} ms = {audio / (t_graph / 1e3):.1f} xRT, eager "
              f"static {e1:.2f}/{e2:.2f} ms = {audio / (t_eager / 1e3):.1f} xRT, "
              f"ratio {t_eager / t_graph:.2f}; one replay under torch.profiler: "
              f"{n_events} device events, {dev_us / 1e3:.3f} ms device time, idle "
              f"share {idle} of the unprofiled replay")
        if label == "single":
            single_y = r1["y"]
        found[label] = {"capture_s": graph.capture_s, "first_call_s": first_s,
                        "capture_call_s": capture_call_s,
                        "pool_bytes": graph.pool_bytes, "replay_ms": [g1, g2],
                        "eager_ms": [e1, e2], "device_events": n_events,
                        "device_ms": dev_us / 1e3}
        if same_eager or not same_twice:
            raise AssertionError(f"phase 18 {label}: the graph is not bitwise the "
                                 f"eager static call ({same_eager}) or itself")
        if counts != {"event_engine": 2, "refine_dft": 2, "extension_scan": 0}:
            raise AssertionError(f"phase 18 {label}: K1 and K2 must launch once "
                                 f"per replay, K3 never: {counts} in two replays")
        if not (bars[0] > 0.99 and bars[1] < 1.0 and bars[2] < 1.0 and bars[3] < 1.0):
            raise AssertionError(f"phase 18 {label}: golden bars not met: {bars}")
        if not all(torch.isfinite(r1["y"][b]).all() for b in range(n_rows)):
            raise AssertionError(f"phase 18 {label}: non-finite waveform")
    # no fallback: a function that reads the device from the host cannot be
    # captured, and the capture raises with its shapes
    x = pinned[:1].to("cuda")
    try:
        GraphCache().capture("sync", lambda t: {"y": t * float(t.abs().sum())},
                             (x,), "cuda")
    except GraphCaptureError as e:
        print(f"phase 18 a capture of a function that syncs raises, as it must: "
              f"{str(e)[:300]}")
    else:
        raise AssertionError("phase 18: capturing a syncing function did not raise")
    # the card, its random generator and the round trip are still usable
    # after the failed capture
    draw = torch.rand(4, device="cuda")
    if not torch.equal(model(x)["y"], single_y) or not torch.isfinite(draw).all():
        raise AssertionError("phase 18: the round trip changed after the failed "
                             "capture")
    print("phase 18 static round trip and graph: ok")
    return found


CLASSIC_KEYS = ("f0", "vuv", "temporal_positions", "spectrogram", "aperiodicity",
                "y", "_overflow")


def classic_graph_run(model, x, noise, label, card, reset_counts, path_launches,
                      audio_s: float, eager_iters: int = 3, graph_iters: int = 10):
    """One DioClassic signature from the upload to the output: the eager
    static call's syncs (recorded, then under "error"), the module's first
    call (eager) and second (capture), two replays counted and held bitwise
    against the eager call and each other, then replay and eager call timed
    graph, eager, eager, graph, and one replay's device events.  Returns
    (the first replay, the eager call, the numbers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench_torch import eager_classic_round_trip

    eager_call = lambda t: eager_classic_round_trip(model, t, noise)   # noqa: E731
    host = x.cpu().pin_memory()
    eager_call(host.to("cuda"))       # kept tables, plans and kernels built
    torch.cuda.synchronize()
    syncs = record_syncs(lambda: eager_call(host.to("cuda", non_blocking=True)))
    if syncs:
        raise AssertionError(f"phase 19 {label}: the eager static classic round "
                             f"trip syncs the host {len(syncs)} times: {syncs[:20]}")
    x, eager = no_sync_call(lambda: (lambda t: (t, eager_call(t)))(
        host.to("cuda", non_blocking=True)))
    before = dict(model.graphs.calls)
    took = []
    for _ in range(2):
        t0 = time.perf_counter()
        model(x, noise=noise)
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t0)
    ran = {k: n - before[k] for k, n in model.graphs.calls.items()}
    if ran != {"eager": 1, "captured": 1, "replayed": 1}:
        raise AssertionError(f"phase 19 {label}: the module's first two calls ran "
                             f"{ran}")
    graph = model.graphs.graphs()[-1]
    reset_counts()
    r1 = model(x, noise=noise)
    r2 = model(x, noise=noise)
    torch.cuda.synchronize()
    counts = path_launches(f"classic_graph_{label}")
    differ = [k for k in CLASSIC_KEYS if not torch.equal(r1[k], eager[k])]
    twice = all(torch.equal(r1[k], r2[k]) for k in CLASSIC_KEYS)
    g1 = cuda_ms(lambda: model(x, noise=noise), iters=graph_iters)
    e1 = cuda_ms(lambda: eager_call(x), iters=eager_iters)
    e2 = cuda_ms(lambda: eager_call(x), iters=eager_iters)
    g2 = cuda_ms(lambda: model(x, noise=noise), iters=graph_iters)
    t_graph, t_eager = (g1 + g2) / 2, (e1 + e2) / 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(x, noise=noise)
        torch.cuda.synchronize()
    dev_us, n_events = device_totals(prof)
    idle = f"{1 - dev_us / 1e3 / t_graph:.3f}" if n_events else "not measured"
    print(f"phase 19 classic round trip float32 {label} ({x.shape[0]} x "
          f"{x.shape[1]} samples) [{card}]: eager static call from the upload to "
          f"the output: 0 host syncs (set_sync_debug_mode error); the module's "
          f"first call (eager) {took[0]:.3f} s, second (warm-up, capture, replay) "
          f"{took[1]:.3f} s, capture {graph.capture_s:.3f} s, pool "
          f"{graph.pool_bytes / 2**20:.1f} MiB; replay bitwise the eager call for "
          f"{len(CLASSIC_KEYS) - len(differ)} of {len(CLASSIC_KEYS)} outputs "
          f"{differ or ''}, two replays bitwise {twice}; launches per replay K1 "
          f"{counts['event_engine'] / 2:g}, K2 {counts['refine_dft'] / 2:g}, K3 "
          f"{counts['extension_scan'] / 2:g}; replay {g1:.2f}/{g2:.2f} ms = "
          f"{audio_s / (t_graph / 1e3):.1f} xRT, eager static {e1:.2f}/{e2:.2f} ms "
          f"= {audio_s / (t_eager / 1e3):.1f} xRT, ratio {t_eager / t_graph:.2f}; "
          f"one replay under torch.profiler: {n_events} device events, "
          f"{dev_us / 1e3:.3f} ms device time, idle share {idle} of the "
          f"unprofiled replay; overflow flags {r1['_overflow'].tolist()}")
    if differ or not twice:
        raise AssertionError(f"phase 19 {label}: the graph is not bitwise the eager "
                             f"static call ({differ}) or itself")
    if counts != {"event_engine": 2, "refine_dft": 0, "extension_scan": 4}:
        raise AssertionError(f"phase 19 {label}: K1 must launch once per replay, "
                             f"K3 twice, K2 never: {counts} in two replays")
    if not (torch.isfinite(r1["y"]).all() and bool((r1["y"].abs().amax(-1) > 0).all())
            and not r1["_overflow"].any()):
        raise AssertionError(f"phase 19 {label}: non-finite, silent or "
                             f"overflowing output")
    return r1, eager, {"first_call_s": took[0], "capture_call_s": took[1],
                       "capture_s": graph.capture_s, "pool_bytes": graph.pool_bytes,
                       "replay_ms": [g1, g2], "eager_ms": [e1, e2],
                       "device_events": n_events, "device_ms": dev_us / 1e3}


def static_classic_and_graph(xs, fs, card, reset_counts, path_launches) -> dict:
    """Phase 19: the classic round trip on static shapes, eager and as a
    CUDA graph, float32, through DioClassic modules of its own: x16 single
    and batch 4, then the 60 s glide at 22.05 kHz with the classic
    synthesis' peak memory beside the budget.  Returns the numbers it
    printed."""
    import gc

    import torch

    from world_tpu_torch import DioClassic
    from world_tpu_torch._backend import STAGE_BYTES_BUDGET
    from world_tpu_torch.parallel.batch import (classic_caps, encode_classic_one,
                                                synthesize_classic)
    from world_tpu_torch.synth.classic import (PULSE_ITEMS_PER_SAMPLE,
                                               pulse_blocking, standard_normal)
    from world_tpu_torch.spectral.cheaptrick import default_fft_size

    f32 = torch.float32
    found = {}
    n = xs.shape[1]
    model = DioClassic(fs, n, dtype=f32, device="cuda")
    _, mp, mn = classic_caps(n, fs, 5)
    noise = standard_normal((4, mp, mn), torch.Generator(device="cuda").manual_seed(1),
                            f32, "cuda")
    x64 = torch.tensor(xs[:1], dtype=torch.float64, device="cuda")
    ref = encode_classic_one(x64, fs, 5)
    ref = {k: (v if k == "temporal_positions" else v[0]).cpu().numpy()
           for k, v in ref.items()}
    for label, n_rows in (("single", 1), ("batch4", 4)):
        x = torch.tensor(xs[:n_rows], dtype=f32)
        r1, _, found[label] = classic_graph_run(
            model, x, noise[:n_rows], label, card, reset_counts, path_launches,
            n_rows * n / fs)
        b = classic_bars({k: (v if k == "temporal_positions" else v[0]).cpu().numpy()
                          for k, v in r1.items()}, ref)
        found[label]["bars"] = b
        print(f"phase 19 {label} row 0 of the replay vs the port's float64 on the "
              f"card: {bars_line(b)}")
        if not bars_met(b):
            raise AssertionError(f"phase 19 {label}: phase 8's bars not met")
    del model, noise

    # the 60 s glide: sync-free, bitwise as a replay, and the synthesis'
    # blocks inside the budget
    x60 = glide_signal(GLIDE_FS, GLIDE_SECONDS)
    n60 = x60.shape[0]
    model = DioClassic(GLIDE_FS, n60, dtype=f32, device="cuda")
    _, mp, mn = classic_caps(n60, GLIDE_FS, 5)
    noise = standard_normal((1, mp, mn), torch.Generator(device="cuda").manual_seed(2),
                            f32, "cuda")
    x = torch.tensor(x60[None], dtype=f32)
    r1, eager, found["60s"] = classic_graph_run(
        model, x, noise, "60s", card, reset_counts, path_launches, GLIDE_SECONDS,
        eager_iters=1, graph_iters=2)
    f0 = r1["f0"][0].cpu().numpy()
    voiced = f0[f0 > 0]
    if not (voiced.size > 0.5 * f0.size and 100.0 < np.median(voiced) < 240.0):
        raise AssertionError("phase 19 60s: the glide's contour")
    del r1, eager
    xg = x.to("cuda")
    tables = dict(model.named_buffers())
    dat = encode_classic_one(xg, GLIDE_FS, 5, tables)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    synthesize_classic(dat, noise, GLIDE_FS, n60, 5)
    torch.cuda.synchronize()
    synth_peak = torch.cuda.max_memory_allocated() - base
    fft = default_fft_size(GLIDE_FS)
    block = pulse_blocking(1, mp, fft, 4) or mp
    reckoned = block * PULSE_ITEMS_PER_SAMPLE * fft * 4
    del dat
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    encode_classic_one(xg, GLIDE_FS, 5, tables)
    torch.cuda.synchronize()
    encode_peak = torch.cuda.max_memory_allocated() - base
    found["60s"].update(synthesis_peak_bytes=synth_peak, block=block,
                        reckoned_block_bytes=reckoned, encode_peak_bytes=encode_peak)
    print(f"phase 19 60s peak device memory float32 [{card}]: classic synthesis "
          f"{synth_peak / 2**20:.1f} MiB above what was resident, {mp} pulse slots "
          f"in blocks of {block} (the rule reckons {reckoned / 2**20:.1f} MiB a "
          f"block; budget {STAGE_BYTES_BUDGET / 2**20:.0f} MiB); the encode "
          f"{encode_peak / 2**20:.1f} MiB (printed, not judged)")
    if synth_peak > STAGE_BYTES_BUDGET:
        raise AssertionError("phase 19: the classic synthesis at 60 s holds more "
                             "than the budget")
    model.graphs.clear()
    del model, noise, xg, tables
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 19 static classic round trip and graph: ok")
    return found


def graph_memory(xm_t, fs, card):
    """Phase 15's memory: what batch_encode_decode's graphs still hold after
    the call of many rows, beside the eager call's peak on the same rows,
    then the pools freed by ``BATCH_GRAPHS.clear()``."""
    import gc

    import torch

    from world_tpu_torch.parallel.batch import (BATCH_GRAPHS, HARVEST_TABLE_KEYS,
                                                default_batch_max_pulses,
                                                encode_decode_one,
                                                harvest_requiem_tables)
    from world_tpu_torch.parallel.graphs import GRAPH_POOL_BUDGET
    from world_tpu_torch.f0.harvest import default_max_candidates, default_max_sections

    torch.cuda.synchronize()
    held = BATCH_GRAPHS.pool_bytes()
    n_graphs = len(BATCH_GRAPHS.graphs())
    pool = BATCH_GRAPHS.graphs()[-1].pool_bytes
    t = harvest_requiem_tables(fs, 0, torch.float32, "cuda")
    n = xm_t.shape[1]
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = encode_decode_one(xm_t, t["pulse_seed"], t["noise_seed"], fs, 5,
                            default_batch_max_pulses(n, fs),
                            default_max_candidates(F0_FLOOR, F0_CEIL),
                            default_max_sections(n, fs),
                            tables={k: t[k] for k in HARVEST_TABLE_KEYS})
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - base
    del out
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    BATCH_GRAPHS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    freed = reserved - torch.cuda.memory_reserved()
    mib = lambda b: f"{b / 2**20:,.1f} MiB"      # noqa: E731
    print(f"phase 15 memory [{card}]: after the call of {xm_t.shape[0]} rows "
          f"batch_encode_decode's {n_graphs} graphs hold {mib(held)} (budget "
          f"{mib(GRAPH_POOL_BUDGET)}; this call's graph {mib(pool)}); the eager "
          f"call's peak on the same rows {mib(eager_peak)} (pool / peak "
          f"{pool / eager_peak:.3f}, < 2); BATCH_GRAPHS.clear() and "
          f"torch.cuda.empty_cache() gave back {mib(freed)} to the card")
    # a graph's pool holds its call's peak in whole allocator segments
    if not (held <= max(GRAPH_POOL_BUDGET, pool) and pool <= 2 * eager_peak
            and freed >= 0.9 * held and not BATCH_GRAPHS.graphs()):
        raise AssertionError("phase 15: the graphs' memory is not bounded or "
                             "not given back")


def main(phases=ALL_PHASES) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from world_tpu_torch import DioClassic, HarvestRequiem, World
    from world_tpu_torch.parallel.batch import classic_caps, floor_of_fft_size
    from world_tpu_torch.synth.classic import standard_normal
    from world_tpu_torch._backend import kernel_library, kernel_resources
    from world_tpu_torch.f0.events import batched_interval_interp
    from world_tpu_torch.ops import edge_interp, extension_scan, refine_dft

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
        # no Pallas kernel: the JAX package's FixStep3 scan (:179; FixStep4's
        # is :206)
        "extension_scan": {"name": "extension_scan", "route": "cuda",
                           "source": "world_tpu_torch/csrc/extension_scan.cu",
                           "replaces": "world_tpu/f0/dio.py:179",
                           "library_ms": None, "launches_by_path": {},
                           "geometries": {}},
    }

    def path_launches(path: str):
        """Read and record the launch counts of the path just driven."""
        counts = {"event_engine": edge_interp.counter.launches,
                  "refine_dft": refine_dft.counter.launches,
                  "extension_scan": extension_scan.counter.launches}
        for name, n in counts.items():
            kernels[name]["launches_by_path"][path] = n
            kernels[name]["launches"] = sum(
                kernels[name]["launches_by_path"].values())
        return counts

    def reset_counts():
        edge_interp.counter.launches = 0
        refine_dft.counter.launches = 0
        extension_scan.counter.launches = 0

    def hold_kernels(ops, label, k1_geo, k2_geo=None):
        """Both kernels against their plain versions on one launch's
        operands (K1 bitwise), recorded under ``geometries`` when the
        operands are float32."""
        record = ops["rows"].dtype == torch.float32
        e1 = check_k1(ops["rows"], ops["afs"], ops["tq"], ops["stride"], label,
                      bitwise=True)
        if record:
            kernels["event_engine"]["geometries"][k1_geo] = {
                "rows": list(ops["rows"].shape), "Q": ops["tq"].shape[0],
                "max_abs_err": e1}
        if k2_geo is not None:
            e2 = check_k2(ops, label)
            if record:
                kernels["refine_dft"]["geometries"][k2_geo] = {
                    "CFWS": [ops["f0"].shape[0], *ops["seg"].shape, ops["S"]],
                    "max_abs_err": e2}

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
    k3_ops = {}
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
        # K3 bitwise against its plain version: both scans of DIO on x16
        # (929 frames), a batch of 4 and the 60 s glide (12,001 frames), and
        # on short sections
        x60_k3 = glide_signal(GLIDE_FS, GLIDE_SECONDS)
        for dt in (torch.float32, torch.float64):
            for geo, ops in (("dio_x16", k3_operands(x16, fs, dt)),
                             ("dio_x16_batch4", k3_operands(x16, fs, dt, 4)),
                             ("dio_60s", k3_operands(x60_k3, GLIDE_FS, dt)),
                             ("short_sections", k3_short_section_operands(dt))):
                errs = [check_k3(args, f"{str(dt)[6:]} {geo}") for args in ops]
                if dt == torch.float32:
                    k3_ops[geo] = ops
                    kernels["extension_scan"]["geometries"][geo] = {
                        "rows_frames_candidates": [*ops[0][3].shape[:1],
                                                   ops[0][3].shape[2],
                                                   ops[0][3].shape[1]],
                        "max_abs_err": max(errs)}
        kernels["extension_scan"]["max_abs_err"] = \
            kernels["extension_scan"]["geometries"]["dio_x16"]["max_abs_err"]
        del x60_k3
        print("phase 2 K3: ok")
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
    if any(p in phases for p in (5, 6, 10, 15, 18, 19)):
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

    if 18 in phases:
        static_round_trip_and_graph(xs, fs, g, card, reset_counts,
                                    path_launches)
    if 19 in phases:
        static_classic_and_graph(xs, fs, card, reset_counts, path_launches)

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
        if counts != {"event_engine": 1, "refine_dft": 0, "extension_scan": 2}:
            raise AssertionError(f"the classic path must launch K1 once, K3 twice "
                                 f"and K2 never: {counts}")
        b = classic_bars(dat, ref)
        y = np.asarray(out["out"])
        print(f"phase 8 classic float32 on x16 vs the port's float64 on the card: "
              f"vuv agreement {b['vuv_agreement']:.6f} (> 0.99), voiced F0 median "
              f"err {b['f0_median_err']:.6g} Hz (< 0.01), RMSE {b['f0_rmse']:.6g} Hz "
              f"(< 1), trimmed-99% RMSE {b['f0_rmse_trimmed99']:.6g} Hz, LSD "
              f"{b['lsd']:.6g} dB (< 1), aperiodicity max err {b['ap_max_db']:.6g} "
              f"dB (< 1), y {y.shape} max|y| {np.abs(y).max():.4g}; launches K1 "
              f"{counts['event_engine']}, K2 {counts['refine_dft']}, K3 "
              f"{counts['extension_scan']}")
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
              f"{counts['event_engine']}, K2 {counts['refine_dft']}, K3 "
              f"{counts['extension_scan']}")
        if flips or off:
            raise AssertionError("phase 10: batched row 0 changed decisions")
        if counts != {"event_engine": 1, "refine_dft": 0, "extension_scan": 2}:
            raise AssertionError(f"phase 10: the classic batch must launch K1 once, "
                                 f"K3 twice and K2 never: {counts}")
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

    if 11 in phases:
        from world_tpu_torch.f0.swipe import swipe

        ref = swipe(fs, x16, plim=(F0_FLOOR, F0_CEIL), sTHR=0.3,
                    dtype=torch.float64, device="cuda")
        got = swipe(fs, x16, plim=(F0_FLOOR, F0_CEIL), sTHR=0.3,
                    dtype=torch.float32, device="cuda")
        agree, med, within = swipe_bars(got["f0"].cpu().numpy(),
                                        ref["f0"].cpu().numpy())
        gs = np.load(GOLDEN_DIR / "swipe.npz")
        s_agree, s_med, s_within = swipe_bars(ref["f0"].cpu().numpy(), gs["f0"])
        wa = World(device="cuda", dtype=torch.float32)
        reset_counts()
        dat = wa.encode(fs, x16, f0_method="swipe")
        out = wa.decode(dat)
        torch.cuda.synchronize()
        counts = path_launches("A_swipe_classic")
        y = np.asarray(out["out"])
        print(f"phase 11 path A, SWIPE' float32 on x16 vs the port's float64 on "
              f"the card: vuv agreement {agree:.6f} (> 0.97), median relative f0 "
              f"err {med:.6g} (< 1e-4), share within 1% {within:.6f} (> 0.97); "
              f"voiced share {float((got['f0'] > 0).float().mean()):.4f}; "
              f"encode(f0_method='swipe') -> decode: f0 {dat['f0'].shape}, y "
              f"{y.shape} max|y| {np.abs(y).max():.4g}; launches K1 "
              f"{counts['event_engine']}, K2 {counts['refine_dft']}")
        print(f"phase 11 sanity, not judged: float64 SWIPE' on x16 against "
              f"swipe.npz (the same utterance at 22.05 kHz): vuv agreement "
              f"{s_agree:.4f}, median relative err {s_med:.3g}, within 1% "
              f"{s_within:.4f}")
        if not (agree > 0.97 and med < 1e-4 and within > 0.97):
            raise AssertionError("phase 11: SWIPE' bars not met")
        if any(counts.values()):
            raise AssertionError(f"phase 11: SWIPE' must launch no kernel: {counts}")
        if not (np.all(np.isfinite(y)) and np.abs(y).max() > 0
                and y.shape == (expected_length(dat["temporal_positions"], fs),)
                and np.array_equal(dat["vuv"], (got["f0"] > 0).float().cpu().numpy())):
            raise AssertionError("phase 11: SWIPE' round trip not finite, all "
                                 "zero, of another length or not the SWIPE' contour")

    opsB32 = dioB32 = None
    if 12 in phases or 6 in phases:
        floorB = floor_of_fft_size(fs, FFT_SIZE_B)
        opsB32 = main_path_operands(x16, fs, torch.float32, floorB)
        dioB32 = dio_event_operands(x16, fs, n_frames_5ms, torch.float32, floorB)
    if 12 in phases:
        import copy
        import tempfile

        from world_tpu_torch.features.vae import MLP

        wb = World(device="cuda", dtype=torch.float32)
        wb64 = World(device="cuda", dtype=torch.float64)
        # the float64 references first: they are not part of the counted run
        refs = {m: wb64.encode(fs, x16, f0_method=m, fft_size=FFT_SIZE_B,
                               is_requiem=(m == "harvest"))
                for m in ("harvest", "dio")}
        enc_w, dec_w = vae_weights(VAE_SIZES, 21), vae_weights(VAE_SIZES[::-1], 22)
        encoder = MLP(enc_w, VAE_ACTS, device="cuda")
        decoder = MLP(dec_w, VAE_ACTS, device="cuda")

        reset_counts()
        dat_h = wb.encode(fs, x16, f0_method="harvest", is_requiem=True)
        dat_d = wb.encode(fs, x16, f0_method="dio", is_requiem=False)
        spec = np.sqrt(dat_h["spectrogram"].T)               # magnitude
        mcep = wb.encode_mcep(spec, n0=40, fs=fs, highhz=fs / 2)
        rec = wb.decode_mcep(mcep, (spec.shape[1] - 1) * 2)
        lfbank = wb.encode_lfbank(spec, fs=fs)
        mc14 = wb.encode_mcep(spec, n0=14, fs=fs, highhz=fs / 2)
        mean = mc14[:, 1:].mean(axis=0)
        Zc, Yc = wb.encode_vae(mc14[:, 1:], mc14[:, 0], encoder, decoder, 1, 14,
                               64, mean)
        warped = {}
        for name, dat in (("Requiem", dat_h), ("classic", dat_d)):
            d = copy.deepcopy(dat)
            d = wb.scale_pitch(d, 1.5)
            wb.modify_duration(d, [1.0, 3.0], [1.4, -1])
            d = wb.warp_spectrum(d, 1.1)
            warped[name] = wb.decode(d)
        got_fft = {m: wb.encode(fs, x16, f0_method=m, fft_size=FFT_SIZE_B,
                                is_requiem=(m == "harvest"))
                   for m in ("harvest", "dio")}
        src_g = {"f0": g["f0"], "vuv": g["vuv"],
                 "temporal_positions": g["temporal_positions"]}
        gvn = wb.encode_w_gvn_f0(fs, x16, src_g, is_requiem=True)
        with tempfile.TemporaryDirectory() as tmp:
            World.save(gvn, Path(tmp) / "analysis.npz")
            back = World.load(Path(tmp) / "analysis.npz")
        torch.cuda.synchronize()
        counts = path_launches("B_conversion_prosody")
        # encode x 2 by Harvest (K1 + K2 each), x 2 by DIO (K1 each)
        if counts != {"event_engine": 4, "refine_dft": 2, "extension_scan": 4}:
            raise AssertionError(f"phase 12: path B's launches: {counts}")

        lsd = mcep_lsd(spec, rec)
        print(f"phase 12 path B codecs float32: MCEP-40 round trip of the x16 "
              f"envelope {spec.shape}: LSD {lsd:.4f} dB (< 8); lfbank "
              f"{lfbank.shape} finite {bool(np.isfinite(lfbank).all())}")
        if not (lsd < 8.0 and np.isfinite(lfbank).all()
                and lfbank.shape == (spec.shape[0], 32)):
            raise AssertionError("phase 12: codec bars not met")
        Xc = mc14[:, 1:] - mean
        ctx = np.concatenate([np.vstack([Xc[:1], Xc[:-1]]), Xc,
                              np.vstack([Xc[1:], Xc[-1:]])], axis=1)
        want_z = numpy_mlp(enc_w, VAE_ACTS, ctx)
        want_y = numpy_mlp(dec_w, VAE_ACTS, want_z)[:, 13:26] + mean
        err_z = float(np.max(np.abs(Zc - want_z)) / np.abs(want_z).max())
        err_y = float(np.max(np.abs(Yc[:, 1:] - want_y)) / np.abs(want_y).max())
        print(f"phase 12 path B VAE {'-'.join(map(str, VAE_SIZES))} pair through "
              f"encode_vae(window=1, n0=14) against a numpy forward pass: latents "
              f"{Zc.shape} max err {err_z:.3g} of scale, cepstra {Yc.shape} "
              f"{err_y:.3g} (< 1e-4)")
        if not (err_z < 1e-4 and err_y < 1e-4 and np.array_equal(Yc[:, 0], mc14[:, 0])):
            raise AssertionError("phase 12: the VAE round trip disagrees")
        for name, d in warped.items():
            y, tp = d["out"], d["temporal_positions"]
            print(f"phase 12 path B {name} decode after scale_pitch(1.5), "
                  f"modify_duration([1, 3] -> [1.4, 3]) and warp_spectrum(1.1): "
                  f"grid uniform {bool(np.allclose(np.diff(tp), tp[1] - tp[0]))}, y "
                  f"{y.shape} max|y| {np.abs(y).max():.4g}")
            if not (np.all(np.isfinite(y)) and np.abs(y).max() > 0
                    and y.shape == (expected_length(tp, fs),)
                    and not np.allclose(np.diff(tp), tp[1] - tp[0])):
                raise AssertionError(f"phase 12: {name} decode on the warped grid")
        for m in ("harvest", "dio"):
            b = classic_bars(got_fft[m], refs[m])
            print(f"phase 12 path B encode(f0_method='{m}', fft_size={FFT_SIZE_B}) "
                  f"float32 vs float64 on the card: spectrogram "
                  f"{got_fft[m]['spectrogram'].shape}, voiced share "
                  f"{float(np.mean(refs[m]['vuv'])):.4f}: {bars_line(b)}")
            if not bars_met(b):
                raise AssertionError(f"phase 12: fft_size bars not met by {m}")
        agree, rmse, lsd_g, ap_err = golden_bars(gvn, g)
        same = set(back) == set(gvn) and all(
            np.array_equal(back[k], v) if isinstance(v, np.ndarray) else back[k] == v
            for k, v in gvn.items())
        print(f"phase 12 path B encode_w_gvn_f0 on the golden contour: LSD "
              f"{lsd_g:.6g} dB (< 1), band-ap max err {ap_err:.6g} dB (< 1), f0 "
              f"RMSE {rmse:.3g} Hz; save -> load equal {same}")
        if not (lsd_g < 1.0 and ap_err < 1.0 and rmse < 1e-3 and same):
            raise AssertionError("phase 12: encode_w_gvn_f0 or save/load")
        opsB64 = main_path_operands(x16, fs, torch.float64, floorB)
        dioB64 = dio_event_operands(x16, fs, n_frames_5ms, torch.float64, floorB)
        for dt, ops, d in (("float32", opsB32, dioB32), ("float64", opsB64, dioB64)):
            e1 = check_k1(ops["rows"], ops["afs"], ops["tq"], ops["stride"],
                          f"{dt} Harvest fft_size={FFT_SIZE_B} geometry",
                          bitwise=True)
            e2 = check_k2(ops, f"{dt} Harvest fft_size={FFT_SIZE_B} geometry")
            e3 = check_k1(d["rows"], d["afs"], d["tq"], d["stride"],
                          f"{dt} DIO fft_size={FFT_SIZE_B} geometry (stride 20/1)",
                          bitwise=True)
            if dt == "float32":
                kernels["event_engine"]["geometries"]["dio_fft2048"] = {
                    "rows": list(d["rows"].shape), "Q": d["tq"].shape[0],
                    "max_abs_err": e3}
                kernels["event_engine"]["geometries"]["harvest_fft2048"] = {
                    "rows": list(ops["rows"].shape), "Q": ops["tq"].shape[0],
                    "max_abs_err": e1}
                kernels["refine_dft"]["geometries"]["harvest_fft2048"] = {
                    "CFWS": [ops["f0"].shape[0], *ops["seg"].shape, ops["S"]],
                    "max_abs_err": e2}
        del opsB64, dioB64
        print("phase 12 path B: ok")

    utts = opsC32 = None
    if 13 in phases or 6 in phases:
        from world_tpu_torch import batch_encode_decode, batch_encode_decode_ragged
        from world_tpu_torch.parallel.batch import bucket_lengths

        utts = ragged_utterances(x16, fs)
        buckets = bucket_lengths([u.shape[0] for u in utts], fs, RAGGED_QUANTUM_S)
    if 13 in phases:
        # the first call runs each bucket eagerly, the second captures each
        # bucket's graph, and the counted third replays them
        took = []
        for _ in range(3):
            if len(took) == 2:
                reset_counts()
            t0 = time.perf_counter()
            rows = batch_encode_decode_ragged(utts, fs,
                                              bucket_quantum_s=RAGGED_QUANTUM_S)
            torch.cuda.synchronize()
            took.append(time.perf_counter() - t0)
        counts = path_launches("C_ragged")
        audio_c = sum(u.shape[0] for u in utts) / fs
        print(f"phase 13 path C ragged batch float32: lengths "
              f"{[u.shape[0] for u in utts]} in buckets "
              f"{ {L: len(ix) for L, ix in buckets.items()} } [{card}]; first "
              f"call (eager) {took[0]:.3f} s = {audio_c / took[0]:.1f} xRT, second "
              f"(capturing each bucket's graph) {took[1]:.3f} s = "
              f"{audio_c / took[1]:.1f} xRT, third (replays) {took[2]:.3f} s = "
              f"{audio_c / took[2]:.1f} xRT; launches of the third K1 "
              f"{counts['event_engine']}, K2 {counts['refine_dft']}")
        if len(buckets) != 5 or counts != {"event_engine": 5, "refine_dft": 5,
                                           "extension_scan": 0}:
            raise AssertionError(f"phase 13: one K1 and one K2 launch per bucket: "
                                 f"{counts} for {len(buckets)} buckets")
        for i, u in enumerate(utts):
            single = batch_encode_decode_ragged(
                [u], fs, bucket_quantum_s=RAGGED_QUANTUM_S)[0]
            row = rows[i]
            nf = int(1000 * u.shape[0] / fs / 5 + 1)
            flips = int((row["vuv"] != single["vuv"]).sum())
            df0 = float(np.abs(row["f0"] - single["f0"]).max())
            rel = float(np.linalg.norm(row["y"] - single["y"])
                        / max(np.linalg.norm(single["y"]), 1e-30))
            ddb = float(np.abs(10 * np.log10(row["spectrogram"] + 1e-12)
                               - 10 * np.log10(single["spectrogram"] + 1e-12)).max())
            print(f"phase 13 row {i} ({u.shape[0] / fs:.3f} s, {nf} frames) vs its "
                  f"one-utterance call: vuv flips {flips} (0), max |df0| {df0:.3g} "
                  f"Hz (< 1e-3), waveform rel L2 {rel:.3g} (< 1e-2), envelope drift "
                  f"{ddb:.3g} dB (< 0.05); voiced share "
                  f"{float(row['vuv'].mean()):.3f}")
            if not (row["f0"].shape == (nf,) and flips == 0 and df0 < 1e-3
                    and rel < 1e-2 and ddb < 0.05
                    and np.all(np.isfinite(row["y"])) and np.abs(row["y"]).max() > 0):
                raise AssertionError(f"phase 13: row {i} differs from its single run")
        for L, idxs in buckets.items():
            xb = np.zeros((len(idxs), L), np.float32)
            for r, i in enumerate(idxs):
                xb[r, :utts[i].shape[0]] = utts[i]
            ops = main_path_operands(xb, fs, torch.float32)
            label = f"float32 bucket {L / fs:g} s x {len(idxs)}"
            e1 = check_k1(ops["rows"], ops["afs"], ops["tq"], ops["stride"], label,
                          bitwise=True)
            e2 = check_k2(ops, label)
            if L == min(buckets):
                opsC32 = ops
                kernels["event_engine"]["geometries"]["bucket_1s"] = {
                    "rows": list(ops["rows"].shape), "Q": ops["tq"].shape[0],
                    "max_abs_err": e1}
                kernels["refine_dft"]["geometries"]["bucket_1s"] = {
                    "CFWS": [ops["f0"].shape[0], *ops["seg"].shape, ops["S"]],
                    "max_abs_err": e2}
            # the zero tail analyses as unvoiced
            out = batch_encode_decode(xb, fs)
            for r, i in enumerate(idxs):
                # past the band filters' ringing (100 ms)
                tail = int(1000 * utts[i].shape[0] / fs / 5 + 1) + 20
                if bool(out["vuv"][r, tail:].any()):
                    raise AssertionError(f"phase 13: utterance {i}'s zero tail is "
                                         f"voiced")
        print("phase 13 path C: ok (zero tails unvoiced in every bucket)")

    opsL32 = blkL32 = x60 = dioL32 = opsX32 = opsM32 = opsS32 = None
    if 14 in phases or 6 in phases:
        x60 = glide_signal(GLIDE_FS, GLIDE_SECONDS)
        dioL32 = dio_event_operands(
            x60, GLIDE_FS, int(1000 * x60.shape[0] / GLIDE_FS / 5 + 1), torch.float32)
        blkL32 = harvest_blocking(x60.shape[0], GLIDE_FS, torch.float32)
        if blkL32["band_chunk"] is None:
            raise AssertionError("phase 14: the band stage is not blocked at 60 s")
        opsL32 = main_path_operands(x60, GLIDE_FS, torch.float32, blocking=blkL32)
    if 14 in phases:
        import gc

        from world_tpu_torch.f0 import harvest as H
        from world_tpu_torch.parallel import batch as PB

        keys = ("band_chunk", "block", "refine_chunk", "unreliable_chunk",
                "step3_chunk", "smooth_chunk")
        wl32 = World(device="cuda", dtype=torch.float32)
        wl64 = World(device="cuda", dtype=torch.float64)
        reset_counts()
        dat = wl32.encode(GLIDE_FS, x60, f0_method="harvest", is_requiem=True)
        out = wl32.decode(dat)
        torch.cuda.synchronize()
        counts = path_launches("long_audio_60s")
        f0, vuv, y = dat["f0"], dat["vuv"], np.asarray(out["out"])
        voiced = f0[f0 > 0]
        rms = float(np.sqrt(np.mean(y ** 2)))
        print(f"phase 14 blocking at {GLIDE_SECONDS:g} s float32 "
              f"({blkL32['y_len']} decimated samples, {blkL32['n_frames']} frames "
              f"of 1 ms): " + ", ".join(f"{k} {blkL32[k]}" for k in keys)
              + f"; launches K1 {counts['event_engine']} (expected "
              f"{blkL32['k1_launches']}), K2 {counts['refine_dft']} (expected "
              f"{blkL32['k2_launches']})")
        if counts != {"event_engine": blkL32["k1_launches"],
                      "refine_dft": blkL32["k2_launches"],
                      "extension_scan": 0} or counts["event_engine"] < 2:
            raise AssertionError(f"phase 14: one K1 launch per band chunk and one "
                                 f"K2 launch per frame chunk: {counts}")
        print(f"phase 14 long audio float32, {GLIDE_SECONDS:g} s glide at {GLIDE_FS} "
              f"Hz through encode(harvest, requiem) -> decode: {f0.shape[0]} frames "
              f"(JAX package on its device: {GLIDE_REFERENCE['frames']}), "
              f"{int(vuv.sum())} voiced ({GLIDE_REFERENCE['voiced_frames']}), "
              f"median voiced f0 {float(np.median(voiced)):.3f} Hz "
              f"({GLIDE_REFERENCE['median_voiced_f0_hz']}), resynthesis rms "
              f"{rms:.4f} ({GLIDE_REFERENCE['resynth_rms']}), max|y| "
              f"{np.abs(y).max():.3f}")
        if not (np.all(np.isfinite(f0)) and voiced.size > 0.5 * f0.size
                and 100.0 < np.median(voiced) < 240.0 and np.all(np.isfinite(y))
                and np.abs(y).max() <= 1.0 and rms > 0.01):
            raise AssertionError("phase 14: check_long_audio.py's asserts not met")
        # the float32 parameters through the float64 synthesis: Requiem's
        # interpolations run in the working type
        y64 = np.asarray(wl64.decode(dict(dat))["out"])
        print(f"phase 14 sanity, not judged: Requiem synthesis of the float32 "
              f"parameters in float32 against float64: waveform relative L2 "
              f"{float(np.linalg.norm(y - y64) / np.linalg.norm(y64)):.3g}")

        ref = wl64.encode(GLIDE_FS, x60, f0_method="harvest", is_requiem=True)
        b = classic_bars(dat, ref)
        both = (dat["vuv"] > 0) & (ref["vuv"] > 0)
        off = int((np.abs(dat["f0"][both] - ref["f0"][both]) > 1.0).sum())
        print(f"phase 14 long audio float32 vs float64 on the card: "
              f"{bars_line(b)}; the median is printed, not judged; {off} of "
              f"{int(both.sum())} frames voiced in both are off by > 1 Hz, RMSE of "
              f"the best 99% {b['f0_rmse_trimmed99']:.6g} Hz")
        if not (b["vuv_agreement"] > 0.99 and b["f0_rmse"] < 1.0 and b["lsd"] < 1.0
                and b["ap_max_db"] < 1.0):
            raise AssertionError("phase 14: float32 bars at 60 s not met")
        del ref, y64

        # blocked against unblocked, the same signal and type
        x60_t = torch.tensor(x60, dtype=torch.float32, device="cuda")[None]
        caps = (F0_FLOOR, F0_CEIL, 5.0, H.default_max_candidates(),
                H.default_max_sections(x60.shape[0], GLIDE_FS))
        an = {}
        for name, blocking in (("blocked", None), ("unblocked", {})):
            src = H.harvest_core(x60_t, GLIDE_FS, *caps, blocking=blocking)
            an[name] = PB.analyze_contour(x60_t, GLIDE_FS, src, 5, True)
        vuv_equal = torch.equal(an["blocked"]["vuv"], an["unblocked"]["vuv"])
        df0 = float((an["blocked"]["f0"] - an["unblocked"]["f0"]).abs().max())
        db = lambda t: 10 * torch.log10(t + 1e-12)    # noqa: E731
        denv = float((db(an["blocked"]["spectrogram"])
                      - db(an["unblocked"]["spectrogram"])).abs().max())
        dap = float((an["blocked"]["aperiodicity"]
                     - an["unblocked"]["aperiodicity"]).abs().max())
        print(f"phase 14 blocked vs unblocked analysis float32 at "
              f"{GLIDE_SECONDS:g} s: vuv equal {vuv_equal}, max |df0| {df0:.3g} Hz "
              f"(< {BLOCKED_F0_HZ}), envelope {denv:.3g} dB (< {BLOCKED_ENV_DB}), "
              f"band aperiodicity {dap:.3g} dB (< {BLOCKED_AP_DB})")
        if not (vuv_equal and df0 < BLOCKED_F0_HZ and denv < BLOCKED_ENV_DB
                and dap < BLOCKED_AP_DB):
            raise AssertionError("phase 14: the blocked analysis differs")
        del an, src

        # the FIR bank alone with its block forced on: once the bands are
        # chunked, the budget leaves the bank whole at this length
        t32 = H.harvest_tables(GLIDE_FS, F0_FLOOR, F0_CEIL, torch.float32, "cuda")
        y60, afs60 = H.downsample(x60_t, GLIDE_FS, 8000, h=t32["decimator_ir"])
        bands = slice(0, blkL32["band_chunk"])
        f_whole = H.band_filtered(y60, t32["band_bank"][bands], t32["band_bias"][bands])
        f_block = H.band_filtered(y60, t32["band_bank"][bands], t32["band_bias"][bands],
                                  FIR_BLOCK)
        dfir = float((f_block - f_whole).abs().max() / f_whole.abs().max())
        del f_whole, f_block
        raw_b = H.raw_band_candidates(
            y60, afs60, t32["band_bank"], t32["band_bias"],
            H.boundary_f0_list(F0_FLOOR, F0_CEIL), opsL32["tq"], F0_FLOOR, F0_CEIL,
            blkL32["band_chunk"], FIR_BLOCK)
        raw_w = opsL32["raw"]
        live = (raw_b > 0) & (raw_w > 0)
        one_only = int(((raw_b > 0) != (raw_w > 0)).sum())
        close = float(torch.isclose(raw_b[live], raw_w[live], rtol=DIO_F32_RAW_RTOL,
                                    atol=0).double().mean())
        print(f"phase 14 FIR bank float32 in blocks of {FIR_BLOCK} output samples "
              f"against the whole bank at {GLIDE_SECONDS:g} s ({blkL32['band_chunk']} "
              f"bands): filtered signals within {dfir:.3g} of their scale (< "
              f"{FIR_BLOCK_REL}); raw candidates: {one_only} of {raw_b.numel()} "
              f"entries live in one only (share < {RAW_FLIPS_SHARE}), share of the "
              f"{int(live.sum())} live in both within rtol {DIO_F32_RAW_RTOL} "
              f"{close:.6f} (> {RAW_CLOSE_SHARE}), bitwise {torch.equal(raw_b, raw_w)}")
        if not (dfir < FIR_BLOCK_REL and one_only < RAW_FLIPS_SHARE * raw_b.numel()
                and close > RAW_CLOSE_SHARE):
            raise AssertionError("phase 14: the blocked FIR bank differs")
        del y60, raw_b, raw_w, live, t32

        # both kernels at one launch's geometry of the blocked path
        blkL64 = harvest_blocking(x60.shape[0], GLIDE_FS, torch.float64)
        opsL64 = main_path_operands(x60, GLIDE_FS, torch.float64, blocking=blkL64)
        for dt, ops in (("float32", opsL32), ("float64", opsL64)):
            hold_kernels(ops, f"{dt} {GLIDE_SECONDS:g} s band chunk / frame chunk",
                         "long_60s_band_chunk", "long_60s_frames")
        raw32, raw64 = opsL32["raw"].double(), opsL64["raw"]
        live = (raw32 > 0) & (raw64 > 0)
        close = torch.isclose(raw32, raw64, rtol=DIO_F32_RAW_RTOL, atol=DIO_RAW_ATOL)
        print(f"phase 14 float32 raw band candidates at {GLIDE_SECONDS:g} s against "
              f"float64 (K1 places a crossing at (i+1) - frac: one ulp is "
              f"{float(np.spacing(np.float32(blkL32['y_len']))):g} sample at "
              f"{blkL32['y_len']} samples): share within rtol "
              f"{DIO_F32_RAW_RTOL} {float(close.double().mean()):.6f} of all entries, "
              f"{float(close[live].double().mean()):.6f} of the "
              f"{int(live.sum())} live in both; {int(((raw32 > 0) != (raw64 > 0)).sum())} "
              f"entries live in one only")
        del opsL64, raw32, raw64, live, close

        # harvest()'s peak memory, blocked and unblocked
        peaks = {}
        for name, blocking in (("blocked", None), ("unblocked", {})):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            H.harvest(x60_t[0], GLIDE_FS, blocking=blocking)
            torch.cuda.synchronize()
            peaks[name] = (torch.cuda.max_memory_allocated() - base, base)
        print(f"phase 14 peak device memory of harvest() float32 at "
              f"{GLIDE_SECONDS:g} s [{card}]: blocked {peaks['blocked'][0] / 2**20:.1f} "
              f"MiB, unblocked {peaks['unblocked'][0] / 2**20:.1f} MiB above the "
              f"{peaks['blocked'][1] / 2**20:.1f} MiB resident before the call; "
              f"ratio {peaks['blocked'][0] / peaks['unblocked'][0]:.3f} (<= 0.5)")
        if peaks["blocked"][0] > 0.5 * peaks["unblocked"][0]:
            raise AssertionError("phase 14: the blocked peak is above half of the "
                                 "unblocked one")

        # each stage alone on what it holds at once in the blocked run: the
        # bytes the blocking rule reckons for it beside the peak the card
        # shows above what was resident.  A blocked stage's chunk must stay
        # inside the budget it was cut for.
        from world_tpu_torch._backend import STAGE_BYTES_BUDGET
        from world_tpu_torch.dsp.fir import bank_bytes_per_sample, band_stage_bytes

        def peak_of(fn):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            res = fn()
            torch.cuda.synchronize()
            del res
            return torch.cuda.max_memory_allocated() - base

        t32 = H.harvest_tables(GLIDE_FS, F0_FLOOR, F0_CEIL, torch.float32, "cuda")
        y60, afs60 = H.downsample(x60_t, GLIDE_FS, 8000, h=t32["decimator_ir"])
        nb, n_fr, uc = blkL32["k1_bands"], blkL32["n_frames"], blkL32["unreliable_chunk"]
        bank_c, bias_c = t32["band_bank"][:nb], t32["band_bias"][:nb]
        bfl_c = H.boundary_f0_list(F0_FLOOR, F0_CEIL)[:nb]
        units = H.stage_units(1, n_fr, opsL32["max_half"], H.C2_SLOTS,
                              H.default_max_sections(x60.shape[0], GLIDE_FS), 4)
        refine_args = (y60, afs60, opsL32["tq"], opsL32["f0"][None], F0_FLOOR,
                       F0_CEIL, opsL32["max_half"], opsL32["table"])
        ref_c, score_c = H.refine_candidates(*refine_args)
        stages = [
            (f"FIR bank, {nb} bands whole", True,
             bank_bytes_per_sample(1, nb, bank_c.shape[1], 4) * blkL32["y_len"],
             lambda: H.band_filtered(y60, bank_c, bias_c)),
            (f"band stage, {nb} bands", True,
             band_stage_bytes(1, blkL32["y_len"], 4) * nb,
             lambda: H.raw_band_candidates(y60, afs60, bank_c, bias_c, bfl_c,
                                           opsL32["tq"], F0_FLOOR, F0_CEIL)),
            (f"refinement, {n_fr} frames whole", False,
             units["refine_chunk"][0] * n_fr,
             lambda: H.refine_candidates(*refine_args)),
            (f"remove_unreliable, chunks of {uc} frames", True,
             units["unreliable_chunk"][0] * uc,
             lambda: H.remove_unreliable(ref_c, score_c, frame_chunk=uc))]
        for label, blocked, reckoned, fn in stages:
            got = peak_of(fn)
            print(f"phase 14 stage peak at {GLIDE_SECONDS:g} s float32, {label}: the "
                  f"rule reckons {reckoned / 2**20:.1f} MiB, the card shows "
                  f"{got / 2**20:.1f} MiB ({got / reckoned:.3f} of it; budget "
                  f"{STAGE_BYTES_BUDGET / 2**20:.0f} MiB)")
            if blocked and got > STAGE_BYTES_BUDGET:
                raise AssertionError(f"phase 14: {label} holds more than the budget")
        del y60, t32, ref_c, score_c, refine_args, stages, bank_c, bias_c

        # the same 60 s through DIO and classic synthesis
        reset_counts()
        dat = wl32.encode(GLIDE_FS, x60, f0_method="dio", is_requiem=False)
        out = wl32.decode(dat)
        torch.cuda.synchronize()
        counts = path_launches("long_audio_60s_dio")
        f0, y = dat["f0"], np.asarray(out["out"])
        voiced = f0[f0 > 0]
        rms = float(np.sqrt(np.mean(y ** 2)))
        print(f"phase 14 long audio float32, the same glide through encode(dio) -> "
              f"classic decode: {f0.shape[0]} frames, {int(dat['vuv'].sum())} "
              f"voiced, median voiced f0 {float(np.median(voiced)):.3f} Hz, rms "
              f"{rms:.4f}, max|y| {np.abs(y).max():.3f}; launches K1 "
              f"{counts['event_engine']}, K2 {counts['refine_dft']}")
        if not (np.all(np.isfinite(f0)) and voiced.size > 0.5 * f0.size
                and 100.0 < np.median(voiced) < 240.0 and np.all(np.isfinite(y))
                and np.abs(y).max() <= 1.0 and rms > 0.01
                and counts["event_engine"] >= 1 and counts["refine_dft"] == 0):
            raise AssertionError("phase 14: the DIO/classic round trip at 60 s")
        # K1 at the one launch that round trip made: DIO's 7 bands whole
        for dt, d in (("float32", dioL32),
                      ("float64", dio_event_operands(x60, GLIDE_FS, f0.shape[0],
                                                     torch.float64))):
            if d["tq"].shape[0] != f0.shape[0]:
                raise AssertionError("phase 14: DIO's frame grid at 60 s")
            hold_kernels(d, f"{dt} {GLIDE_SECONDS:g} s DIO geometry (stride 20/1)",
                         "long_60s_dio")
        del dat, out, x60_t, d

        # the length that shows the bound: Harvest alone, blocked
        xl_np = glide_signal(LONG_FS, LONG_SECONDS)
        xl = torch.tensor(xl_np, device="cuda")
        blkX = harvest_blocking(xl.shape[0], LONG_FS, torch.float32)
        runs = {}
        for name, blocking in (("blocked", None), ("unblocked", {})):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            if name == "blocked":
                hv = H.harvest(xl, LONG_FS, blocking=blocking)
            else:
                # the one call that may not fit the card: printed, not judged
                try:
                    hv = H.harvest(xl, LONG_FS, blocking=blocking)
                except torch.cuda.OutOfMemoryError:
                    hv = None
            torch.cuda.synchronize()
            runs[name] = (hv, time.perf_counter() - t0,
                          torch.cuda.max_memory_allocated(), path_launches(
                              f"long_audio_{LONG_SECONDS:g}s_{name}"))
        hv, secs, peak, counts = runs["blocked"]
        f0 = hv["f0"].cpu().numpy()
        voiced = f0[f0 > 0]
        print(f"phase 14 Harvest alone float32 on {LONG_SECONDS:g} s of the glide at "
              f"{LONG_FS} Hz, blocked (" + ", ".join(f"{k} {blkX[k]}" for k in keys)
              + f") [{card}]: {f0.shape[0]} frames, {voiced.size} voiced, median "
              f"voiced f0 {float(np.median(voiced)):.3f} Hz; {secs:.2f} s = "
              f"{LONG_SECONDS / secs:.1f} xRT, peak {peak / 2**30:.2f} GiB; launches "
              f"K1 {counts['event_engine']} (expected {blkX['k1_launches']}), K2 "
              f"{counts['refine_dft']} (expected {blkX['k2_launches']})")
        if not (np.all(np.isfinite(f0)) and voiced.size > 0.5 * f0.size
                and 100.0 < np.median(voiced) < 240.0
                and counts == {"event_engine": blkX["k1_launches"],
                               "refine_dft": blkX["k2_launches"],
                               "extension_scan": 0}):
            raise AssertionError(f"phase 14: Harvest at {LONG_SECONDS:g} s, blocked")
        hv_u, secs_u, peak_u, _ = runs["unblocked"]
        if hv_u is None:
            print(f"phase 14 Harvest alone on {LONG_SECONDS:g} s, unblocked: "
                  f"torch.cuda.OutOfMemoryError caught after {secs_u:.2f} s; the "
                  f"call does not fit the card (printed, not judged)")
        else:
            same = torch.equal(hv_u["vuv"], hv["vuv"])
            print(f"phase 14 Harvest alone on {LONG_SECONDS:g} s, unblocked: fits, "
                  f"{secs_u:.2f} s, peak {peak_u / 2**30:.2f} GiB; vuv equal to the "
                  f"blocked run's {same}, max |df0| "
                  f"{float((hv_u['f0'] - hv['f0']).abs().max()):.3g} Hz (printed, "
                  f"not judged)")
        del runs, hv, hv_u, xl
        gc.collect()
        torch.cuda.empty_cache()
        # both kernels at one launch of that run: the first chunk of bands
        # (the longest rows K1 runs) and the first chunk of frames
        opsX32 = main_path_operands(xl_np, LONG_FS, torch.float32, blocking=blkX)
        hold_kernels(opsX32, f"float32 {LONG_SECONDS:g} s band chunk / frame chunk",
                     "long_600s_band_chunk", "long_600s_frame_chunk")
        del opsX32["raw"]
        gc.collect()
        torch.cuda.empty_cache()
        print("phase 14 long audio: ok")

    if 15 in phases:
        from world_tpu_torch import (batch_encode_decode, frame_sharded_cheaptrick)
        from world_tpu_torch.spectral.cheaptrick import cheaptrick

        # more rows than one K1 launch takes
        n_cut = int(MANY_ROWS_SECONDS * fs)
        step = (x16.shape[0] - n_cut) // MANY_ROWS
        xm = np.stack([x16[i * step:i * step + n_cut] for i in range(MANY_ROWS)])
        blkM = harvest_blocking(n_cut, fs, torch.float32, n_rows=MANY_ROWS)
        launched_rows = []
        real_k1 = edge_interp.event_engine_cuda

        def recording_k1(signals, *a):
            launched_rows.append(signals.shape[0])
            return real_k1(signals, *a)

        edge_interp.event_engine_cuda = recording_k1
        try:
            # the first call runs eagerly and its launches are recorded first;
            # the second captures the graph, the counted third replays it
            took = []
            for _ in range(2):
                t0 = time.perf_counter()
                batch_encode_decode(xm, fs)
                torch.cuda.synchronize()
                took.append(time.perf_counter() - t0)
            first_s, capture_call_s = took
            reset_counts()
            t0 = time.perf_counter()
            out = batch_encode_decode(xm, fs)
            torch.cuda.synchronize()
            many_s = time.perf_counter() - t0
            counts = path_launches("many_rows")
            # the row split alone: every band in one chunk
            from world_tpu_torch.f0 import harvest as H
            xm_t = torch.tensor(xm, dtype=torch.float32, device="cuda")
            tabs = H.harvest_tables(fs, F0_FLOOR, F0_CEIL, torch.float32, "cuda")
            ym, afs_m = H.downsample(xm_t, fs, 8000, h=tabs["decimator_ir"])
            tq_m = torch.as_tensor(np.arange(int(1000 * n_cut / fs + 1)) / 1000,
                                   dtype=torch.float32, device="cuda")
            raw_args = (ym, afs_m, tabs["band_bank"], tabs["band_bias"],
                        H.boundary_f0_list(F0_FLOOR, F0_CEIL), tq_m, F0_FLOOR, F0_CEIL)
            n_before = len(launched_rows)
            raw_split = H.raw_band_candidates(*raw_args)
            split_rows = launched_rows[n_before:]
            raw_chunked = H.raw_band_candidates(*raw_args, blkM["band_chunk"])
        finally:
            edge_interp.event_engine_cuda = real_k1
        n_path = counts["event_engine"]
        # both kernels against their plain versions on one launch of that
        # batch (a chunk of bands of all 110 rows; every row's frames), then
        # K1 on the most rows a launch takes: every band asked for in one
        # chunk, which the band stage cuts to 148 bands of 110 rows
        opsM32 = main_path_operands(xm, fs, torch.float32, blocking=blkM)
        hold_kernels(opsM32, f"float32 {MANY_ROWS} rows of {MANY_ROWS_SECONDS} s, "
                     f"one band chunk / all frames", "many_rows_band_chunk",
                     "many_rows_frames")
        del opsM32["raw"]
        opsR32 = main_path_operands(xm, fs, torch.float32)
        hold_kernels(opsR32, f"float32 {MANY_ROWS} rows, the most bands one launch "
                     f"takes", "many_rows_row_limit")
        limit_rows = opsR32["rows"].shape[0]
        if (opsM32["rows"].shape[0] != launched_rows[0]
                or opsM32["seg"].shape[0] != MANY_ROWS * opsM32["tq"].shape[0]
                or limit_rows != split_rows[0]):
            raise AssertionError("phase 15: the operands held are not the launches'")
        del opsR32
        # every band in one chunk against chunks of bands: the bank's matrix
        # products get other shapes, so float32 filtered signals differ in
        # their last places, and with them a crossing here and there
        live = (raw_split > 0) & (raw_chunked > 0)
        one_only = int(((raw_split > 0) != (raw_chunked > 0)).sum())
        close = float(torch.isclose(raw_split[live], raw_chunked[live],
                                    rtol=DIO_F32_RAW_RTOL, atol=0).double().mean())
        print(f"phase 15 {MANY_ROWS} utterances of {MANY_ROWS_SECONDS} s through "
              f"batch_encode_decode float32 ({MANY_ROWS * 4 * blkM['n_bands']} event "
              f"rows, band_chunk {blkM['band_chunk']}): K1 launched "
              f"{n_path} times with {launched_rows[:n_path]} rows, K2 "
              f"{counts['refine_dft']} (one replay); {many_s:.2f} s of wall time = "
              f"{MANY_ROWS * MANY_ROWS_SECONDS / many_s:.1f} xRT, the first call "
              f"(eager) {first_s:.2f} s, the second (warm-up, capture, replay) "
              f"{capture_call_s:.2f} s [{card}]; voiced share "
              f"{float(out['vuv'].mean()):.3f}; every band asked for in one chunk: "
              f"K1 rows {split_rows}, the first held bitwise against the plain "
              f"version above; raw "
              f"candidates against the chunked call's: {one_only} of "
              f"{raw_split.numel()} entries live in one only (share < "
              f"{RAW_FLIPS_SHARE}), share of the {int(live.sum())} live in both "
              f"within rtol {DIO_F32_RAW_RTOL} {close:.6f} (> {RAW_CLOSE_SHARE}), "
              f"bitwise {torch.equal(raw_split, raw_chunked)}")
        if not (n_path == blkM["k1_launches"] and n_path > 1 and len(split_rows) > 1
                and max(launched_rows) <= MAX_K1_ROWS
                and sum(launched_rows[:n_path]) == MANY_ROWS * 4 * blkM["n_bands"]
                and sum(split_rows) == MANY_ROWS * 4 * blkM["n_bands"]
                and torch.isfinite(out["y"]).all() and bool(out["vuv"].any())
                and out["y"].shape[0] == MANY_ROWS
                and one_only < RAW_FLIPS_SHARE * raw_split.numel()
                and close > RAW_CLOSE_SHARE):
            raise AssertionError("phase 15: the batch of many rows")
        del out, raw_split, raw_chunked, ym
        graph_memory(xm_t, fs, card)
        del xm_t

        # phase 5's batch over two shards on the one card
        two = ["cuda:0", "cuda:0"]
        blkS = harvest_blocking(x16.shape[0], fs, torch.float32, n_rows=2)
        for _ in range(2):                 # eager, then the graph's capture
            batch_encode_decode(xs, fs, devices=two)
        torch.cuda.synchronize()
        reset_counts()
        sharded = batch_encode_decode(xs, fs, devices=two)
        torch.cuda.synchronize()
        counts = path_launches("two_shards")
        whole = batch_encode_decode(xs, fs, devices="cuda:0")
        # every output is held bitwise, the waveform too: the overlap-add
        # sums in a fixed order, so one call run twice gives the same bits
        keys5 = ("f0", "vuv", "spectrogram", "band_aperiodicity", "_overflow", "y")
        rerun_equal = []
        for k in range(2):
            own = batch_encode_decode(xs[2 * k:2 * k + 2], fs, devices="cuda:0")
            again = batch_encode_decode(xs[2 * k:2 * k + 2], fs, devices="cuda:0")
            rerun_equal.append(torch.equal(own["y"], again["y"]))
            for key in keys5:
                if not torch.equal(sharded[key][2 * k:2 * k + 2], own[key]):
                    raise AssertionError(f"phase 15: shard {k}'s {key} is not "
                                         f"bitwise its one-device call's")
        if not all(rerun_equal):
            raise AssertionError(f"phase 15: one call run twice gives another "
                                 f"waveform: {rerun_equal}")
        flips = int((sharded["vuv"] != whole["vuv"]).sum())
        df0 = float((sharded["f0"] - whole["f0"]).abs().max())
        rel = float(((sharded["y"] - whole["y"]).norm(dim=1)
                     / whole["y"].norm(dim=1)).max())
        ddb = float((10 * torch.log10(sharded["spectrogram"] + 1e-12)
                     - 10 * torch.log10(whole["spectrogram"] + 1e-12)).abs().max())
        print(f"phase 15 batch of 4 over devices={two}: each shard's f0, vuv, "
              f"envelope, band aperiodicity, flags and waveform bitwise its "
              f"one-device call's on its own rows; the same one-device call twice "
              f"gives a bitwise equal waveform: {rerun_equal}; against the "
              f"one-device batch of 4: "
              f"vuv flips {flips} (0), max |df0| {df0:.3g} Hz (< 1e-3), waveform rel "
              f"L2 {rel:.3g} (< 1e-2), envelope {ddb:.3g} dB (< 0.05); launches K1 "
              f"{counts['event_engine']}, K2 {counts['refine_dft']}; on "
              f"{sharded['y'].device}")
        if not (flips == 0 and df0 < 1e-3 and rel < 1e-2 and ddb < 0.05
                and counts == {"event_engine": 2 * blkS["k1_launches"],
                               "refine_dft": 2 * blkS["k2_launches"],
                               "extension_scan": 0}):
            raise AssertionError("phase 15: the sharded batch")
        # both kernels at the geometry a shard of two rows launches them at
        opsS32 = main_path_operands(xs[:2], fs, torch.float32, blocking=blkS)
        hold_kernels(opsS32, "float32 one shard of 2 rows", "shard_of_2",
                     "shard_of_2")
        del opsS32["raw"]

        # CheapTrick with its frames sharded, on the golden contour
        x16_64 = torch.tensor(x16, dtype=torch.float64, device="cuda")
        src_g = {"f0": g["f0"], "vuv": g["vuv"],
                 "temporal_positions": g["temporal_positions"]}
        ref_env = cheaptrick(x16_64, fs, src_g)["spectrogram"].T
        n_fr = ref_env.shape[0]
        for n_dev in (2, 4):
            env, total = frame_sharded_cheaptrick(
                x16_64, g["f0"], g["vuv"], g["temporal_positions"], fs,
                ["cuda:0"] * n_dev)
            pad = (-n_fr) % n_dev
            padded = dict(f0=np.r_[np.where(g["vuv"] == 0, 500.0, g["f0"]),
                                   np.full(pad, 500.0)],
                          vuv=np.ones(n_fr + pad),
                          temporal_positions=np.r_[g["temporal_positions"],
                                                   np.zeros(pad)])
            want_total = float(cheaptrick(x16_64, fs, padded)["spectrogram"].sum())
            ddb = float((10 * torch.log10(env + 1e-7)
                         - 10 * torch.log10(ref_env + 1e-7)).abs().max())
            rel_tot = abs(float(total) - want_total) / want_total
            print(f"phase 15 frame_sharded_cheaptrick float64 over {n_dev} shards "
                  f"({n_fr} frames + {pad} padding frames): envelope within "
                  f"{ddb:.3g} dB of cheaptrick (< 0.2 on a 1e-7 floor); total_energy "
                  f"{float(total):.9g} against {want_total:.9g} with the padding "
                  f"frames (relative {rel_tot:.3g}), {float(ref_env.sum()):.9g} "
                  f"without")
            if not (env.shape == ref_env.shape and ddb < 0.2 and rel_tot < 1e-9
                    and (pad == 0 or float(total) > float(ref_env.sum()))):
                raise AssertionError(f"phase 15: frame_sharded_cheaptrick over "
                                     f"{n_dev} shards")
        print("phase 15 rows and devices: ok")

    ops22 = None
    if 16 in phases or 6 in phases:
        from world_tpu_torch.f0 import harvest as H

        gh = np.load(GOLDEN_DIR / "harvest.npz")
        fs22 = int(gh["fs"])
        afs22 = H.decimation(fs22)[1]

        def decimated22(dtype):
            y = torch.tensor(np.asarray(gh["y_decimated"]), dtype=dtype,
                             device="cuda")[None]
            return y, H.harvest_tables(fs22, F0_FLOOR, F0_CEIL, dtype, "cuda")

        y22, tab22 = decimated22(torch.float32)
        ops22 = decimated_operands(y22, afs22, HARVEST22_LENGTH, fs22, tab22)
    if 16 in phases:
        reset_counts()
        hv = H.harvest_decimated(y22, afs22, HARVEST22_LENGTH, fs22, F0_FLOOR,
                                 F0_CEIL, 5.0, H.default_max_candidates(),
                                 H.default_max_sections(HARVEST22_LENGTH, fs22),
                                 debug_outputs=True, tables=tab22)
        torch.cuda.synchronize()
        counts = path_launches("harvest_22k_stages")
        hv = {k: (v if k == "temporal_positions" else v[0]).double().cpu().numpy()
              for k, v in hv.items()}
        agreements = harvest22_agreements(hv, gh)
        vuv_agree = float(np.mean(hv["vuv"] == gh["vuv"]))
        both = (hv["vuv"] == 1) & (gh["vuv"] == 1)
        rmse = float(np.sqrt(np.mean((hv["f0"][both] - gh["f0"][both]) ** 2)))
        print(f"phase 16 Harvest float32 on 22.05 kHz speech (harvest.npz's "
              f"y_decimated, {y22.shape[1]} samples at {afs22:g} Hz, "
              f"{hv['_raw_candidates'].shape[1]} frames of 1 ms) against the "
              f"golden, each stage's share within tests/test_harvest.py's "
              f"(rtol, atol), printed: "
              + ", ".join(f"{k} {a:.6f} (bar {HARVEST22_STAGE_BARS[k][2]})"
                          for k, a in agreements.items())
              + f"; final contour: vuv agreement {vuv_agree:.6f} (> 0.99), voiced "
              f"F0 RMSE {rmse:.6g} Hz (< 1); launches K1 {counts['event_engine']}, "
              f"K2 {counts['refine_dft']}")
        if not (vuv_agree > 0.99 and rmse < 1.0):
            raise AssertionError("phase 16: the 22.05 kHz contour misses the "
                                 "golden bars")
        if counts != {"event_engine": 1, "refine_dft": 1, "extension_scan": 0}:
            raise AssertionError(f"phase 16: one K1 and one K2 launch: {counts}")
        y64, tab64 = decimated22(torch.float64)
        ops22_64 = decimated_operands(y64, afs22, HARVEST22_LENGTH, fs22, tab64)
        for dt, ops in (("float32", ops22), ("float64", ops22_64)):
            hold_kernels(ops, f"{dt} 22.05 kHz speech (stride 147/20)",
                         "harvest_22k", "harvest_22k")
        del hv, y64, tab64, ops22_64
        print("phase 16 22.05 kHz speech: ok")

    if 17 in phases:
        import contextlib
        import io

        sys.path.insert(0, str(ROOT / "tools"))
        import bench_paths_torch
        import bench_torch
        import profile_stages_torch

        def json_of(fn, argv, label):
            """Run a benchmark's main, pass its output through, and parse
            the JSON line it ends with."""
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                fn(argv)
            text = buf.getvalue()
            print("\n".join(f"phase 17 {label}: {line}" for line in
                            text.strip().splitlines()[:-1]))
            doc = json.loads(text.strip().splitlines()[-1])
            print(f"phase 17 {label} JSON: {json.dumps(doc)}")
            return doc

        reset_counts()
        bench = json_of(bench_torch.main, ["--readings", "3", "--rounds", "2"],
                        "bench_torch.py")
        path_launches("bench_torch")
        paths = json_of(bench_paths_torch.main,
                        ["--readings", "1", "--rounds", "1", "--batch", "1", "4"],
                        "bench_paths_torch.py")
        prof = json_of(profile_stages_torch.main, ["--signal", "x16"],
                       "profile_stages_torch.py")
        gates = {f"bench {k}": v["gate"] for k, v in bench["paths"].items()}
        gates.update({f"paths {k}": v["gate"] for k, v in paths["paths"].items()})
        gates.update({f"batch {k}": v["gate"] for k, v in paths["batch_sweep"].items()})
        print(f"phase 17 gates: {gates}")
        if set(gates.values()) != {"PASS"}:
            raise AssertionError(f"phase 17: a gate failed: {gates}")
        if bench["paths"]["single"]["launches"] != {"event_engine": 1, "refine_dft": 1,
                                                    "extension_scan": 0}:
            raise AssertionError("phase 17: bench_torch's round trip must launch "
                                 "each kernel once")
        syncing = {k: v["host_syncs"] for k, v in prof["signals"][0]["stages"].items()
                   if v["host_syncs"] != 0}
        if syncing:
            raise AssertionError(f"phase 17: stages of the eager round trip sync "
                                 f"the host: {syncing}")
        print("phase 17 benchmarks: ok")

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
        # the CUDA graph's replay (the module's own) beside the same static
        # code run eagerly: graph, eager, eager, graph
        from bench_torch import eager_round_trip

        times = {}
        for graphs in (True, False, False, True):
            for name, xin in (("single", xs_t[:1]), ("batch-4", xs_t)):
                call = ((lambda: model(xin)) if graphs else    # noqa: E731
                        (lambda: eager_round_trip(model, xin)))
                times.setdefault((name, graphs), []).append(
                    cuda_ms(call, iters=3, warmup=2))
        print(f"phase 6 Harvest/Requiem round trip float32 (4.644 s utterance) "
              f"[{card}]: " + "; ".join(
                  f"{name} {'graph' if graphs else 'eager static'} "
                  f"{'/'.join(f'{t:.2f}' for t in ts)} ms = "
                  f"{(4 if name == 'batch-4' else 1) * duration / (np.mean(ts) / 1e3):.2f}"
                  f" xRT" for (name, graphs), ts in times.items()))
        from world_tpu_torch.dsp.ola import scatter_ola, slot_ola

        def time_ola(label, args):
            """The round trip's static overlap-add (slot_ola at its rank
            bound) beside the checked scatter_ola (32 passes) and index_add_
            on one synthesis' operands, taken new, old, old, new."""
            resp, starts, y_length, max_rank = args
            static = lambda: slot_ola(resp, starts, y_length, max_rank)[0]  # noqa: E731
            n1 = cuda_ms(static, iters=20)
            c1 = cuda_ms(lambda: scatter_ola(resp, starts, y_length), iters=20)
            o1 = cuda_ms(lambda: index_add_ola(resp, starts, y_length), iters=20)
            o2 = cuda_ms(lambda: index_add_ola(resp, starts, y_length), iters=20)
            n2 = cuda_ms(static, iters=20)
            new, old = static(), index_add_ola(resp, starts, y_length)
            rel = float((new - old).abs().max() / old.abs().max())
            live = int((starts < y_length).sum())
            print(f"phase 6 overlap-add of the pulses float32 at {label} "
                  f"[{card}]: {tuple(resp.shape)} responses ({live} live) into "
                  f"{y_length} samples: slot_ola at {max_rank} ranks (fixed "
                  f"order) {n1:.4f}/{n2:.4f} ms, scatter_ola (32 ranks) "
                  f"{c1:.4f} ms, index_add_ {o1:.4f}/{o2:.4f} ms, ratio "
                  f"{(n1 + n2) / (o1 + o2):.3f}; results within {rel:.3g} of "
                  f"their scale; bitwise twice {torch.equal(new, static())} and "
                  f"against scatter_ola "
                  f"{torch.equal(new, scatter_ola(resp, starts, y_length))}")

        ola_args = captured_ola(lambda: eager_round_trip(model, xs_t[:1]))
        time_ola(f"{duration:.3f} s", ola_args)
        saved = (edge_interp.counter.launches, refine_dft.counter.launches,
                 extension_scan.counter.launches)
        reset_counts()
        t_classic = cuda_ms(lambda: w32.decode(w32.encode(
            fs, x16, f0_method="dio", is_requiem=False)), iters=3)
        per_call = edge_interp.counter.launches / 4
        print(f"phase 6 classic round trip float32 (4.644 s utterance) [{card}]: "
              f"World.encode/decode (eager) {t_classic:.2f} ms = "
              f"{duration / (t_classic / 1e3):.2f} xRT; launches per call K1 "
              f"{per_call:g}, K2 {refine_dft.counter.launches / 4:g}, K3 "
              f"{extension_scan.counter.launches / 4:g}")
        # DioClassic's replay beside the same static code run eagerly: graph,
        # eager, eager, graph (each signature captured by its warm-up)
        from bench_torch import eager_classic_round_trip

        ctimes = {}
        for graphs in (True, False, False, True):
            for name, n_rows in (("single", 1), ("batch-4", 4)):
                xin, nz = xs_t[:n_rows], noise[:n_rows]
                call = ((lambda: classic(xin, noise=nz)) if graphs else  # noqa: E731
                        (lambda: eager_classic_round_trip(classic, xin, nz)))
                ctimes.setdefault((name, graphs), []).append(
                    cuda_ms(call, iters=3, warmup=2))
        print(f"phase 6 classic round trip float32 (4.644 s utterance) [{card}]: "
              + "; ".join(
                  f"{name} {'graph' if graphs else 'eager static'} "
                  f"{'/'.join(f'{t:.2f}' for t in ts)} ms = "
                  f"{(4 if name == 'batch-4' else 1) * duration / (np.mean(ts) / 1e3):.2f}"
                  f" xRT" for (name, graphs), ts in ctimes.items()))
        stages = classic_stages(x16, fs)
        print(f"phase 6 classic stages float32 [{card}]: "
              + ", ".join(f"{k} {v['ms']:.2f} ms ({v['device_events']} device "
                          f"events, {v['host_syncs']} host syncs)"
                          for k, v in stages.items()))
        if any(v["host_syncs"] for v in stages.values()):
            raise AssertionError(f"phase 6: a classic stage syncs the host: "
                                 f"{ {k: v['sync_at'] for k, v in stages.items()} }")
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

        # path A: SWIPE' alone, with its tables built in the call and held
        # by the module, then the round trip and its device time
        from world_tpu_torch import SwipeF0
        from world_tpu_torch.f0.swipe import swipe

        x16_t = xs_t[0]
        swipe_mod = SwipeF0(fs, x16.shape[0], sTHR=0.3, dtype=torch.float32,
                            device="cuda")
        t_sw = cuda_ms(lambda: swipe(fs, x16_t, sTHR=0.3), iters=5)
        t_swm = cuda_ms(lambda: swipe_mod(x16_t), iters=5)
        t_a = cuda_ms(lambda: w32.decode(w32.encode(fs, x16, f0_method="swipe")),
                      iters=3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            swipe_mod(x16_t)
            torch.cuda.synchronize()
        sw_us, sw_events = device_totals(prof)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w32.decode(w32.encode(fs, x16, f0_method="swipe"))
            torch.cuda.synchronize()
        a_us, a_events = device_totals(prof)
        idle = (lambda us, ms: f"{1 - us / 1e3 / ms:.3f}" if us else "not measured")
        print(f"phase 6 path A SWIPE' float32 (4.644 s utterance) [{card}]: swipe() "
              f"{t_sw:.3f} ms = {duration / (t_sw / 1e3):.1f} xRT (tables built in "
              f"the call), SwipeF0 module {t_swm:.3f} ms = "
              f"{duration / (t_swm / 1e3):.1f} xRT: {sw_events} device events, "
              f"{sw_us / 1e3:.3f} ms device time, idle share {idle(sw_us, t_swm)}; "
              f"encode(swipe) -> decode {t_a:.2f} ms = {duration / (t_a / 1e3):.2f} "
              f"xRT: {a_events} device events, {a_us / 1e3:.3f} ms device time, idle "
              f"share {idle(a_us, t_a)} of the unprofiled time")

        # path B: the codec chain on the Harvest analysis' envelope
        from world_tpu_torch.features.vae import MLP

        dat_b = w32.encode(fs, x16, f0_method="harvest", is_requiem=True)
        spec_b = np.sqrt(dat_b["spectrogram"].T)
        enc_b = MLP(vae_weights(VAE_SIZES, 21), VAE_ACTS, device="cuda")
        dec_b = MLP(vae_weights(VAE_SIZES[::-1], 22), VAE_ACTS, device="cuda")

        def codec_chain():
            mc = w32.encode_mcep(spec_b, n0=14, fs=fs, highhz=fs / 2)
            w32.encode_lfbank(spec_b, fs=fs)
            _, yc = w32.encode_vae(mc[:, 1:], mc[:, 0], enc_b, dec_b, 1, 14, 64, 0.0)
            w32.decode_mcep(yc, (spec_b.shape[1] - 1) * 2)

        t_codec = cuda_ms(codec_chain, iters=5)
        t_fft = cuda_ms(lambda: w32.encode(fs, x16, f0_method="harvest",
                                           fft_size=FFT_SIZE_B, is_requiem=True),
                        iters=2)
        print(f"phase 6 path B float32 [{card}]: codec chain (encode_mcep, "
              f"encode_lfbank, encode_vae through the MLP pair, decode_mcep; "
              f"{spec_b.shape[0]} frames, numpy in and out) {t_codec:.3f} ms; "
              f"encode(harvest, fft_size={FFT_SIZE_B}) {t_fft:.2f} ms = "
              f"{duration / (t_fft / 1e3):.2f} xRT")

        # path C: the ragged batch beside the same utterances one by one
        audio_s = sum(u.shape[0] for u in utts) / fs

        def ragged():
            batch_encode_decode_ragged(utts, fs, bucket_quantum_s=RAGGED_QUANTUM_S)

        def one_by_one():
            for u in utts:
                batch_encode_decode_ragged([u], fs,
                                           bucket_quantum_s=RAGGED_QUANTUM_S)

        # ragged, one by one, one by one, ragged: the host's pace drifts.
        # Two warm-up calls each: a signature dropped since phase 13 runs
        # eagerly, then is captured
        r1 = cuda_ms(ragged, iters=2, warmup=2)
        o1 = cuda_ms(one_by_one, iters=2, warmup=2)
        o2 = cuda_ms(one_by_one, iters=2, warmup=2)
        r2 = cuda_ms(ragged, iters=2, warmup=2)
        t_rag, t_one = (r1 + r2) / 2, (o1 + o2) / 2
        print(f"phase 6 path C ragged batch float32 ({len(utts)} utterances, "
              f"{audio_s:.3f} s of audio, {len(buckets)} buckets) [{card}], warm: "
              f"each signature's graph replayed (captured before): "
              f"{r1:.2f}/{r2:.2f} ms = {audio_s / (t_rag / 1e3):.2f} xRT; one by "
              f"one {o1:.2f}/{o2:.2f} ms = {audio_s / (t_one / 1e3):.2f} xRT; ratio "
              f"{t_rag / t_one:.3f}")

        o = ops32
        b4 = main_path_operands(xs, fs, torch.float32)

        def k1_case(geo, ops, plain_iters=5):
            return ("event_engine", geo, (ops["rows"], ops["afs"], ops["tq"],
                                          ops["stride"]),
                    k1_bound(ops["rows"], ops["tq"]), plain_iters)

        def k2_case(geo, ops, plain_iters=5):
            return ("refine_dft", geo, k2_args(ops), k2_bound(ops), plain_iters)

        if opsC32 is None:
            L = min(buckets)
            xb = np.zeros((len(buckets[L]), L), np.float32)
            for r, i in enumerate(buckets[L]):
                xb[r, :utts[i].shape[0]] = utts[i]
            opsC32 = main_path_operands(xb, fs, torch.float32)
        # the 60 s glide: the round trip and its launches
        wl = World(device="cuda", dtype=torch.float32)
        t_long = cuda_ms(lambda: wl.decode(wl.encode(
            GLIDE_FS, x60, f0_method="harvest", is_requiem=True)), iters=2)
        reset_counts()
        ola60 = captured_ola(lambda: wl.decode(wl.encode(
            GLIDE_FS, x60, f0_method="harvest", is_requiem=True)))
        print(f"phase 6 Harvest/Requiem round trip float32 on the "
              f"{GLIDE_SECONDS:g} s glide at {GLIDE_FS} Hz [{card}]: {t_long:.1f} ms "
              f"= {GLIDE_SECONDS / (t_long / 1e3):.2f} xRT; launches of one call, "
              f"counted around it: K1 {edge_interp.counter.launches}, K2 "
              f"{refine_dft.counter.launches}")
        time_ola(f"{GLIDE_SECONDS:g} s", ola60)
        del ola60
        # the same 60 s through HarvestRequiem: its graph's replay beside the
        # eager static call, and the replay's device events
        m60 = HarvestRequiem(GLIDE_FS, x60.shape[0], dtype=torch.float32,
                             device="cuda")
        x60_m = torch.tensor(x60, dtype=torch.float32, device="cuda")[None]
        m60(x60_m)                         # the first call runs eagerly
        t0 = time.perf_counter()
        m60(x60_m)
        torch.cuda.synchronize()
        first60 = time.perf_counter() - t0
        g60 = m60.graphs.graphs()[-1]
        gr1 = cuda_ms(lambda: m60(x60_m), iters=3)
        ea60 = cuda_ms(lambda: eager_round_trip(m60, x60_m), iters=1)
        gr2 = cuda_ms(lambda: m60(x60_m), iters=3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            m60(x60_m)
            torch.cuda.synchronize()
        us60, ev60 = device_totals(prof)
        print(f"phase 6 HarvestRequiem float32 on the {GLIDE_SECONDS:g} s glide "
              f"[{card}]: graph replay {gr1:.1f}/{gr2:.1f} ms = "
              f"{GLIDE_SECONDS / ((gr1 + gr2) / 2 / 1e3):.1f} xRT, eager static "
              f"{ea60:.1f} ms = {GLIDE_SECONDS / (ea60 / 1e3):.1f} xRT; second "
              f"call (warm-up, capture, replay) {first60:.2f} s, capture "
              f"{g60.capture_s:.2f} s, pool {g60.pool_bytes / 2**20:.0f} MiB; one "
              f"replay under torch.profiler: {ev60} device events, "
              f"{us60 / 1e3:.1f} ms device time, idle share "
              + (f"{1 - us60 / 1e3 / ((gr1 + gr2) / 2):.3f}" if ev60 else "not measured"))
        del m60, x60_m
        # what the blocking costs: harvest_core on the same 60 s, blocked as
        # it chooses and with every bound off, taken one, other, other, one
        from world_tpu_torch.f0 import harvest as H6

        x60_t = torch.tensor(x60, dtype=torch.float32, device="cuda")[None]
        caps6 = (F0_FLOOR, F0_CEIL, 5.0, H6.default_max_candidates(),
                 H6.default_max_sections(x60.shape[0], GLIDE_FS))
        tabs6 = H6.harvest_tables(GLIDE_FS, F0_FLOOR, F0_CEIL, torch.float32, "cuda")
        core = lambda blocking: H6.harvest_core(    # noqa: E731
            x60_t, GLIDE_FS, *caps6, tables=tabs6, blocking=blocking)
        hb1 = cuda_ms(lambda: core(None), iters=2)
        hu1 = cuda_ms(lambda: core({}), iters=2)
        hu2 = cuda_ms(lambda: core({}), iters=2)
        hb2 = cuda_ms(lambda: core(None), iters=2)
        print(f"phase 6 harvest_core float32 on the {GLIDE_SECONDS:g} s glide "
              f"[{card}]: blocked {hb1:.1f}/{hb2:.1f} ms, every bound off "
              f"{hu1:.1f}/{hu2:.1f} ms, ratio {(hb1 + hb2) / (hu1 + hu2):.3f}")
        del x60_t, tabs6
        # the batch of 4 on one device and over two shards of the one card,
        # taken one, two, two, one
        two = ["cuda:0", "cuda:0"]
        # two warm-up calls each: eager, then the graph's capture
        d1 = cuda_ms(lambda: batch_encode_decode(xs, fs, devices="cuda:0"), iters=2,
                     warmup=2)
        s1 = cuda_ms(lambda: batch_encode_decode(xs, fs, devices=two), iters=2,
                     warmup=2)
        s2 = cuda_ms(lambda: batch_encode_decode(xs, fs, devices=two), iters=2,
                     warmup=2)
        d2 = cuda_ms(lambda: batch_encode_decode(xs, fs, devices="cuda:0"), iters=2,
                     warmup=2)
        print(f"phase 6 batch_encode_decode of 4 float32 [{card}]: one device "
              f"{d1:.2f}/{d2:.2f} ms, devices={two} {s1:.2f}/{s2:.2f} ms, ratio "
              f"{(s1 + s2) / (d1 + d2):.3f} (two worker threads on one card: the "
              f"split, not an overlap of two cards)")
        cases = [k1_case("long_60s_band_chunk", opsL32, 1),
                 k2_case("long_60s_frames", opsL32, 1),
                 k1_case("long_60s_dio", dioL32, 2)]
        # the geometries phases 14 and 15 held, where those phases ran
        if opsX32 is not None:
            cases += [k1_case("long_600s_band_chunk", opsX32, 1),
                      k2_case("long_600s_frame_chunk", opsX32, 1)]
        if opsM32 is not None:
            cases += [k1_case("many_rows_band_chunk", opsM32, 1),
                      k2_case("many_rows_frames", opsM32, 1),
                      k1_case("shard_of_2", opsS32, 2),
                      k2_case("shard_of_2", opsS32, 2)]
        cases += [k1_case("harvest_22k", ops22), k2_case("harvest_22k", ops22)]
        cases += [
                 k1_case("harvest_8k", o), k1_case("dio_x16", dio32),
                 k1_case("harvest_8k_batch4", b4, 2),
                 k1_case("bucket_1s", opsC32), k1_case("harvest_fft2048", opsB32, 2),
                 k1_case("dio_fft2048", dioB32),
                 k2_case("harvest_8k", o), k2_case("harvest_8k_batch4", b4, 2),
                 k2_case("bucket_1s", opsC32), k2_case("harvest_fft2048", opsB32, 2)]
        # K3: the forward scan of each geometry (the round trip runs it and
        # the backward one, of the same shapes)
        for geo, plain_iters in (("dio_x16", 2), ("dio_x16_batch4", 2),
                                 ("dio_60s", 1)):
            if geo not in k3_ops:
                sig, sfs, rows = ((x60, GLIDE_FS, 1) if geo == "dio_60s"
                                  else (x16, fs, 4 if "batch4" in geo else 1))
                k3_ops[geo] = k3_operands(sig, sfs, torch.float32, rows)
            args = k3_ops[geo][0]
            out = extension_scan.extension_scan_cuda(*args)
            cases.append(("extension_scan", geo, args, k3_bound(args, out),
                          plain_iters))
        fns = {"event_engine": (edge_interp.event_engine_cuda,
                                batched_interval_interp),
               "refine_dft": (refine_dft.refine_cuda, refine_dft.refine_plain),
               "extension_scan": (extension_scan.extension_scan_cuda,
                                  extension_scan.extension_scan_plain)}
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
            if geo == ("dio_x16" if name == "extension_scan" else "harvest_8k"):
                kernels[name].update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                                     bound_ms=b_ms, bound_by=b_by)
            print(f"phase 6 {name} float32 at {geo} [{card}]: kernel "
                  f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound "
                  f"{b_ms:.4g} ms ({b_by}), share of bound "
                  f"{b_ms / ((k1 + k2) / 2):.3g}; the wrapper's host time "
                  f"{h_us:.1f} us a call")
        del b4
        (edge_interp.counter.launches, refine_dft.counter.launches,
         extension_scan.counter.launches) = saved

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
