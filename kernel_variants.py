#!/usr/bin/env python3
"""Where the time of the port's CUDA kernels goes, by variants.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 kernel_variants.py [k1 k2 step3 k3 d4c] [--against OTHER/extension_scan.cu]
                               [--against OTHER/d4c_spectra.cu]

(the kernels to vary; all when none is named: K1 and K2, timed together,
Harvest FixStep3's K4 and K5, DIO's K3, and D4C's K6 and K7.  ``--against`` adds another
source of K3's or of K6's and K7's C interface, e.g. a parent commit's unpacked
with ``git archive`` into the git-ignored ``_checkout/``, as the group's
variant "against": K3's is held bitwise beside the kernel as built, and the
two are timed other, this, ..., this, other; K6's and K7's are timed beside
the variants, first and last)

Without a device profiler that reads counters, this script builds variants
of each kernel source with one part removed or changed (text substitutions
of world_tpu_torch/csrc/*.cu), loads each as a library of its own and times
it with CUDA events on the Harvest main path's float32 operands (K1 also at
DIO's geometry; K4 and K5 at x16 and on the 60 s glide; K3 on DIO's
operands at x16, batch 4 and on the 60 s glide; K6 and K7 on phase 22's
operands at x16 and on the 60 s glide), in turns.  A variant that
removes work computes garbage: only its time means anything, and the
difference from the full kernel is what the removed part costs.  It then times the host's share of one call of
K1's wrapper and of its parts.  It asserts nothing about speed.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "world_tpu_torch" / "csrc"

# K2 (refine_dft.cu): (name, what it shows, substitutions)
_SLOTS = "        for (int i = worker; i < n_live; i += 4 * kWarps) {"
_WINDOWS = "        for (int w = warp; w < n_win; w += kWarps) {"
_LOOP = ("#pragma unroll 2\n          for (int j = jlo + gl; j <= jhi; j += 8) {")
_COS = ("  const T c2 = M<T>::cos(T(2) * common);\n"
        "  const T c4 = M<T>::cos(T(4) * common);")
K2_VARIANTS = (
    ("full", "the kernel as built", ()),
    ("no_accumulate", "without the slots' sample loop",
     ((_LOOP, _LOOP.replace("j <= jhi", "j < -1")),)),
    ("no_cos", "the windows without their two cosines",
     ((_COS, "  const T c2 = common;\n  const T c4 = common * common;"),)),
    ("no_windows", "without the window phase",
     ((_WINDOWS, _WINDOWS.replace("w < n_win", "w < -1")),)),
    ("no_slots", "without the slot phase",
     ((_SLOTS, _SLOTS.replace("i < n_live", "i < -1")),)),
    ("bookkeeping_only", "without windows and slots: loads and bookkeeping",
     ((_SLOTS, _SLOTS.replace("i < n_live", "i < -1")),
      (_WINDOWS, _WINDOWS.replace("w < n_win", "w < -1")))),
    ("shortest_first", "windows and slots ordered by half from the smallest",
     (("        const bool before = h2 > my_half;",
       "        const bool before = h2 < my_half;"),)),
    ("8_warps", "blocks of 8 warps instead of 4",
     (("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),)),
)

# K1 (event_engine.cu)
_FRAMES = "  for (int i = 0; i < kFramesPerThread; ++i) {\n    const int q = q0 + tid + i * kThreads;\n    if (q >= q1) break;\n    const long long g"
K1_VARIANTS = (
    ("full", "the kernel as built", ()),
    ("pass1_loads_only", "pass 1 stops after its loads",
     (("  int total;\n  const int off = block_scan<kScanThreads / 32>",
       "  if (bits == 0x5Au && after == T(-12345)) pos[tid] = v[0];\n  return;\n"
       "  int total;\n  const int off = block_scan<kScanThreads / 32>"),)),
    ("pass2_no_frames", "pass 2 without its per-frame selection",
     ((_FRAMES, _FRAMES.replace("if (q >= q1) break;", "if (q >= q0) break;")),)),
    ("span_4096", "pass-2 blocks of ~4,096 samples of frames",
     (("constexpr int kSpanSamples = 8192;", "constexpr int kSpanSamples = 4096;"),)),
)


# K4 and K5 (fix_step3.cu)
_PICK = "    const T picked = pick(s_cand, C, n_steps, k, lane, ref, allowed);"
_STAGE = "  for (int base = lane; base < total; base += 32 * kStageBatch) {"
_DIV = "div_rn(fabsf(sub_rn(ref, s_cand[(size_t)c * n_steps + k])), ref)"
_SCORE = ("          for (long long base = lo - lo % kPassFrames; base <= hi; "
          "base += kPassFrames) {")
_COPY = "  for (long long i = lo + tid; i <= hi; i += kMergeThreads)"
STEP3_VARIANTS = (
    ("full", "the kernels as built", ()),
    ("k4_no_picks", "K4 without its picks: staging and writing out",
     ((_PICK, "    const T picked = s_cand[k];"),)),
    ("k4_no_staging", "K4 without staging its candidates",
     ((_STAGE, _STAGE.replace("base < total", "base < 0")),)),
    ("k4_no_division", "K4's float32 pick without its division",
     ((_DIV, "fabsf(sub_rn(ref, s_cand[(size_t)c * n_steps + k]))"),)),
    ("k5_no_scores", "K5 without SerachScore over the overlaps",
     ((_SCORE, _SCORE.replace("base <= hi", "base < 0")),)),
    ("k5_256_threads", "K5 in blocks of 256 threads",
     (("constexpr int kMergeThreads = 512;", "constexpr int kMergeThreads = 256;"),)),
    ("k5_8_frame_lanes", "K5 scoring 8 frames a warp (4 lanes a frame)",
     (("constexpr int kFrameLanes = 16;", "constexpr int kFrameLanes = 8;"),
      ("constexpr int kCandsPerLane = 24;", "constexpr int kCandsPerLane = 12;"))),
    ("k5_no_candidate_loads", "K5 scoring constants instead of the candidates",
     (("                cv[u] = cands[(size_t)q * n + i];\n"
       "                sv[u] = scores[(size_t)q * n + i];",
       "                cv[u] = T(q);\n                sv[u] = T(1);"),)),
    ("k5_no_row_value", "K5 scoring the contour's value twice",
     (("            const T vr = row_value(i, f0, sst, sed, vf, af, vb, ab, n_steps);",
       "            const T vr = vm;"),)),
)


# K3 (extension_scan.cu)
_PREFETCH = ("#pragma unroll\n      for (int k = 0; k < kPrefetch; ++k) cur[k] = next[k];\n"
             "      r.load(s1 + 1, next);      // the next frame's loads, before this pick")
_HEADS = "  for (int w = threadIdx.x; w < nw; w += kThreads) {"
_WALK = "        walk(r, s_bits, s_first, nw, h, allowed);"
_PASS2 = "  // pass 2: each thread a run of words;"
K3_VARIANTS = (
    ("full", "the kernel as built", ()),
    ("no_prefetch", "a walker loads a frame's candidates at its pick",
     ((_PREFETCH, "      r.load(s1, cur);"),)),
    ("one_thread", "one thread a row walks every head's group in turn",
     ((_HEADS, "  for (int w = threadIdx.x == 0 ? 0 : nw; w < nw; ++w) {"),)),
    ("no_walks", "the heads found, no group walked: the copy, bitmap and scans",
     ((_WALK, "        if (h < 0) walk(r, s_bits, s_first, nw, h, allowed);"),)),
    ("pass1_only", "only the copy of base and the flags' bitmap",
     ((_PASS2, "  return;\n" + _PASS2),)),
)


# K6 and K7 (d4c_spectra.cu)
_STAGES = "  const int passes = (lc + R - 1) / R;"
_DIGITS = "  for (int shift = K::kBits - 8; shift >= 0; shift -= 8) {"
_BITS = "  for (int bit = K::kBits - 1; bit >= 0; --bit) {"
_BANDS = "  for (int band = 0; band < n_ap; ++band) {"
_SCAN = "  const int per = (n_own + kThreads - 1) / kThreads;"
_WCOS = ("    const T c1 = M<T>::cos(arg);\n"
         "    wv = kBlackman ? (T(0.08) * M<T>::cos(T(2) * arg) + T(0.5) * c1) + T(0.42)")
_RADIX = "template <typename T> struct PassStages { static constexpr int value = 4; };"
_RANKS = "constexpr int kForceRanks = 0;"
_PAIR = "constexpr int kForcePair = -1;"
D4C_VARIANTS = (
    ("full", "the kernels as built", ()),
    ("no_fft", "the FFTs skipped (no butterflies, no input loads)",
     ((_STAGES, "  return;\n" + _STAGES),)),
    ("no_topk", "K7's top-k rounds skipped (digits and bits)",
     ((_DIGITS, _DIGITS.replace("shift >= 0", "shift >= K::kBits")),
      (_BITS, _BITS.replace("bit >= 0", "bit >= K::kBits")))),
    ("no_bands", "K7 without its bands (no band FFT, no top-k)",
     ((_BANDS, _BANDS.replace("band < n_ap", "band < 0")),)),
    ("no_smoothing", "K7's three smoothings' running sums cut to one entry a thread",
     ((_SCAN, "  const int per = 1;"),)),
    ("no_window_cos", "the windows without their cosines",
     ((_WCOS, "    const T c1 = arg;\n"
              "    wv = kBlackman ? (T(0.08) * arg + T(0.5) * c1) + T(0.42)"),)),
    ("k6_split_radix8", "K6's split frames three radix-2 stages a register pass in "
     "float32, not four", ((_RADIX, _RADIX.replace("value = 4", "value = 3")),)),
    ("k6_whole_radix16", "K6's whole frames four radix-2 stages a register pass "
     "at every fft_size", (("kWholeRadix16Log = 11;", "kWholeRadix16Log = 0;"),)),
    ("k6_whole_radix8", "K6's whole frames three radix-2 stages a register pass "
     "at every fft_size", (("kWholeRadix16Log = 11;", "kWholeRadix16Log = 99;"),)),
    ("k7_radix16", "K7's FFTs four radix-2 stages a register pass, not three",
     (("kBandPassStages = 3;", "kBandPassStages = 4;"),)),
    ("bit_topk", "K7's top-k one bit a round, in split frames too",
     (("kDigitSplit = true, kDigitWhole = false;",
       "kDigitSplit = false, kDigitWhole = false;"),)),
    ("digit_topk", "K7's top-k by 8-bit digits in whole frames too",
     (("kDigitSplit = true, kDigitWhole = false;",
       "kDigitSplit = true, kDigitWhole = true;"),)),
    ("no_pair", "K6's two shifts in one block, one after the other",
     ((_PAIR, "constexpr int kForcePair = 0;"),)),
    ("pair", "K6's two shifts in a pair of blocks wherever a block holds a frame",
     ((_PAIR, "constexpr int kForcePair = 1;"),)),
    ("k7_split_first", "K7 split by the occupancy rule even where one block holds a frame",
     (("constexpr bool kBandWholeFirst = true;",
       "constexpr bool kBandWholeFirst = false;"),)),
    ("ranks_1", "every frame in one block (where it fits)",
     ((_RANKS, "constexpr int kForceRanks = 1;"),)),
    ("ranks_2", "every frame split over 2 ranks",
     ((_RANKS, "constexpr int kForceRanks = 2;"),)),
    ("ranks_4", "every frame split over 4 ranks",
     ((_RANKS, "constexpr int kForceRanks = 4;"),)),
    ("ranks_8", "every frame split over 8 ranks",
     ((_RANKS, "constexpr int kForceRanks = 8;"),)),
    ("k7_6_blocks", "K7 compiled for 6 blocks an SM (at most 85 registers)",
     (("kCentroidBlocks = 8, kBandBlocks = 8;", "kCentroidBlocks = 8, kBandBlocks = 6;"),)),
    ("unbounded_registers", "both compiled for 1 block an SM (registers unbounded)",
     (("kCentroidBlocks = 8, kBandBlocks = 8;", "kCentroidBlocks = 1, kBandBlocks = 1;"),)),
    ("unpadded", "the FFT buffers without their pad words",
     (("__host__ __device__ constexpr int pad(int i) { return i + (i >> 5); }",
       "__host__ __device__ constexpr int pad(int i) { return i; }"),)),
)
# phase 22's geometries the d4c group times
D4C_GEOMETRIES = ("x16_requiem", "x16_batch4", "x16_classic_pathB", "bucket_16000",
                  "glide_60s", "48k_300_frames", "x16_requiem_fft8192",
                  "96k_classic_300_frames", "176k_requiem_300_frames",
                  "192k_classic_300_frames", "384k_classic_60_frames")
# the variants that must compute the kernels' bits (K6's and K7's, K7 on the
# centroid of the kernel as built): the same arithmetic in other passes,
# blocks or searches, and the parent's source
D4C_BITWISE = ("against", "k6_split_radix8", "k6_whole_radix16", "k6_whole_radix8",
               "k7_radix16",
               "bit_topk", "digit_topk", "no_pair", "pair")
# the source files --against may name, and the group each belongs to
AGAINST = {"extension_scan.cu": "k3", "d4c_spectra.cu": "d4c"}


def _substitute(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise ValueError(f"variant text not found in the source: {old[:60]!r}")
        src = src.replace(old, new)
    return src


GROUPS = {"k2": ("refine_dft", K2_VARIANTS), "k1": ("event_engine", K1_VARIANTS),
          "step3": ("fix_step3", STEP3_VARIANTS),
          "k3": ("extension_scan", K3_VARIANTS),
          "d4c": ("d4c_spectra", D4C_VARIANTS)}


def build_variants(build_dir: Path, groups=tuple(GROUPS), against=(), only=None):
    """Compile every variant of the groups' sources, and each source of
    ``against`` (paths) as its group's variant "against", all nvcc processes
    at once; returns {(source, name): library path}."""
    from world_tpu_torch._backend import NVCC_FLAGS, _nvcc

    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kernel, variants in (GROUPS[g] for g in groups):
        src = (CSRC / f"{kernel}.cu").read_text()
        other = next((a for a in against if a.name == f"{kernel}.cu"), None)
        if other is not None:
            variants = variants + (("against", "", ()),)
        for name, _, subs in variants:
            if only and name not in only and name not in ("full", "against"):
                continue
            cu = build_dir / f"{kernel}_{name}.cu"
            cu.write_text(other.read_text() if name == "against"
                          else _substitute(src, subs))
            so = cu.with_suffix(".so")
            jobs[(kernel, name)] = (so, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        out[key] = so
    return out


def step3_variants(libs, card):
    """K4 and K5 of every STEP3_VARIANTS library on the Harvest path's
    float32 operands at x16 and on the 60 s glide.  K5 updates its carried
    state in place, so each launch is timed with a copy of the state before
    it; the copies alone are timed too."""
    import torch

    import chip_smoke

    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fns = {}
    for name, _, _ in STEP3_VARIANTS:
        lib = ctypes.CDLL(str(libs[("fix_step3", name)]))
        k4 = lib.world_extend_chains_f32
        k4.argtypes = [P, P, P, P, P, I, I, I, I, I, D, P, P, P, P, P]
        k5 = lib.world_merge_sections_f32
        k5.argtypes = [P] * 11 + [I] * 6 + [P] * 5
        k4.restype = k5.restype = I
        fns[name] = (k4, k5)
    g = np.load(chip_smoke.GOLDEN)
    x16, fs = np.asarray(g["x16"]), int(g["fs"])
    x60 = chip_smoke.glide_signal(chip_smoke.GLIDE_FS, chip_smoke.GLIDE_SECONDS)
    geos = {"x16": chip_smoke.step3_operands(x16, fs, torch.float32),
            "60s": chip_smoke.step3_operands(x60, chip_smoke.GLIDE_FS, torch.float32)}

    def stream():
        return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())

    def ptr(a):
        return a.data_ptr() if isinstance(a, torch.Tensor) else a

    calls = {}
    for geo, (ext, mer) in geos.items():
        f0, origin, last, shift, cands, allowed, n_steps = ext[0]
        B, R = origin.shape
        outs = [torch.empty((B, R, n_steps), dtype=t, device="cuda")
                for t in (torch.int64, torch.float32, torch.bool)]
        outs.append(torch.empty((B, R), dtype=torch.int64, device="cuda"))
        k4_args = (f0, origin, last, shift, cands, B, R, cands.shape[1],
                   f0.shape[1], n_steps, float(allowed), *outs)
        args = mer[0]
        state0 = [t.clone() for t in args[11:]]
        state = [t.clone() for t in args[11:]]
        dims = (args[1].shape[0], args[1].shape[1], args[1].shape[2],
                args[3].shape[1], args[5].shape[2], args[7].shape[1])
        calls[geo] = (k4_args, args[:11], dims, state0, state)
    for geo, (ext, mer) in geos.items():
        reads = {}
        trace = chip_smoke.merge_trace(mer[0], reads)
        deciding = sum(1 for t in trace if t[2].startswith("s1"))
        print(f"fix_step3 {geo}: {len(trace)} kept steps, {deciding} deciding; "
              f"frames of the deciding overlaps {sum(t[3] for t in trace)}, "
              f"{reads['scored_frames']} of them where the row and the contour "
              f"differ (scored); frames copied {sum(t[4] for t in trace)}; {reads}")
    print(f"kernel_variants [{card}]: K4 and K5, float32, the Harvest path's "
          f"operands; mean of 20 launches, CUDA events, two rounds in turns")

    def copy_state(state, state0):
        for t, t0 in zip(state, state0):
            t.copy_(t0)

    for rnd in range(2):
        for name, what, _ in STEP3_VARIANTS:
            k4, k5 = fns[name]
            line = []
            for geo, (k4_args, k5_in, dims, state0, state) in calls.items():
                def run4():
                    err = k4(*map(ptr, k4_args), stream())
                    if err:
                        raise RuntimeError(f"K4 variant {name}: cudaError {err}")

                def run5():
                    copy_state(state, state0)
                    err = k5(*map(ptr, k5_in), *dims, *map(ptr, state), stream())
                    if err:
                        raise RuntimeError(f"K5 variant {name}: cudaError {err}")
                t4 = chip_smoke.cuda_ms(run4, iters=20) * 1e3
                t5 = chip_smoke.cuda_ms(run5, iters=20) * 1e3
                line.append(f"{geo} K4 {t4:.1f} us, K5 with its state copy {t5:.1f} us")
            print(f"variant fix_step3 {name} round {rnd}: " + "; ".join(line)
                  + f" ({what})")
    for geo, (_, _, _, state0, state) in calls.items():
        us = chip_smoke.cuda_ms(lambda: copy_state(state, state0), iters=20) * 1e3
        print(f"fix_step3 {geo}: the state copy alone {us:.1f} us [{card}]")


def k3_variants(libs, card, against=None):
    """Both scans of every K3_VARIANTS library, and of ``against`` where
    given, on DIO's float32 operands at x16, batch 4 and on the 60 s glide,
    beside how the scan splits (the heads, the largest group and the
    longest chain) and the port's own wrapper (which also pays its checks
    and allocation).  The kernel as built and ``against`` are first held
    bitwise against the plain version (run on the CPU) at every geometry
    of chip_smoke.py's phase 2, float32 and float64."""
    import torch

    import chip_smoke
    from world_tpu_torch.ops.extension_scan import (extension_scan_cuda,
                                                    extension_scan_plain)

    variants = K3_VARIANTS
    if against is not None:
        variants = (("against", f"the source at {against}", ()),) + variants
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fns = {}
    for name, _, _ in variants:
        lib = ctypes.CDLL(str(libs[("extension_scan", name)]))
        for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
            fn = getattr(lib, f"world_extension_scan_{suffix}")
            fn.argtypes = [P, P, P, P, I, I, I, I, D, P, P]
            fn.restype = I
            fns[(name, dtype)] = fn

    def stream():
        return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())

    def caller(name, a):
        """One launch of a variant on one scan's operands, into an output
        allocated once."""
        base, flags, limits, cands, allowed, backward = a
        out = torch.empty_like(base)
        fn = fns[(name, base.dtype)]
        ptrs = (base.data_ptr(), flags.data_ptr(), limits.data_ptr(),
                cands.data_ptr(), base.shape[0], cands.shape[1], base.shape[1],
                int(backward), float(allowed), out.data_ptr())

        def run():
            err = fn(*ptrs, stream())
            if err:
                raise RuntimeError(f"K3 variant {name}: cudaError {err}")
            return out
        return run

    g = np.load(chip_smoke.GOLDEN)
    x16, fs = np.asarray(g["x16"]), int(g["fs"])
    x60 = chip_smoke.glide_signal(chip_smoke.GLIDE_FS, chip_smoke.GLIDE_SECONDS)
    timed, checks = {}, 0
    for dtype in (torch.float32, torch.float64):
        geos = {"x16": chip_smoke.k3_operands(x16, fs, dtype),
                "batch4": chip_smoke.k3_operands(x16, fs, dtype, 4),
                "60s": chip_smoke.k3_operands(x60, chip_smoke.GLIDE_FS, dtype),
                "short_sections": chip_smoke.k3_short_section_operands(dtype)}
        geos.update(chip_smoke.k3_adversarial_operands(dtype))
        for geo, ops in geos.items():
            for a in ops:
                host = [t.cpu() if isinstance(t, torch.Tensor) else t for t in a]
                want = extension_scan_plain(*host)
                for name in ("full", "against")[:1 + (against is not None)]:
                    if not torch.equal(caller(name, a)().cpu(), want):
                        raise AssertionError(f"K3 {name} at {geo} ({dtype}, "
                                             f"backward {a[5]}): not bitwise "
                                             f"its plain version")
                    checks += 1
                if dtype == torch.float32 and geo in ("x16", "batch4", "60s"):
                    scan = f"{geo} {'backward' if a[5] else 'forward'}"
                    timed[scan] = a
                    print(f"extension_scan {scan} {tuple(a[0].shape)}: "
                          f"{chip_smoke.k3_groups(a, want)}")
    print(f"kernel_variants [{card}]: K3, {checks} checks bitwise against the "
          f"plain version; float32, DIO's operands; mean of 50 launches, CUDA "
          f"events, two rounds in turns (the second in reverse order)")
    def us(fn):
        return f"{chip_smoke.cuda_ms(fn, iters=50) * 1e3:.2f} us"

    for rnd, order in enumerate((variants, variants[::-1])):
        for name, what, _ in order:
            line = [f"{scan} {us(caller(name, a))}" for scan, a in timed.items()]
            print(f"variant extension_scan {name} round {rnd}: " + "; ".join(line)
                  + f" ({what})")
    line = [f"{scan} {us(lambda: extension_scan_cuda(*a))}" for scan, a in timed.items()]
    print("extension_scan_cuda, the wrapper: " + "; ".join(line) + f" [{card}]")


def d4c_variants(libs, card, against=None, only=None):
    """K6 and K7 of every D4C_VARIANTS library, and of ``against`` where
    given, on phase 22's float32 operands at D4C_GEOMETRIES, with the blocks
    each gives a frame there (a variant whose launcher refuses a geometry
    reads n/a)."""
    import torch

    import chip_smoke
    from world_tpu_torch.ops import d4c_spectra as K

    variants = tuple(v for v in D4C_VARIANTS
                     if not only or v[0] in only or v[0] == "full")
    if against is not None:
        variants = ((("against", f"the source at {against}", ()),) + variants
                    + (("against", f"the source at {against}", ()),))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fns = {}
    for name, _, _ in variants:
        lib = ctypes.CDLL(str(libs[("d4c_spectra", name)]))
        k6, k7 = lib.world_d4c_centroid_f32, lib.world_d4c_band_ap_f32
        k6.argtypes = [P, P, P, P, I, I, I, I, I, D, P, P]
        k7.argtypes = [P] * 7 + [I] * 5 + [D] + [I] * 4 + [P, P]
        k6.restype = k7.restype = I
        fns[name] = (k6, k7)
    g = np.load(chip_smoke.GOLDEN)
    geos = chip_smoke.d4c_geometries(np.asarray(g["x16"]), int(g["fs"]),
                                     np.asarray(g["f0"]), torch.float32)
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    calls = {}
    for geo in D4C_GEOMETRIES:
        a = geos[geo]()
        R, Ws = a["slab"].shape
        N, wl = a["fft_size"], a["window"].shape[0]
        bg = K.band_geometry(a["fs"], N, a["fi"], a["n_ap"], wl)
        tw = K.fft_twiddles(N, torch.float32, "cuda")
        first = torch.tensor(bg["first"], dtype=torch.int32, device="cuda")
        cen = torch.empty((R, N // 2 + 1), device="cuda")
        out = torch.empty((R, a["n_ap"]), device="cuda")
        k6_args = (a["slab"].data_ptr(), a["f0"].data_ptr(), a["t"].data_ptr(),
                   tw.data_ptr(), R, Ws, a["max_half"], a["margin"], N,
                   float(a["fs"]), cen.data_ptr(), stream)
        k7_args = (a["slab"].data_ptr(), cen.data_ptr(), a["f0"].data_ptr(),
                   a["t"].data_ptr(), tw.data_ptr(), a["window"].data_ptr(),
                   first.data_ptr(), R, Ws, a["max_half"], a["margin"], N,
                   float(a["fs"]), a["n_ap"], wl, bg["top_k"], bg["span"],
                   out.data_ptr(), stream)
        calls[geo] = (a, tw, first, cen, out, k6_args, k7_args)
        print(f"d4c geometry {geo}: {R} frames x {Ws}, fft_size {N}, {a['n_ap']} "
              f"band(s); blocks a frame as built "
              f"{K.cluster_blocks(a['fs'], N, a['max_half'], R, torch.float32)}")
    for geo, (a, tw, first, cen, out, k6_args, k7_args) in calls.items():
        def outputs(name):
            """K6's centroid, and K7's output on the kernel's centroid"""
            k6, k7 = fns[name]
            c, o = torch.full_like(cen, np.nan), torch.full_like(out, np.nan)
            if k6(*k6_args[:10], c.data_ptr(), stream) or \
                    k7(k6_args[0], cen.data_ptr(), *k7_args[2:17], o.data_ptr(),
                       stream):
                return None
            torch.cuda.synchronize()
            return c.clone(), o.clone()

        ref = outputs("full")
        cen.copy_(ref[0])
        ref = outputs("full")
        same = []
        for name in D4C_BITWISE:
            if name not in fns:
                continue
            got = outputs(name)
            same.append(f"{name} " + ("n/a" if got is None else
                                       f"K6 {torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))}, "
                                       f"K7 {torch.equal(got[1].view(torch.int32), ref[1].view(torch.int32))}"))
        print(f"d4c {geo}: bitwise the kernel as built: " + "; ".join(same))
    from world_tpu_torch._backend import _nvcc
    dump = Path(_nvcc()).parent / "cuobjdump"
    for name in dict.fromkeys(n for n, _, _ in variants):
        res = subprocess.run([str(dump), "-res-usage",
                              str(libs[("d4c_spectra", name)])],
                             capture_output=True, text=True)
        lines = res.stdout.splitlines()
        for i, line in enumerate(lines):
            if "Function" in line and "IfL" in line and i + 1 < len(lines):
                kernel = line.split("_kernel")[0].split("__")[-1][-8:] + \
                    line.split("_kernelIfL")[-1][:8]
                print(f"d4c resources {name} {kernel}: {lines[i + 1].strip()}")
    print(f"kernel_variants [{card}]: K6 and K7, float32, phase 22's operands; "
          f"mean of 20 launches, CUDA events, two rounds in turns")

    def us(fn, args):
        if fn(*args):
            return "n/a"
        return f"{chip_smoke.cuda_ms(lambda: fn(*args), iters=20) * 1e3:.1f} us"

    for rnd in range(2):
        for name, what, _ in variants:
            k6, k7 = fns[name]
            line = [f"{geo} K6 {us(k6, k6_args)}, K7 {us(k7, k7_args)}"
                    for geo, (*_, k6_args, k7_args) in calls.items()]
            print(f"variant d4c_spectra {name} round {rnd}: " + "; ".join(line)
                  + f" ({what})")


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from world_tpu_torch._backend import BUILD_DIR
    from world_tpu_torch.ops import edge_interp as E

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("groups", nargs="*")
    ap.add_argument("--against", type=Path, action="append", default=[])
    ap.add_argument("--variants", default="",
                    help="comma-separated variants of the d4c group to build and "
                         "time (all when empty; full and against always)")
    args = ap.parse_args(argv)
    if set(args.groups) - set(GROUPS):
        ap.error(f"groups are {', '.join(GROUPS)}")
    groups = tuple(args.groups) or tuple(GROUPS)
    for a in args.against:
        if AGAINST.get(a.name) not in groups:
            ap.error(f"--against {a}: another source of "
                     f"{', '.join(AGAINST)}, whose group must be named")
    against = {AGAINST[a.name]: a for a in args.against}
    if {"k1", "k2"} & set(groups):     # timed together below
        groups = tuple(dict.fromkeys(groups + ("k1", "k2")))
    card = chip_smoke.card_line()
    only = set(filter(None, args.variants.split(",")))
    libs = build_variants(BUILD_DIR / "variants", groups, args.against, only)
    if "step3" in groups:
        step3_variants(libs, card)
    if "k3" in groups:
        k3_variants(libs, card, against.get("k3"))
    if "d4c" in groups:
        d4c_variants(libs, card, against.get("d4c"), only)
    if "k1" not in groups and "k2" not in groups:
        return 0
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fns = {}
    for (kernel, name), so in libs.items():
        if kernel not in ("refine_dft", "event_engine"):
            continue
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, f"world_{kernel}_f32")
        fn.argtypes = ([P, P, P, I, I, I, I, I, P, P, D, D, D, P, P]
                       if kernel == "refine_dft" else
                       [P, I, I, P, I, I, I, D, I, I, P, P, P, P, P, P])
        fn.restype = I
        fns[(kernel, name)] = fn

    g = np.load(chip_smoke.GOLDEN)
    x16, fs = np.asarray(g["x16"]), int(g["fs"])
    o = chip_smoke.main_path_operands(x16, fs, torch.float32)
    d = chip_smoke.dio_event_operands(x16, fs, int(1000 * x16.shape[0] / fs / 5 + 1),
                                      torch.float32)

    # how many of K2's windows a frame's live slots share: one window per
    # distinct (frame, half)
    live = o["f0"] > 1e-6
    half = torch.ceil(3 * o["afs"] / torch.where(live, o["f0"], 1.0) / 2)
    half = torch.where(live, half, torch.zeros_like(half)).T       # (F, C2)
    first = torch.ones_like(live.T)
    for c in range(1, half.shape[1]):
        first[:, c] = (half[:, :c] != half[:, c:c + 1]).all(dim=1)
    windows = live.T & first
    length = 2 * torch.clamp(half, max=o["max_half"]) + 1
    print(f"K2 operands: {int(live.sum())} live slots in {live.shape[1]} frames, "
          f"{int(windows.sum())} distinct (frame, half) windows; "
          f"{int((length * live.T).sum())} slot-window samples, "
          f"{int((length * windows).sum())} window samples")

    def stream():
        return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())

    C, F = o["f0"].shape
    k2_out = torch.empty((C, F, 2), device="cuda")

    def k2_call(fn):
        err = fn(o["seg"].data_ptr(), o["phase"].data_ptr(), o["f0"].data_ptr(), C, F,
                 o["seg"].shape[1], o["max_half"], o["S"], o["table"][0].data_ptr(),
                 o["table"][1].data_ptr(), o["afs"], 71.0, 800.0, k2_out.data_ptr(),
                 stream())
        if err:
            raise RuntimeError(f"K2 variant failed to launch: cudaError {err}")

    def k1_args(ops):
        rows, tq = ops["rows"], ops["tq"]
        S, n = rows.shape
        Q = tq.shape[0]
        pnum, qden = E.stride_fraction(ops["stride"])
        lay = E.event_scratch_layout(S, n, Q, 4)
        keep = (torch.empty(lay["bytes"], dtype=torch.uint8, device="cuda"),
                torch.empty((S, Q), device="cuda"),
                torch.empty(S, dtype=torch.int32, device="cuda"))
        b = keep[0].data_ptr()
        return keep, (rows.data_ptr(), S, n, tq.data_ptr(), Q, pnum, qden, ops["afs"],
                      E.EVENT_TILE, E.crossing_capacity(n), b + lay["pos"],
                      b + lay["rank"], b + lay["tile_count"], keep[1].data_ptr(),
                      keep[2].data_ptr())

    # one scratch per geometry, shared by the variants in turn (a variant
    # that skips part of pass 1 leaves pass 2 the full kernel's results)
    (_, k1_harvest), (_, k1_dio) = k1_args(o), k1_args(d)

    def k1_call(fn, args):
        err = fn(*args, stream())
        if err:
            raise RuntimeError(f"K1 variant failed to launch: cudaError {err}")

    print(f"kernel_variants [{card}]: float32, the Harvest main path's operands; "
          f"mean of 30 launches, CUDA events, two rounds in turns")
    for rnd in range(2):
        for name, what, _ in K2_VARIANTS:
            fn = fns[("refine_dft", name)]
            us = chip_smoke.cuda_ms(lambda: k2_call(fn), iters=30) * 1e3
            print(f"variant refine_dft {name} round {rnd}: {us:.1f} us ({what})")
        for name, what, _ in K1_VARIANTS:
            fn = fns[("event_engine", name)]
            h = chip_smoke.cuda_ms(lambda: k1_call(fn, k1_harvest), iters=30) * 1e3
            dd = chip_smoke.cuda_ms(lambda: k1_call(fn, k1_dio), iters=30) * 1e3
            print(f"variant event_engine {name} round {rnd}: Harvest {h:.1f} us, "
                  f"DIO {dd:.1f} us ({what})")

    # the host's share of one K1 call at DIO's geometry, and of its parts
    args = (d["rows"], d["afs"], d["tq"], d["stride"])
    parts = (
        ("event_engine_cuda, the whole wrapper", lambda: E.event_engine_cuda(*args)),
        ("one torch.empty on the card", lambda: torch.empty(1000, device="cuda")),
        ("torch.cuda.current_stream().cuda_stream",
         lambda: torch.cuda.current_stream().cuda_stream),
        ("the raw current-stream handle launch() takes", lambda: torch._C.
         _cuda_getCurrentRawStream(torch.cuda.current_device())),
        ("the raw stream handle and the ctypes call: two launches",
         lambda: k1_call(fns[("event_engine", "full")], k1_dio)),
    )
    for what, fn in parts:
        print(f"host {what}: {chip_smoke.host_us(fn):.2f} us a call [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
