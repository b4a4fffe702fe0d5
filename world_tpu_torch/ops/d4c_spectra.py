"""K6 and K7, D4C's coarse group-delay aperiodicity: wrappers of
csrc/d4c_spectra.cu and their plain PyTorch versions.

The JAX package computes it with stock ops, batched over frames
(world_tpu/aperiodicity/common.py::static_centroid_half, :164,
smoothed_power_spectrum_half, static_group_delay_half and
coarse_aperiodicity, :176-236); it has no Pallas kernel.  In PyTorch those
stock ops are ~490 launches an analysis, each a pass over a (frames, slab
width) or (frames, fft_size) array, so on the card each half of the chain
is one kernel, one block or one thread-block cluster a frame:

  * K6, :func:`d4c_centroid`: the centroid spectrum of both window shifts,
    summed, with its low-band replica (:func:`static_centroid_half`);
  * K7, :func:`d4c_band_ap`: the smoothed power spectrum, the group delay
    and the band aperiodicity (:func:`band_ap_plain`: the inner slab through
    :func:`smoothed_power_spectrum_half`, :func:`static_group_delay_half`
    and :func:`coarse_aperiodicity`).

The kernels take every power-of-two ``fft_size`` from 16 to 32,768
(:data:`MAX_FFT_SIZE`: classic D4C to 384 kHz, D4C-Requiem to 512 kHz) in
float32 and float64.  Where a frame's buffers would crowd one block's
shared memory (K6 from ``fft_size`` 8,192, 4,096 in float64; K7 from
16,384), the launcher spreads each frame over a cluster of 2, 4 or 8 blocks
that read each other's shared memory (:func:`cluster_blocks` says how
many); the ranks' sums are added in rank order, so a launch repeats its
bits.

A CUDA tensor goes to the hand-written kernel; a CPU (or ``meta``) tensor to
the plain version, the stock ops the port ran before the kernels, unchanged.
There is no fallback from a kernel to its plain version.  Both kernels take
the FFT's twiddles from :func:`fft_twiddles` (float64 numpy, cast, kept).
"""
import ctypes

import numpy as np
import torch

from .._backend import (KernelGeometryError, LaunchCounter, check_kernel_input,
                        kernel_library, launch, rdiv)
from ..dsp.dcfill import dc_fill_add
from ..dsp.minphase import mirror_full
from ..dsp.scanops import shift_rows
from ..dsp.smoothing import rect_smooth_half, smoothing_span
from ..frames import apply_adaptive_window
from ..tables import table
from ..utils.profiling import TRACER

centroid_counter = LaunchCounter()
band_ap_counter = LaunchCounter()

# the largest fft_size the kernels take (csrc/d4c_spectra.cu's kMaxN)
MAX_FFT_SIZE = 32768


def _centroid_from_slab(slab, margin: int, fs: float, f0, t_base, t_shifted,
                        max_half: int, fft_size: int):
    """get_centroid for one shifted window set (d4c.py:132-153):
    Re(conj(S) U) with S = FFT(x), U = FFT(x * t).  t_base and t_shifted are
    float64 frame times (:func:`frame_times`)."""
    dtype, dev = slab.dtype, slab.device
    w0 = 2 * max_half + 1
    center_b = torch.floor(t_base * fs + 0.501) + 1.0
    center_s = torch.floor(t_shifted * fs + 0.501) + 1.0
    shift = torch.clamp((center_s - center_b).to(torch.int64) + margin,
                        0, 2 * margin)
    segment = shift_rows(slab, shift, w0)
    waveform, mask, _ = apply_adaptive_window(
        segment, fs, f0, t_shifted, 2.0, max_half, "blackman",
        sub_sample_shift=True)
    half = torch.floor(rdiv(2.0 * fs, f0) + 0.5)[:, None]
    base_index = torch.arange(-max_half, max_half + 1, dtype=dtype,
                              device=dev)[None, :]
    t_true = torch.where(mask, base_index + half + 1,
                         torch.zeros((), dtype=dtype, device=dev))
    xn = waveform / torch.sqrt(torch.sum(waveform ** 2, dim=1, keepdim=True))
    S = torch.fft.rfft(xn, fft_size)
    U = torch.fft.rfft(xn * t_true, fft_size)
    return S.real * U.real + S.imag * U.imag


def static_centroid_half(slab, margin, fs, f0, t_pos, max_half: int,
                         fft_size: int):
    """K6's function: the centroid spectrum (R, fft_size // 2 + 1) of
    frame slabs (R, 2 (max_half + margin) + 1), f0 (R,) and float64 frame
    times t_pos (R,)."""
    quarter = rdiv(1.0, f0) / 4
    c1 = _centroid_from_slab(slab, margin, float(fs), f0, t_pos, t_pos + quarter,
                             max_half, fft_size)
    c2 = _centroid_from_slab(slab, margin, float(fs), f0, t_pos, t_pos - quarter,
                             max_half, fft_size)
    return dc_fill_add(c1 + c2, f0, float(fs), fft_size, boundary_factor=1.2,
                       KL=256)


def smoothed_power_spectrum_half(seg, fs, f0, t_pos, max_half: int,
                                 fft_size: int):
    waveform, _, _ = apply_adaptive_window(
        seg, float(fs), f0, t_pos, 2.0, max_half, "hanning",
        sub_sample_shift=True)
    power = torch.abs(torch.fft.rfft(waveform, fft_size)) ** 2
    power = dc_fill_add(power, f0, float(fs), fft_size, boundary_factor=1.2,
                        KL=256)
    return rect_smooth_half(mirror_full(power), f0, float(fs), fft_size)


def static_group_delay_half(centroid_half, smoothed_power_half, fs, f0,
                            fft_size: int):
    """T_D(w) (d4c.py:165-174) on half bins.  A scale-relative floor on the
    divisor guards against a smoothed power that rounds to zero (inactive in
    float64).  The JAX package also clips the float32 group delay, to keep
    its float32 running sums from cancelling; the smoothing here sums in
    float64, and the clip is left out: the group delay reaches ~1e7 on
    speech (16 kHz golden utterance), and clipping it moved the band
    aperiodicity by 5.7 dB."""
    dtype = centroid_half.dtype
    eps = torch.finfo(dtype).eps
    floor = torch.mean(torch.abs(smoothed_power_half), dim=-1,
                       keepdim=True) * eps * eps
    den = torch.where(torch.abs(smoothed_power_half) < floor, floor,
                      smoothed_power_half)
    gd = centroid_half / den
    gd = rect_smooth_half(mirror_full(gd), f0 / 2, float(fs), fft_size)
    gd_s = rect_smooth_half(mirror_full(gd), f0, float(fs), fft_size)
    return gd - gd_s


def coarse_aperiodicity(group_delay_half, fs: float, fft_size: int,
                        frequency_interval: float, n_ap: int,
                        window: torch.Tensor):
    """Per-band aperiodicity from the group delay (d4c.py:192-209): the
    share of power outside the (boundary+1) largest bins, in dB.
    ``window``: :func:`band_window_table`."""
    dtype = group_delay_half.dtype
    wlen = window.shape[0]
    geo = band_geometry(fs, fft_size, frequency_interval, n_ap, wlen)
    gd_full = mirror_full(group_delay_half)
    seg = torch.stack([gd_full[..., lo:lo + 2 * (wlen // 2) + 1]
                       for lo in geo["first"]], dim=-2) * window
    power = torch.abs(torch.fft.rfft(seg, fft_size)) ** 2
    den = power.sum(dim=-1)
    num = den - largest_bins(power, geo["top_k"]).sum(dim=-1)
    tiny = torch.finfo(dtype).tiny
    return -10.0 * torch.log10((num + tiny) / (den + tiny))


def largest_bins(power: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest values of each row of ``power``, largest first (a
    function of its own so that tools/profile_d4c_ct_torch.py times it)."""
    return torch.topk(power, k, dim=-1, sorted=True).values


def band_ap_plain(slab, margin: int, centroid, fs, f0, t, max_half: int,
                  fft_size: int, frequency_interval: float, n_ap: int,
                  window: torch.Tensor):
    """K7's function: the band aperiodicity (R, n_ap) in dB of the slabs'
    inner 2 max_half + 1 columns, from K6's ``centroid``."""
    seg = slab[:, margin:slab.shape[1] - margin]
    spsh = smoothed_power_spectrum_half(seg, fs, f0, t, max_half, fft_size)
    gd = static_group_delay_half(centroid, spsh, fs, f0, fft_size)
    return coarse_aperiodicity(gd, float(fs), fft_size, frequency_interval,
                               n_ap, window)


def fft_twiddles(fft_size: int, dtype: torch.dtype, device) -> torch.Tensor:
    """(fft_size // 2, 2): cos and sin of -2 pi m / fft_size, computed in
    float64 and cast to ``dtype``; kept."""
    def build():
        theta = (-2.0 * np.pi) * np.arange(fft_size // 2, dtype=np.float64) / fft_size
        return np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    return table("d4c_twiddles", (int(fft_size),), build, dtype, device)


def band_geometry(fs, fft_size: int, frequency_interval: float, n_ap: int,
                  wl: int) -> dict:
    """The bands of a geometry, for :func:`coarse_aperiodicity` and K7: the
    largest bins kept (boundary + 1), the smoothing's span
    (:func:`..dsp.smoothing.rect_smooth_half`) and each band's first bin of
    the mirrored group delay (its centre less wl // 2)."""
    fs = float(fs)
    hw = wl // 2
    return {"top_k": int(fft_size / wl * 8 + 0.5) + 1,
            "span": smoothing_span(fs, fft_size),
            "first": [int(np.floor(frequency_interval * (i + 1)
                                   / (fs / fft_size))) - hw
                      for i in range(n_ap)]}


def _check_geometry(name, slab, margin, max_half, fft_size, extra=""):
    Ws = slab.shape[1]
    N = int(fft_size)
    if (N & (N - 1) or not 16 <= N <= MAX_FFT_SIZE or margin < 0
            or Ws != 2 * (max_half + margin) + 1):
        raise KernelGeometryError(
            f"{name}: slab {tuple(slab.shape)}, margin {margin}, max_half "
            f"{max_half}, fft_size {N}{extra}: the kernel takes a power of two "
            f"fft_size in [16, {MAX_FFT_SIZE}] and slabs of 2 (max_half + "
            f"margin) + 1 columns")


def _check_rows(name, slab, f0, t, dev):
    dtype = slab.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: unsupported dtype {dtype}")
    check_kernel_input(slab, "slab", dtype, dev, 2)
    check_kernel_input(f0, "f0", dtype, dev, 1)
    check_kernel_input(t, "t", torch.float64, dev, 1)
    R = slab.shape[0]
    if f0.shape != (R,) or t.shape != (R,):
        raise ValueError(f"{name}: shapes slab {tuple(slab.shape)}, f0 "
                         f"{tuple(f0.shape)}, t {tuple(t.shape)}")


@TRACER.spanned("world.kernel.K6")
def centroid_cuda(slab, margin: int, fs, f0, t, max_half: int, fft_size: int):
    """Launch K6: :func:`static_centroid_half`'s output, one launch."""
    dev, dtype = slab.device, slab.dtype
    _check_geometry("d4c_centroid", slab, margin, max_half, fft_size)
    _check_rows("d4c_centroid", slab, f0, t, dev)
    R, Ws = slab.shape
    tw = fft_twiddles(fft_size, dtype, dev)
    out = torch.empty((R, fft_size // 2 + 1), dtype=dtype, device=dev)
    try:
        launch("d4c_centroid", dtype, slab.data_ptr(), f0.data_ptr(),
               t.data_ptr(), tw.data_ptr(), R, Ws, int(max_half), int(margin),
               int(fft_size), float(fs), out.data_ptr())
    except KernelGeometryError as e:
        raise KernelGeometryError(
            f"d4c_centroid: slab {tuple(slab.shape)} in {dtype} at fft_size "
            f"{fft_size} needs more shared memory or blocks than the device "
            f"allows ({e})") from e
    centroid_counter.add()
    return out


@TRACER.spanned("world.kernel.K7")
def band_ap_cuda(slab, margin: int, centroid, fs, f0, t, max_half: int,
                 fft_size: int, frequency_interval: float, n_ap: int,
                 window: torch.Tensor):
    """Launch K7: :func:`band_ap_plain`'s output (R, n_ap), one launch."""
    dev, dtype = slab.device, slab.dtype
    R, Ws = slab.shape
    N, wl = int(fft_size), window.shape[0]
    geo = band_geometry(fs, N, frequency_interval, n_ap, wl)
    extra = (f", {n_ap} bands of {wl} bins from {geo['first']}, top "
             f"{geo['top_k']}, span {geo['span']}")
    _check_geometry("d4c_band_ap", slab, margin, max_half, N, extra)
    if (n_ap < 1 or wl > N or not 1 <= geo["top_k"] <= N // 2 + 1
            or 2 * geo["span"] + 2 >= N
            or any(lo < 0 or lo + 2 * (wl // 2) > N - 1 for lo in geo["first"])):
        raise KernelGeometryError(f"d4c_band_ap: slab {tuple(slab.shape)}, "
                                  f"fft_size {N}{extra}: outside the kernel's "
                                  f"geometry")
    _check_rows("d4c_band_ap", slab, f0, t, dev)
    check_kernel_input(centroid, "centroid", dtype, dev, 2)
    check_kernel_input(window, "window", dtype, dev, 1)
    if centroid.shape != (R, N // 2 + 1):
        raise ValueError(f"d4c_band_ap: centroid {tuple(centroid.shape)} for "
                         f"slab {tuple(slab.shape)} at fft_size {N}")
    tw = fft_twiddles(N, dtype, dev)
    first = table("d4c_band_first", (float(fs), N, float(frequency_interval),
                                     int(n_ap), int(wl)),
                  lambda: geo["first"], torch.int32, dev)
    out = torch.empty((R, n_ap), dtype=dtype, device=dev)
    try:
        launch("d4c_band_ap", dtype, slab.data_ptr(), centroid.data_ptr(),
               f0.data_ptr(), t.data_ptr(), tw.data_ptr(), window.data_ptr(),
               first.data_ptr(), R, Ws, int(max_half), int(margin), N,
               float(fs), int(n_ap), int(wl), geo["top_k"], geo["span"],
               out.data_ptr())
    except KernelGeometryError as e:
        raise KernelGeometryError(
            f"d4c_band_ap: slab {tuple(slab.shape)} in {dtype} at fft_size {N}"
            f"{extra} needs more shared memory or blocks than the device "
            f"allows ({e})") from e
    band_ap_counter.add()
    return out


def cluster_blocks(fs, fft_size: int, max_half: int, rows: int,
                   dtype: torch.dtype) -> dict:
    """The blocks each kernel gives a frame for ``rows`` frames at
    ``fft_size`` (the launchers' choice, csrc/d4c_spectra.cu): {"d4c_centroid":
    C, or "pair" (its two shifts in two blocks), "d4c_band_ap": C}; 0 where
    the geometry does not fit."""
    lib, _ = kernel_library()
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    k6, k7 = ctypes.c_int(), ctypes.c_int()
    err = getattr(lib, f"world_d4c_clusters_{suffix}")(
        int(fft_size), int(max_half), smoothing_span(float(fs), int(fft_size)),
        int(rows), ctypes.byref(k6), ctypes.byref(k7))
    if err:
        raise KernelGeometryError(f"d4c cluster_blocks: fft_size {fft_size} at "
                                  f"{fs} Hz: cudaError {err}")
    return {"d4c_centroid": "pair" if k6.value == -2 else k6.value,
            "d4c_band_ap": k7.value}


def d4c_centroid(slab, margin: int, fs, f0, t, max_half: int, fft_size: int):
    """D4C's centroid spectrum (R, fft_size // 2 + 1): K6 on the card,
    :func:`static_centroid_half` on the CPU."""
    fn = centroid_cuda if slab.is_cuda else static_centroid_half
    return fn(slab, margin, fs, f0, t, max_half, fft_size)


def d4c_band_ap(slab, margin: int, centroid, fs, f0, t, max_half: int,
                fft_size: int, frequency_interval: float, n_ap: int,
                window: torch.Tensor):
    """D4C's band aperiodicity (R, n_ap) in dB: K7 on the card,
    :func:`band_ap_plain` on the CPU."""
    fn = band_ap_cuda if slab.is_cuda else band_ap_plain
    return fn(slab, margin, centroid, fs, f0, t, max_half, fft_size,
              frequency_interval, n_ap, window)
