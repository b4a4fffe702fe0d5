"""D4C machinery shared by classic D4C and D4C-Requiem
(world_tpu/aperiodicity/common.py), batched over frames: every function
takes (R, ...) rows of frames."""
import math

import numpy as np
import torch

from .._backend import rdiv, sdiv
from ..dsp.dcfill import dc_fill_add
from ..dsp.minphase import mirror_full
from ..dsp.scanops import shift_rows
from ..dsp.windows import np_nuttall
from ..frames import apply_adaptive_window, uniform_centered_slabs
from ..tables import frame_grid, table


def frame_slabs(x: torch.Tensor, fs: float, frame_period_ms, n_frames: int,
                max_half: int, temporal_positions: torch.Tensor = None) -> torch.Tensor:
    """Per-frame slabs of rows x (B, n), flattened to (B*n_frames, 2*max_half+1).
    On the uniform grid (``frame_period_ms`` given) the anchors come from
    exact integer arithmetic; on any other grid (``frame_period_ms`` None)
    from ``temporal_positions`` (n_frames,), as floor(t*fs + 0.501) + 1
    evaluated in float64."""
    if frame_period_ms is not None:
        slab = uniform_centered_slabs(x, float(fs), frame_period_ms / 1000.0,
                                      n_frames, max_half)
    else:
        center = torch.floor(temporal_positions.double() * float(fs) + 0.501) + 1.0
        base = torch.arange(-max_half, max_half + 1, device=x.device)
        idx = torch.clamp(center.to(torch.int64)[:, None] + base, 1, x.shape[-1]) - 1
        slab = x[..., idx]
    return slab.reshape(-1, slab.shape[-1])


def frame_times(frame_period_ms, n_frames: int,
                temporal_positions: torch.Tensor, device) -> torch.Tensor:
    """The (n_frames,) frame times in float64, whatever the working type:
    the exact grid q * frame_period_ms / 1000 when it is uniform, else
    ``temporal_positions``.  D4C centres its windows at floor(t fs + 0.501)
    and shifts them by t fs - round(t fs); in float32 t fs carries 0.06-0.125
    sample at a minute of audio, which measured 1.54 dB of band aperiodicity
    on a 60 s glide (0.10 dB at 4.6 s)."""
    if frame_period_ms is not None:
        return frame_grid(n_frames, frame_period_ms, device)
    return temporal_positions.double()


def d4c_fft_size(fs: int) -> int:
    return int(2 ** np.ceil(np.log2(4 * fs / 47 + 1)))


def love_train_fft_size(fs: int) -> int:
    return int(2 ** np.ceil(np.log2(3 * fs / 40 + 1)))


def rect_smooth_half(signal_full: torch.Tensor, width: torch.Tensor, fs: float,
                     fft_size: int, max_width_hz: float = 4000.0) -> torch.Tensor:
    """Rectangular smoothing of an even full spectrum: the difference of
    its running sum read at +-width/2 around each bin, over width.  The
    read offsets are constant along the bin axis, so each read is a per-row
    fractional shift.  Returns (R, fft_size//2+1).

    The running sum and its differences are kept in float64: in float32 the
    difference of two running sums loses eps * (total power) against a
    local band 60-80 dB below the spectrum's peak, which measured 3 dB of
    log-spectral distance on the 16 kHz golden utterance."""
    out_dtype = signal_full.dtype
    df = fs / fft_size
    width = (width[:, None] if width.dim() == 1 else width).double()
    signal_full = signal_full.double()
    double_spectrum = torch.cat([signal_full, signal_full], dim=-1)
    cs = torch.cumsum(double_spectrum * df, dim=-1)
    x0 = -fs + df / 2
    nb = fft_size // 2 + 1
    span = int(np.ceil(max_width_hz / 2 / df)) + 2
    center = fft_size           # alpha at width 0: (0 - x0)/df = fft_size - 1/2
    window = cs[:, center - span:]

    def read(alpha):
        m = torch.floor(alpha)
        frac = alpha - m
        sh = torch.clamp(m.to(torch.int64) - (center - span), 0, 2 * span)[:, 0]
        v = shift_rows(window, sh, nb + 1)
        return v[:, :nb] * (1 - frac) + v[:, 1:nb + 1] * frac

    a_lo = sdiv(-width / 2 - x0, df)
    a_hi = sdiv(width / 2 - x0, df)
    return ((read(a_hi) - read(a_lo)) / width).to(out_dtype)


def love_train_vuv(seg: torch.Tensor, fs: int, f0: torch.Tensor,
                   temporal_positions: torch.Tensor, threshold: float,
                   max_half: int, fft_size_lt: int) -> torch.Tensor:
    """'Love Train' VUV decision per frame (d4c.py:68-88) from frame slabs
    seg (R, 2*max_half+1)."""
    df = fs / fft_size_lt
    b0 = int(np.ceil(100 / df) + 1)
    b1 = int(np.ceil(4000 / df) + 1)
    b2 = int(np.ceil(7900 / df) + 1)
    f0_c = torch.clamp(f0, min=40.0)
    waveform, _, _ = apply_adaptive_window(
        seg, float(fs), f0_c, temporal_positions, 1.5, max_half, "blackman",
        sub_sample_shift=True)
    power = torch.abs(torch.fft.rfft(waveform, fft_size_lt)) ** 2
    s1 = power[:, b0:b1].sum(dim=1)
    s2 = s1 + power[:, b1:b2].sum(dim=1)
    return ((s1 / s2) > threshold) & (f0 != 0)


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
    boundary = int(fft_size / wlen * 8 + 0.5)
    hw = wlen // 2
    gd_full = mirror_full(group_delay_half)
    segs = []
    for i in range(n_ap):
        center = int(np.floor(frequency_interval * (i + 1) / (fs / fft_size)))
        segs.append(gd_full[..., center - hw:center + hw + 1])
    seg = torch.stack(segs, dim=-2) * window
    power = torch.abs(torch.fft.rfft(seg, fft_size)) ** 2
    den = power.sum(dim=-1)
    num = den - largest_bins(power, boundary + 1).sum(dim=-1)
    tiny = torch.finfo(dtype).tiny
    return -10.0 * torch.log10((num + tiny) / (den + tiny))


def largest_bins(power: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest values of each row of ``power``, largest first (a
    function of its own so that tools/profile_d4c_ct_torch.py times it)."""
    return torch.topk(power, k, dim=-1, sorted=True).values


def band_window(fs: int, fft_size: int, frequency_interval: float) -> np.ndarray:
    wl = int(math.floor(frequency_interval / (fs / fft_size)) * 2 + 1)
    return np_nuttall(wl)


def band_window_table(fs: int, fft_size: int, frequency_interval: float,
                      dtype: torch.dtype, device) -> torch.Tensor:
    """:func:`band_window` as a tensor on ``device``, kept."""
    return table("band_window", (int(fs), int(fft_size),
                                 float(frequency_interval)),
                 lambda: band_window(fs, fft_size, frequency_interval), dtype,
                 device)


def coarse_ap_frames(x: torch.Tensor, fs: int, f0: torch.Tensor,
                     t_pos: torch.Tensor, frequency_interval: float,
                     fft_size: int, n_ap: int, window: torch.Tensor,
                     max_half: int, frame_period_ms,
                     temporal_positions: torch.Tensor = None) -> torch.Tensor:
    """estimate_one_slice (d4c.py:114-128) for every frame of rows x (B, n):
    the band aperiodicity (B*F, n_ap) in dB from the group delay, for f0 and
    t_pos (B*F,).  The frame grid is uniform (``frame_period_ms``) or given
    by ``temporal_positions`` (F,) (see :func:`frame_slabs`)."""
    n_frames = f0.shape[0] // x.shape[0]
    margin = int(np.ceil(fs / (4 * 47.0))) + 3
    slab = frame_slabs(x, fs, frame_period_ms, n_frames, max_half + margin,
                       temporal_positions)
    centroid = static_centroid_half(slab, margin, fs, f0, t_pos, max_half,
                                    fft_size)
    seg = slab[:, margin:slab.shape[1] - margin]
    spsh = smoothed_power_spectrum_half(seg, fs, f0, t_pos, max_half, fft_size)
    gd = static_group_delay_half(centroid, spsh, fs, f0, fft_size)
    return coarse_aperiodicity(gd, float(fs), fft_size, frequency_interval,
                               n_ap, window)
