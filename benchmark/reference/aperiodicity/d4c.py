"""Classic D4C aperiodicity (port of world_tpu/aperiodicity/d4c.py):
the coarse band aperiodicity of D4C-Requiem's group-delay pipeline at
D4C's own DFT size, interpolated to the spectrum's bins as linear
amplitude."""
import numpy as np
import torch

from .._backend import sdiv
from ..frames import host, like, uniform_frame_period_ms
from ..tables import table
from .common import (band_window_table, coarse_ap_frames, d4c_fft_size,
                    frame_slabs, frame_times, love_train_fft_size,
                    love_train_vuv)


def frequency_interval(fs: int) -> float:
    return 2000.0 if fs < 16000 else 3000.0


def n_bands(fs: int) -> int:
    fi = frequency_interval(fs)
    return int(np.floor(min(15000, fs / 2 - fi) / fi))


def band_to_bin_weights(fs: int, n_ap: int, freq_interval: float,
                        fft_size_for_spectrum: int):
    """Host float64 lerp of the (n_ap + 2) band anchors (0 Hz, every
    band's upper edge, fs/2) onto the spectrum's bins: the left anchor of
    each bin and its weight (d4c.py:58-59)."""
    kmax = fft_size_for_spectrum // 2 + 1
    freq = np.arange(kmax, dtype=np.float64) * fs / fft_size_for_spectrum
    axis = np.r_[np.arange(n_ap + 1) * freq_interval, fs / 2.0]
    j = np.clip(np.searchsorted(axis, freq, side="right") - 1, 0, n_ap)
    return j, (freq - axis[j]) / (axis[j + 1] - axis[j])


def d4c_core(x: torch.Tensor, fs: int, f0_seq: torch.Tensor,
             temporal_positions: torch.Tensor, fft_size: int,
             fft_size_for_spectrum: int, threshold: float,
             freq_interval: float, n_ap: int, frame_period_ms):
    """D4C for rows x (B, n) and f0 (B, F), on the uniform frame grid of
    ``frame_period_ms`` or, when that is None, at ``temporal_positions``.

    Returns the aperiodicity (B, F, fft_size_for_spectrum//2 + 1) as linear
    amplitude, the coarse band aperiodicity (B, F, n_ap) in dB and the
    effective f0 (B, F)."""
    B, n_frames = f0_seq.shape
    dtype, dev = x.dtype, x.device
    f0_low_limit = 47.0
    window = band_window_table(fs, fft_size, freq_interval, dtype, dev)
    max_half_lt = int(1.5 * fs / 40.0 + 0.5)
    max_half = int(2.0 * fs / f0_low_limit + 0.5)
    fft_lt = love_train_fft_size(fs)
    f0 = f0_seq.reshape(-1)
    t = frame_times(frame_period_ms, n_frames, temporal_positions,
                    x.device).repeat(B)

    seg_lt = frame_slabs(x, fs, frame_period_ms, n_frames, max_half_lt,
                         temporal_positions)
    vuv_lt = love_train_vuv(seg_lt, fs, f0, t, threshold, max_half_lt, fft_lt)

    current_f0 = torch.clamp(f0, min=f0_low_limit)
    coarse = coarse_ap_frames(x, fs, current_f0, t, freq_interval, fft_size,
                              n_ap, window, max_half, frame_period_ms,
                              temporal_positions)
    coarse = torch.clamp(coarse - sdiv((current_f0[:, None] - 100.0) * 2.0, 100.0),
                         min=0.0)
    zero = torch.zeros((), dtype=dtype, device=dev)
    coarse = torch.where(vuv_lt[:, None], coarse, zero)

    rows = coarse.shape[0]
    vals = torch.cat([torch.full((rows, 1), -60.0, dtype=dtype, device=dev),
                      -coarse,
                      torch.full((rows, 1), -0.000000000001, dtype=dtype,
                                 device=dev)], dim=1)
    key = (int(fs), int(n_ap), float(freq_interval), int(fft_size_for_spectrum))
    j = table("d4c_band_to_bin_index", key,
              lambda: band_to_bin_weights(*key)[0], torch.int64, dev)
    w = table("d4c_band_to_bin_weight", key,
              lambda: band_to_bin_weights(*key)[1], dtype, dev)
    y0, y1 = vals[:, j], vals[:, j + 1]
    ap_db = y0 + (y1 - y0) * w
    aperiodicity = 10.0 ** sdiv(ap_db, 20.0)
    aperiodicity = torch.where(vuv_lt[:, None], aperiodicity,
                               torch.full((), 1.0 - 0.000000000001, dtype=dtype,
                                          device=dev))
    f0_eff = torch.where(f0_seq == 0, torch.zeros_like(f0_seq), f0_seq)
    coarse_ap = -coarse * vuv_lt[:, None].to(dtype)
    return (aperiodicity.reshape(B, n_frames, -1),
            coarse_ap.reshape(B, n_frames, n_ap), f0_eff)


def d4c(x: torch.Tensor, fs: int, f0_object: dict, threshold: float = 0.85,
        fft_size_for_spectrum: int = None) -> dict:
    """Aperiodicity of one utterance x (n,) (API of
    world_tpu.aperiodicity.d4c.d4c): the source dict with f0 zeroed where
    unvoiced, "aperiodicity" (bins, frames) and "coarse_ap" (n_ap, frames).
    The frame grid may be any ascending one."""
    fs = int(fs)
    if fft_size_for_spectrum is None:
        fft_size_for_spectrum = int(2 ** np.ceil(np.log2(3 * fs / 71 + 1)))
    tp = np.asarray(host(f0_object["temporal_positions"]), dtype=np.float64)
    f0 = like(x, f0_object["f0"])
    f0 = torch.where(like(x, f0_object["vuv"]) == 0, torch.zeros_like(f0), f0)
    ap, coarse, f0_eff = d4c_core(
        x[None], fs, f0[None], torch.as_tensor(tp, device=x.device),
        d4c_fft_size(fs), int(fft_size_for_spectrum), float(threshold),
        frequency_interval(fs), n_bands(fs), uniform_frame_period_ms(tp))
    out = dict(f0_object)
    out["f0"] = f0_eff[0]
    out["aperiodicity"] = ap[0].T
    out["coarse_ap"] = coarse[0].T
    return out
