"""D4C-Requiem band aperiodicity (port of world_tpu/aperiodicity/d4c_requiem.py)."""
import numpy as np
import torch

from .._backend import sdiv
from ..frames import host, like, uniform_frame_period_ms
from .common import (band_window_table, coarse_ap_frames, frame_slabs,
                    frame_times, love_train_fft_size, love_train_vuv)


def requiem_fft_size(fs: int) -> int:
    return int(2 ** np.ceil(np.log2(3 * fs / 47 + 1)))


def n_bands_ap(fs: int, frequency_interval: float = 3000.0) -> int:
    return int(np.floor(min(15000, fs / 2 - frequency_interval)
                        / frequency_interval))


def d4c_requiem_core(x: torch.Tensor, fs: int, f0_seq: torch.Tensor,
                     temporal_positions: torch.Tensor, fft_size: int,
                     threshold: float, frequency_interval: float, n_ap: int,
                     frame_period_ms) -> torch.Tensor:
    """Coarse band aperiodicity (B, n_frames, n_ap+2) in dB for rows x
    (B, n) and f0 (B, n_frames), on the uniform frame grid of
    ``frame_period_ms`` or, when that is None, at ``temporal_positions``."""
    B, n_frames = f0_seq.shape
    dtype = x.dtype
    f0_low_limit = 47.0
    window = band_window_table(fs, fft_size, frequency_interval, dtype,
                               x.device)
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
    coarse = coarse_ap_frames(x, fs, current_f0, t, frequency_interval,
                              fft_size, n_ap, window, max_half, frame_period_ms,
                              temporal_positions)
    mid = -torch.clamp(coarse - sdiv((current_f0[:, None] - 100.0) * 2.0, 100.0),
                       min=0.0)
    top = torch.full((mid.shape[0], 1), -60.0, dtype=dtype, device=x.device)
    bot = torch.full((mid.shape[0], 1), -0.000000000001, dtype=dtype,
                     device=x.device)
    band_ap = torch.cat([top, mid, bot], dim=1)
    # unvoiced frames: the whole column is -1e-12 (d4cRequiem.py:33-34)
    band_ap = torch.where(vuv_lt[:, None], band_ap, bot)
    return band_ap.reshape(B, n_frames, n_ap + 2)


def d4c_requiem(x: torch.Tensor, fs: int, f0_object: dict,
                threshold: float = 0.85, fft_size: int = None) -> dict:
    """Coarse band aperiodicity of one utterance x (n,) (API of
    world_tpu.aperiodicity.d4c_requiem.d4c_requiem): the source dict with
    f0 zeroed where unvoiced and "aperiodicity" (n_ap + 2, frames) in dB.
    The frame grid may be any ascending one."""
    fs = int(fs)
    if fft_size is None:
        fft_size = requiem_fft_size(fs)
    n_ap = n_bands_ap(fs)
    assert n_ap > 0
    tp = np.asarray(host(f0_object["temporal_positions"]), dtype=np.float64)
    f0 = like(x, f0_object["f0"])
    f0 = torch.where(like(x, f0_object["vuv"]) == 0, torch.zeros_like(f0), f0)
    band_ap = d4c_requiem_core(x[None], fs, f0[None],
                               torch.as_tensor(tp, device=x.device),
                               int(fft_size), float(threshold), 3000.0, n_ap,
                               uniform_frame_period_ms(tp))
    out = dict(f0_object)
    out["f0"] = f0
    out["aperiodicity"] = band_ap[0].T
    return out
