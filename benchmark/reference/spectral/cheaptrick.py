"""CheapTrick spectral envelope (port of world_tpu/spectral/cheaptrick.py),
batched over frames: F0-adaptive Hann window -> power spectrum + low-band
mirror fill -> rectangular smoothing -> cepstral liftering."""
import math

import numpy as np
import torch

from .._backend import F64_EPS, rdiv, sdiv
from ..aperiodicity.common import frame_slabs
from ..dsp.dcfill import dc_fill_add
from ..dsp.minphase import mirror_full
from ..dsp.smoothing import rect_smooth_half
from ..frames import (apply_adaptive_window, host as _host, like as _like,
                      uniform_frame_period_ms)
from ..tables import frame_grid, table


def default_fft_size(fs: int) -> int:
    return int(2 ** math.ceil(math.log2(3 * fs / 71 + 1)))


def _power_spectrum_with_dc_fill(waveform_padded, shift, fs, fft_size, f0):
    """|FFT|^2 with the low-frequency mirror fill, plus the pitch-synchronous
    complex spectrum.  The window sits at ``shift`` in its zero-padded slab;
    in the spectrum that is a phase ramp, and the power needs no shift."""
    dtype = waveform_padded.dtype
    spec0 = torch.fft.fft(waveform_padded[:, :fft_size], fft_size)
    k_idx = torch.arange(fft_size, dtype=dtype, device=spec0.device)[None, :]
    theta = ((2 * np.pi / fft_size) * shift[:, None].to(dtype)) * k_idx
    ps_spectrum = spec0 * torch.polar(torch.ones_like(theta), theta)
    power_half = torch.abs(spec0[:, :fft_size // 2 + 1]) ** 2
    power_filled = dc_fill_add(power_half, f0, fs, fft_size,
                               boundary_factor=1.0, KL=128)
    return power_filled, ps_spectrum


def _linear_smoothing(power_full, f0, fs, fft_size: int):
    smoothed = rect_smooth_half(power_full, (2.0 / 3.0) * f0, fs, fft_size)
    # the reference's guard adds float64 eps whatever the working type:
    # float32's eps (1.2e-7) is of the order of a speech spectrum's high
    # bins and measured 2.6 dB of log-spectral distance on the 16 kHz
    # golden utterance.  The floor catches a difference of running sums that
    # dips below zero.
    eps = torch.finfo(power_full.dtype).eps
    floor = torch.mean(power_full, dim=-1, keepdim=True) * eps * eps
    return torch.maximum(smoothed + F64_EPS, floor)


def _smoothing_with_recovery(smoothed_full, f0, fs, fft_size: int, q1: float):
    """Cepstral liftering (cheaptrick.py:136-157)."""
    dtype, dev = smoothed_full.dtype, smoothed_full.device
    q = sdiv(torch.arange(fft_size, dtype=dtype, device=dev), fs)
    is0 = q == 0
    pfq = math.pi * f0[:, None] * q
    sl = torch.where(is0, torch.ones((), dtype=dtype, device=dev),
                     torch.sin(pfq) / (pfq + is0.to(dtype)))
    cl = (1 - 2 * q1) + 2 * q1 * torch.cos(2 * math.pi * q * f0[:, None])
    idx = np.arange(fft_size)
    sym = table("cheaptrick_sym", (fft_size,),
                lambda: np.where(idx > fft_size // 2, fft_size - idx, idx),
                torch.int64, dev)
    sl = sl[:, sym]
    cl = cl[:, sym]
    cep = torch.fft.fft(torch.log(smoothed_full))
    env = torch.exp(torch.fft.ifft(cep * sl * cl).real)
    return env[:, :fft_size // 2 + 1]


def cheaptrick_core(x: torch.Tensor, fs: int, f0_seq: torch.Tensor,
                    fft_size: int, q1: float, frame_period_ms,
                    temporal_positions: torch.Tensor = None):
    """Envelope (B, n_frames, fft//2+1), pitch-synchronous spectrum
    (B, n_frames, fft) and effective f0 (B, n_frames) for rows x (B, n) and
    f0 (B, n_frames), on the uniform frame grid of ``frame_period_ms`` or,
    when that is None, at ``temporal_positions`` (n_frames,)."""
    B, n_frames = f0_seq.shape
    dtype = x.dtype
    f0_low_limit = fs * 3.0 / (fft_size - 3.0)
    f0_eff = torch.where(f0_seq < f0_low_limit,
                         torch.full((), 500.0, dtype=dtype, device=x.device),
                         f0_seq)
    f0 = f0_eff.reshape(-1)
    if frame_period_ms is not None:
        temporal_positions = frame_grid(n_frames, frame_period_ms, x.device)
    tp = temporal_positions.to(dtype).repeat(B)
    max_half = (fft_size - 2) // 2
    seg = frame_slabs(x, fs, frame_period_ms, n_frames, max_half,
                      temporal_positions)
    waveform, _, _ = apply_adaptive_window(
        seg, float(fs), f0, tp, 1.5, max_half, "hanning",
        sub_sample_shift=False, normalize_window=True)
    half = torch.floor(rdiv(1.5 * fs, f0) + 0.5).to(torch.int64)
    shift = max_half - half
    power_half, ps_spec = _power_spectrum_with_dc_fill(waveform, shift,
                                                       float(fs), fft_size, f0)
    smoothed = _linear_smoothing(mirror_full(power_half), f0, float(fs),
                                 fft_size)
    env = _smoothing_with_recovery(mirror_full(smoothed), f0, float(fs),
                                   fft_size, q1)
    return (env.reshape(B, n_frames, -1), ps_spec.reshape(B, n_frames, -1),
            f0_eff)


def cheaptrick(x: torch.Tensor, fs: int, source_object: dict, q1: float = -0.15,
               fft_size: int = None) -> dict:
    """Spectral envelope of one utterance x (n,) (API of
    world_tpu.spectral.cheaptrick.cheaptrick) on any ascending frame grid:
    "spectrogram" (fft//2+1, frames), the complex "ps spectrogram"
    (fft, frames) and "f0_effective" (frames,), the contour with unvoiced
    frames and frames below the window's floor raised to 500 Hz.  The
    source dict is not changed."""
    fs = int(fs)
    if fft_size is None:
        fft_size = default_fft_size(fs)
    tp_np = np.asarray(_host(source_object["temporal_positions"]), dtype=np.float64)
    f0 = _like(x, source_object["f0"])
    vuv = _like(x, source_object["vuv"])
    f0 = torch.where(vuv == 0, torch.full_like(f0, 500.0), f0)
    env, ps_spec, f0_eff = cheaptrick_core(
        x[None], fs, f0[None], int(fft_size), float(q1),
        uniform_frame_period_ms(tp_np),
        torch.as_tensor(tp_np, device=x.device))
    return {"temporal_positions": source_object["temporal_positions"],
            "spectrogram": env[0].T, "fs": fs, "ps spectrogram": ps_spec[0].T,
            "f0_effective": f0_eff[0]}
