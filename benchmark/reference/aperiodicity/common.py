"""D4C machinery shared by classic D4C and D4C-Requiem
(world_tpu/aperiodicity/common.py), batched over frames: every function
takes (R, ...) rows of frames."""
import math

import numpy as np
import torch

from ..dsp.windows import np_nuttall
from ..frames import apply_adaptive_window, uniform_centered_slabs
from ..ops.d4c_spectra import d4c_band_ap, d4c_centroid
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
    centroid = d4c_centroid(slab, margin, fs, f0, t_pos, max_half, fft_size)
    return d4c_band_ap(slab, margin, centroid, fs, f0, t_pos, max_half,
                       fft_size, frequency_interval, n_ap, window)
