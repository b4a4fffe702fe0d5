"""Fixed-shape framing (world_tpu/frames.py): per-frame signal slabs on the
uniform frame grid and the F0-adaptive analysis windows.

The JAX package cuts the slabs with strided patch extraction (TPU gathers
serialize); here a slab is one ``gather`` at integer indices computed on the
device in exact integer arithmetic (nothing is uploaded).  Index clamping
equals the reference's min/max clamp.
"""
from fractions import Fraction

import numpy as np
import torch

from ._backend import rdiv, sdiv
from .utils.profiling import TRACER


def frame_centers(fs: float, frame_period_s: float, n_frames: int,
                  first: int, device) -> torch.Tensor:
    """1-based anchor sample (int64 on ``device``) of each of the
    ``n_frames`` frames from frame ``first``, floor(t_q*fs + 0.501) + 1, in
    exact integer arithmetic on the rational grid t_q*fs = q*pnum/qden."""
    frac = Fraction(fs * frame_period_s).limit_denominator(1000)
    pnum, qden = frac.numerator, frac.denominator
    q = torch.arange(first, first + n_frames, dtype=torch.int64, device=device)
    return torch.div(1000 * pnum * q + 501 * qden, 1000 * qden,
                     rounding_mode="floor") + 1


def uniform_frame_period_ms(temporal_positions: np.ndarray):
    """Frame period in ms if temporal_positions is the uniform grid
    arange * fp / 1000, else None."""
    tp = np.asarray(temporal_positions)
    if tp.ndim != 1 or tp.shape[0] < 3:
        return None
    fp_ms = float(tp[1] - tp[0]) * 1000.0
    if fp_ms <= 0:
        return None
    grid = np.arange(tp.shape[0]) * fp_ms / 1000.0
    return fp_ms if np.allclose(tp, grid, rtol=0, atol=1e-9) else None


def host(a) -> np.ndarray:
    """``a`` (a tensor, an array or a sequence) as a numpy array.  A
    tensor's read is counted as a host sync, with its bytes."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    TRACER.count("host.syncs")
    TRACER.count("bytes.d2h", a.nbytes)
    with TRACER.span("world.host.read"):
        return a.detach().cpu().numpy()


def host_flag(t: torch.Tensor) -> bool:
    """``bool(t)`` of a one-element tensor, counted as a host sync."""
    TRACER.count("host.syncs")
    TRACER.count("bytes.d2h", t.element_size())
    with TRACER.span("world.host.flag"):
        return bool(t)


def upload(a, dtype: torch.dtype, device) -> torch.Tensor:
    """``a`` (an array or a sequence) as a tensor of ``dtype`` on
    ``device``, its bytes counted as copied from the host."""
    t = torch.tensor(np.asarray(a), dtype=dtype, device=device)
    TRACER.count("bytes.h2d", t.nbytes)
    return t


def like(x: torch.Tensor, a) -> torch.Tensor:
    """``a`` (a tensor, an array or a sequence) as a tensor of x's type on
    x's device."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=x.dtype, device=x.device)
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=x.dtype,
                        device=x.device)


def gather_trunc_1based(x: torch.Tensor, index_1based: torch.Tensor) -> torch.Tensor:
    """x[b, int(min(n, max(1, idx[b, ...]))) - 1] for rows x (B, n) and
    float indices (B, ...): clamp, then truncate (the reference's
    astype(int) of a half-offset float index)."""
    B, n = x.shape
    safe = torch.clamp(index_1based, 1, n).to(torch.int64) - 1
    return torch.gather(x, 1, safe.reshape(B, -1)).reshape(safe.shape)


def uniform_centered_slabs(x: torch.Tensor, fs: float, frame_period_s: float,
                           n_frames: int, max_half: int,
                           offset: int = 0, first: int = 0) -> torch.Tensor:
    """(..., n_frames, 2*max_half+1) slabs of the frames from frame
    ``first``: slab[..., q, j] =
    x[..., clip(center_q - 1 - max_half + offset + j, 0, n-1)] for rows x
    (..., n)."""
    n = x.shape[-1]
    centers = frame_centers(fs, frame_period_s, n_frames, first, x.device)
    idx = (centers[:, None] + (offset - 1 - max_half)
           + torch.arange(2 * max_half + 1, device=x.device)[None, :])
    return x[..., idx.clamp(0, n - 1)]


def adaptive_window_values(time_axis: torch.Tensor, f0: torch.Tensor,
                           window_type: str) -> torch.Tensor:
    """Hann or Blackman values at time_axis * f0 (cos, correctly rounded)."""
    arg = torch.pi * time_axis * f0
    c1 = torch.cos(arg)
    if window_type == "hanning":
        return 0.5 * c1 + 0.5
    if window_type != "blackman":
        raise ValueError(window_type)
    return 0.08 * torch.cos(2 * arg) + 0.5 * c1 + 0.42


def apply_adaptive_window(segment: torch.Tensor, fs: float, f0: torch.Tensor,
                          temporal_position: torch.Tensor, half_length: float,
                          max_half: int, window_type: str,
                          sub_sample_shift: bool,
                          normalize_window: bool = False):
    """F0-adaptive windowing and weighted-mean removal of segments
    (F, 2*max_half+1) aligned to base_index = -max_half..max_half.
    Returns (waveform, mask, window).

    The sub-sample shift is the distance from the frame time to the nearest
    sample, ``t fs - round(t fs)``, taken in ``temporal_position``'s own
    type: D4C passes its frame times in float64, since at a minute of audio
    a float32 ``t fs`` is a tenth of a sample off."""
    dtype, dev = segment.dtype, segment.device
    f0 = f0[:, None]
    t = temporal_position[:, None]
    half = torch.floor(rdiv(half_length * fs, f0) + 0.5)
    base_index = torch.arange(-max_half, max_half + 1, dtype=dtype,
                              device=dev)[None, :]
    mask = torch.abs(base_index) <= half
    zero = torch.zeros((), dtype=dtype, device=dev)
    segment = segment * mask
    if sub_sample_shift:
        frac = sdiv(t * fs - torch.floor(t * fs + 0.5), fs).to(dtype)
        time_axis = sdiv(sdiv(base_index, fs), half_length) + frac
    else:
        time_axis = sdiv(sdiv(base_index, fs), half_length).expand(mask.shape)
    window = torch.where(mask, adaptive_window_values(time_axis, f0, window_type),
                         zero)
    if normalize_window:
        window = window / torch.sqrt(torch.sum(window ** 2, dim=1, keepdim=True))
    sw = segment * window
    waveform = sw - window * (torch.sum(sw, dim=1, keepdim=True)
                              / torch.sum(window, dim=1, keepdim=True))
    return torch.where(mask, waveform, zero), mask, window
