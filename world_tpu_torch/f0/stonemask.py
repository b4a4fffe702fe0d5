"""StoneMask F0 refinement (port of world_tpu/f0/stonemask.py): the
instantaneous frequency at the harmonic DFT bins of each frame.

The reference takes two FFTs of a data-dependent size per frame and reads
2 (pass 1) then 6 (pass 2) bins.  Here each bin is a dot product of the
windowed segment with that bin's DFT vector, for all frames at once.  The
angle of sample n at bin b of a size-fft_size DFT is reduced exactly,
(b*n) mod fft_size, and its cosine and sine are read from a table built on
the host in float64 for the largest fft_size: every fft_size is a power of
two dividing it.
"""
import math

import numpy as np
import torch

from .._backend import F64_EPS, rdiv, sdiv
from ..dsp.rounding import matlab_round_half, round_matlab
from ..frames import gather_trunc_1based
from ..ops import prod_diff
from ..ops.refine_dft import dft_table
from .. import tables


def max_half_window(fs: int, f0_floor: float) -> int:
    return int(math.ceil(3 * fs / f0_floor / 2))


def table_size(max_half: int) -> int:
    """The DFT size of a window of max_half: the largest fft_size of any
    frame whose f0 is at or above the floor max_half was made for."""
    return int(2 ** (math.ceil(math.log2(2 * max_half + 1)) + 1))


def base_times(fs: float, max_half: int) -> np.ndarray:
    """The window's sample offsets in seconds, rounded to 4 decimals
    (stonemask.py:38), in host float64.  The reference rounds with
    "{:.4f}".format; the JAX package's compiled program computes
    round(b * ((1/fs) * 1e4)) * 1e-4 (XLA turns its divisions by constants
    into products by their reciprocals).  Many offsets lie on a tie, which
    the two resolve differently; this is the JAX package's form."""
    b = np.arange(-max_half, max_half + 1, dtype=np.float64)
    return np.round(b * ((1.0 / fs) * 1e4)) * 1e-4


def _harmonic_pass(seg_main, seg_diff, f0_est, trim, fft_size, fs: float,
                   table):
    """One instantaneous-frequency pass (stonemask.py:52-76) over the bins
    round(f0_est * fft_size / fs * trim); seg_* (R, W), f0_est and fft_size
    (R,), trim (K,).  Returns the amplitude-weighted f0 (R,)."""
    cos_tab, sin_tab = table
    S = cos_tab.shape[0]
    W = seg_main.shape[-1]
    bins = round_matlab(sdiv(f0_est * fft_size, fs)[:, None] * trim[None, :])
    n_i = torch.arange(W, device=seg_main.device)
    size_i = fft_size.to(torch.int64)[:, None, None]
    m = (bins.to(torch.int64)[:, :, None] * n_i) % size_i        # (R, K, W)
    m = m * (S // size_i)
    cb, sb = cos_tab[m], sin_tab[m]
    re_s = (cb * seg_main[:, None, :]).sum(-1)
    im_s = (sb * seg_main[:, None, :]).sum(-1)
    re_d = (cb * seg_diff[:, None, :]).sum(-1)
    im_d = (sb * seg_diff[:, None, :]).sum(-1)
    numerator = prod_diff(re_s, im_d, im_s, re_d)
    power = torch.clamp(re_s ** 2 + im_s ** 2, min=F64_EPS)
    fx = bins / fft_size[:, None] * fs
    inst_freq = fx + sdiv(numerator / power * fs / 2, math.pi)
    amp = torch.sqrt(power)
    return (amp * inst_freq).sum(-1) / (amp * trim[None, :]).sum(-1)


def stonemask_core(x: torch.Tensor, fs: int, temporal_positions: torch.Tensor,
                   f0: torch.Tensor, max_half: int, table=None) -> torch.Tensor:
    """Refined f0 (B, F) for rows x (B, n) and f0 (B, F) on the frame times
    temporal_positions (F,); frames with f0 == 0 read 0.

    Voiced f0 must be at or above the floor max_half was made for
    (:func:`max_half_window`), as DIO's are.  ``table`` is
    :func:`dft_table` of :func:`table_size` (computed when None)."""
    B, n_frames = f0.shape
    dtype, dev = x.dtype, x.device
    fs_f = float(fs)
    S = table_size(max_half)
    if table is None:
        table = dft_table(S, dtype, dev)
    voiced = f0 != 0
    # unvoiced frames are refined at the floor's f0 and zeroed at the end
    f0_safe = torch.where(voiced, f0, torch.full_like(f0, 3 * fs_f / (2 * max_half)))
    current = f0_safe.reshape(-1)
    # The window's geometry is computed in float64 whatever the working type:
    # in float32 the frame time t (up to seconds) leaves ~5e-7 s of rounding
    # in window_time, 1e-5 of a window, and the windows feed the 20%
    # keep/reject threshold.  Float64 runs are unchanged.
    geo = torch.float64
    t = temporal_positions.to(geo).repeat(B)
    half = torch.ceil(rdiv(3 * fs_f, current.to(geo)) / 2)
    wlt = sdiv(2 * half + 1, fs_f)
    fft_size = torch.clamp(2.0 ** (torch.ceil(torch.log2(half * 2 + 1)) + 1),
                           max=float(S))

    base_index = torch.arange(-max_half, max_half + 1, dtype=geo, device=dev)
    mask = torch.abs(base_index)[None, :] <= half[:, None]
    base_time = tables.table("stonemask_base_time", (fs_f, int(max_half)),
                             lambda: base_times(fs_f, max_half), geo, dev)
    index_raw = matlab_round_half((t[:, None] + base_time[None, :]) * fs_f)
    window_time = sdiv(index_raw - 1, fs_f) - t[:, None]
    w1 = (2 * math.pi) * window_time / wlt[:, None]
    w2 = (4 * math.pi) * window_time / wlt[:, None]
    zero = torch.zeros((), dtype=geo, device=dev)
    main_window = torch.where(mask, 0.42 + 0.5 * torch.cos(w1)
                              + 0.08 * torch.cos(w2), zero)
    w_pad = torch.nn.functional.pad(main_window, (1, 1))
    diff_window = torch.where(mask, -(w_pad[:, 2:] - w_pad[:, :-2]) / 2, zero)

    seg = gather_trunc_1based(x, index_raw.reshape(B, n_frames, -1))
    seg = seg.reshape(B * n_frames, -1) * mask
    seg_main = seg * main_window.to(dtype)
    seg_diff = seg * diff_window.to(dtype)
    fft_size = fft_size.to(dtype)
    zero = zero.to(dtype)

    trim2 = torch.arange(1, 3, dtype=dtype, device=dev)
    trim6 = torch.arange(1, 7, dtype=dtype, device=dev)
    f0_pass1 = _harmonic_pass(seg_main, seg_diff, current, trim2, fft_size, fs_f,
                              table)
    f0_pass2 = _harmonic_pass(seg_main, seg_diff, f0_pass1, trim6, fft_size,
                              fs_f, table)
    refined = torch.where(f0_pass1 < 0, zero, f0_pass2)
    keep = torch.abs(refined - current) / torch.clamp(current, min=F64_EPS) > 0.2
    refined = torch.where(keep, current, refined).reshape(B, n_frames)
    return torch.where(voiced, refined, torch.zeros_like(refined))


def stonemask(x: torch.Tensor, fs: int, temporal_positions: torch.Tensor,
              f0: torch.Tensor, f0_floor: float = 71.0) -> torch.Tensor:
    """Refine an F0 contour (n_frames,) of one utterance x (n,) by
    instantaneous frequency (stonemask.py:8-27)."""
    voiced = f0[f0 != 0]
    if voiced.numel() and float(voiced.min()) < f0_floor:
        raise ValueError(f"stonemask: voiced f0 {float(voiced.min()):.3f} Hz "
                         f"lies below f0_floor={f0_floor}")
    return stonemask_core(x[None], int(fs), temporal_positions, f0[None],
                          max_half_window(fs, f0_floor))[0]
