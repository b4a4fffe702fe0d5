"""K2, Harvest refinement (GetRefinedF0): wrapper of csrc/refine_dft.cu and
its plain PyTorch version.

Replaces world_tpu/ops/refine_dft.py::_refine_pallas (Pallas kernel
``_kernel`` / ``_kernel_body``), whose spec is ``refine_full_xla``.  Every
per-candidate fft_size is a power of two dividing S, so bin ``b`` of a
size-fft_size DFT is bin K = b * S / fft_size of one size-S DFT.  Both
versions compute only the <= 6 harmonic bins of each pair, reading the basis
from an S-entry cos/sin table built on the host in float64 at (K*n) mod S.

A CUDA tensor goes to the kernel, a CPU tensor to :func:`refine_plain`;
there is no fallback between them.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from .._backend import (KernelGeometryError, LaunchCounter,
                        check_kernel_input, launch, rdiv, sdiv)
from ..utils.profiling import TRACER
from . import prod_diff


counter = LaunchCounter()

_PLAIN_CHUNK = 4096     # pairs per step of the plain version (bounds memory)


def dft_table(S: int, dtype: torch.dtype, device) -> tuple:
    """(cos, sin) of the angle -2*pi*m/S for m < S, computed in float64."""
    theta = (-2.0 * np.pi) * np.arange(S, dtype=np.float64) / S
    return (torch.as_tensor(np.cos(theta), dtype=dtype, device=device),
            torch.as_tensor(np.sin(theta), dtype=dtype, device=device))


def _refine_pairs(seg, phase, f0, actual_fs, max_half, S, f0_floor, f0_ceil,
                  cos_tab, sin_tab):
    """GetRefinedF0 for P pairs: seg, phase (P, W) rows, f0 (P,)."""
    dtype, dev = seg.dtype, seg.device
    W = seg.shape[1]
    pi = math.pi
    half = torch.ceil(rdiv(3 * actual_fs, f0) / 2)
    wlt = sdiv(2 * half + 1, actual_fs)
    base_abs = torch.abs(torch.arange(W, device=dev, dtype=dtype) - max_half)
    mask = base_abs[None, :] <= half[:, None]
    common = pi * phase / wlt[:, None]
    c2 = torch.cos(2 * common)
    c4 = torch.cos(4 * common)
    zero = torch.zeros((), dtype=dtype, device=dev)
    mw = torch.where(mask, 0.42 + 0.5 * c2 + 0.08 * c4, zero)
    right = F.pad(mw[:, 1:], (0, 1))
    left = F.pad(mw[:, :-1], (1, 0))
    dw = torch.where(mask, -(right - left) / 2, zero)
    xm = seg * mw
    xd = seg * dw

    fft_size = 2.0 ** torch.ceil(torch.log2(half * 2 + 1) + 1)
    harmonics = torch.arange(1, 7, device=dev).to(dtype)
    n_harm = torch.clamp(torch.floor(rdiv(actual_fs / 2, f0)), max=6.0)
    hmask = harmonics[None, :] <= n_harm[:, None]
    bins = torch.trunc(sdiv(f0 * fft_size, actual_fs)[:, None] * harmonics
                       + 0.5)
    K = torch.clamp(bins * rdiv(float(S), fft_size)[:, None], 0, S // 2)
    m = (K.to(torch.int64)[:, :, None]
         * torch.arange(W, device=dev)[None, None, :]) % S       # (P, 6, W)
    cb, sb = cos_tab[m], sin_tab[m]
    re_s = (xm[:, None, :] * cb).sum(-1)
    im_s = (xm[:, None, :] * sb).sum(-1)
    re_d = (xd[:, None, :] * cb).sum(-1)
    im_d = (xd[:, None, :] * sb).sum(-1)

    tiny = torch.finfo(dtype).tiny
    numerator = prod_diff(re_s, im_d, im_s, re_d)
    power = re_s * re_s + im_s * im_s
    inst = (bins / fft_size[:, None]
            + sdiv(numerator / torch.clamp(power, min=tiny) / 2, pi)) * actual_fs
    amp = torch.sqrt(power) * hmask
    num_acc = torch.zeros_like(f0)
    den_acc = torch.zeros_like(f0)
    var_acc = torch.zeros_like(f0)
    for h in range(6):     # harmonic order, as the CUDA kernel sums
        num_acc = num_acc + amp[:, h] * inst[:, h]
        den_acc = den_acc + amp[:, h] * (h + 1.0)
        var = torch.abs((sdiv(inst[:, h], h + 1.0) - f0) / f0)
        var_acc = var_acc + torch.where(hmask[:, h], var, zero)
    refined = num_acc / torch.clamp(den_acc, min=tiny)
    score = rdiv(1.0, 1e-12 + var_acc / torch.clamp(n_harm, min=1.0))
    ok = ((refined >= f0_floor) & (refined <= f0_ceil) & (score >= 2.5)
          & (f0 > 1e-6))
    return torch.where(ok, refined, zero), torch.where(ok, score, zero)


def refine_plain(seg, phase, f0, actual_fs: float, max_half: int, S: int,
                 f0_floor: float, f0_ceil: float, table=None):
    """Plain K2: (refined f0, score), each (C, F), for seg/phase (F, W) and
    candidate f0 (C, F).  Only non-empty slots (f0 > 1e-6) are evaluated;
    the others are (0, 0), as the gate makes them.  ``table`` is the
    (cos, sin) pair of :func:`dft_table` (computed when None)."""
    cos_tab, sin_tab = table if table is not None else dft_table(
        S, seg.dtype, seg.device)
    refined = torch.zeros_like(f0)
    score = torch.zeros_like(f0)
    cs, fs_idx = (f0 > 1e-6).nonzero(as_tuple=True)
    for lo in range(0, cs.shape[0], _PLAIN_CHUNK):
        c = cs[lo:lo + _PLAIN_CHUNK]
        fr = fs_idx[lo:lo + _PLAIN_CHUNK]
        r, s = _refine_pairs(seg[fr], phase[fr], f0[c, fr], actual_fs,
                             max_half, S, f0_floor, f0_ceil, cos_tab, sin_tab)
        refined[c, fr] = r
        score[c, fr] = s
    return refined, score


@TRACER.spanned("world.kernel.K2")
def refine_cuda(seg, phase, f0, actual_fs: float, max_half: int, S: int,
                f0_floor: float, f0_ceil: float, table=None):
    """Launch the CUDA refinement kernel: (refined f0, score), each (C, F)."""
    dev, dtype = seg.device, seg.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"refine_dft: unsupported dtype {dtype}")
    check_kernel_input(seg, "seg", dtype, dev, 2)
    check_kernel_input(phase, "phase", dtype, dev, 2)
    check_kernel_input(f0, "f0", dtype, dev, 2)
    Fr, W = seg.shape
    C = f0.shape[0]
    if phase.shape != seg.shape or f0.shape[1] != Fr or W != 2 * max_half + 1:
        raise ValueError(f"refine_dft: shapes seg {tuple(seg.shape)}, phase "
                         f"{tuple(phase.shape)}, f0 {tuple(f0.shape)}, "
                         f"max_half {max_half}")
    if S & (S - 1):
        raise ValueError(f"refine_dft: S={S} is not a power of two")
    cos_tab, sin_tab = table if table is not None else dft_table(S, dtype, dev)
    check_kernel_input(cos_tab, "cos_tab", dtype, dev, 1)
    check_kernel_input(sin_tab, "sin_tab", dtype, dev, 1)
    if cos_tab.shape[0] != S or sin_tab.shape[0] != S:
        raise ValueError(f"refine_dft: DFT table length != S={S}")
    out = torch.empty((C, Fr, 2), dtype=dtype, device=dev)
    try:
        launch("refine_dft", dtype, seg.data_ptr(), phase.data_ptr(),
               f0.data_ptr(), C, Fr, W, max_half, S, cos_tab.data_ptr(),
               sin_tab.data_ptr(), float(actual_fs), float(f0_floor),
               float(f0_ceil), out.data_ptr())
    except KernelGeometryError as e:
        raise ValueError(
            f"refine_dft: the geometry (C, F, W, S) = ({C}, {Fr}, {W}, {S}) in "
            f"{dtype} needs more shared memory a block than the device "
            f"allows: the DFT table (S) and the window (W = 2 max_half + 1) "
            f"grow as f0_floor falls ({e})") from e
    counter.add()
    return out[..., 0], out[..., 1]


def refine_full(seg, phase, f0, actual_fs: float, max_half: int, S: int,
                f0_floor: float, f0_ceil: float, table=None):
    """(refined f0, score) (C, F) for every (candidate, frame) pair."""
    fn = refine_cuda if seg.is_cuda else refine_plain
    return fn(seg, phase, f0, actual_fs, max_half, S, f0_floor, f0_ceil,
              table)
