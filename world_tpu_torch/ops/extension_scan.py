"""K3, DIO's extension scans: wrapper of csrc/extension_scan.cu.

The JAX package runs FixStep3 and FixStep4 as two ``jax.lax.scan``s over
the frames (world_tpu/f0/dio.py::_fix_step3 :153-180, ::_fix_step4
:183-207); it has no Pallas kernel for them.  In PyTorch a scan is a Python
loop of about twenty launches a frame, so on the card it is this kernel: one
launch a scan, whatever the number of frames and sections.  A CUDA tensor
goes to the hand-written kernel; a CPU tensor to the plain PyTorch version,
:func:`extension_scan_plain`, the scan's body one frame a step, vectorised
over rows.  There is no fallback from the kernel to the plain version.
"""
import torch

from .._backend import (F64_EPS, KernelGeometryError, LaunchCounter,
                        check_kernel_input, launch)

counter = LaunchCounter()


def select_best_f0(current_f0, past_f0, candidates, allowed_range: float):
    """select_best_f0 (dio.py:297-310) for K rows: the candidate nearest the
    linear prediction (the first of equal errors), 0 when its relative
    error exceeds allowed_range.  current_f0, past_f0 (K,); candidates
    (K, C)."""
    reference = (current_f0 * 3 - past_f0) / 2
    errors = torch.abs(reference[:, None] - candidates)
    best = torch.gather(candidates, 1, torch.argmin(errors, dim=1)[:, None])[:, 0]
    ok = torch.abs(1 - best / (reference + F64_EPS)) <= allowed_range
    return torch.where(ok, best, torch.zeros_like(best))


def extension_scan_plain(base: torch.Tensor, flags: torch.Tensor,
                         limits: torch.Tensor, cands: torch.Tensor,
                         allowed_range: float, backward: bool = False):
    """The scan of FixStep3 (forward) or FixStep4 (backward) over rows.

    base (B, n) is the contour the scan passes through; flags (B, n) bool
    marks the frames that start an extension (the sections' ends forward,
    their starts backward) and limits (B, n) int64 holds, at those frames,
    the limit the extension runs to; cands (B, C, n).  The carry (prev1,
    prev2, active, limit) goes through the frames in order (last to first
    when backward): a frame inside an active extension (p <= limit forward,
    p >= limit - 1 backward) takes :func:`select_best_f0` of the two values
    before it and stays active while that is not 0; every other frame keeps
    its base value; a flagged frame activates the extension and sets its
    limit.  Returns the scanned contour (B, n)."""
    B, n = base.shape
    dev = base.device
    out = torch.empty_like(base)
    prev1 = prev2 = torch.zeros(B, dtype=base.dtype, device=dev)
    active = torch.zeros(B, dtype=torch.bool, device=dev)
    limit = torch.zeros(B, dtype=torch.int64, device=dev)
    by_frame = cands.transpose(1, 2)                         # (B, n, C)
    for p in (range(n - 1, -1, -1) if backward else range(n)):
        in_ext = active & ((limit - 1 <= p) if backward else (limit >= p))
        ext = select_best_f0(prev1, prev2, by_frame[:, p], allowed_range)
        val = torch.where(in_ext, ext, base[:, p])
        active = (in_ext & (ext != 0)) | flags[:, p]
        limit = torch.where(flags[:, p], limits[:, p], limit)
        prev2, prev1 = prev1, val
        out[:, p] = val
    return out


def extension_scan_cuda(base: torch.Tensor, flags: torch.Tensor,
                        limits: torch.Tensor, cands: torch.Tensor,
                        allowed_range: float, backward: bool = False):
    """Launch the CUDA extension scan: the scanned contour (B, n)."""
    dev = base.device
    check_kernel_input(base, "base", base.dtype, dev, 2)
    if base.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"extension scan: unsupported dtype {base.dtype}")
    check_kernel_input(flags, "flags", torch.bool, dev, 2)
    check_kernel_input(limits, "limits", torch.int64, dev, 2)
    check_kernel_input(cands, "cands", base.dtype, dev, 3)
    B, n = base.shape
    C = cands.shape[1]
    if (flags.shape != base.shape or limits.shape != base.shape
            or cands.shape != (B, C, n) or C < 1 or n < 1 or B < 1):
        raise ValueError(f"extension scan: shapes base {tuple(base.shape)}, "
                         f"flags {tuple(flags.shape)}, limits "
                         f"{tuple(limits.shape)}, cands {tuple(cands.shape)}")
    out = torch.empty_like(base)
    try:
        launch("extension_scan", base.dtype, base.data_ptr(), flags.data_ptr(),
               limits.data_ptr(), cands.data_ptr(), B, C, n, int(backward),
               float(allowed_range), out.data_ptr())
    except KernelGeometryError as e:
        raise ValueError(f"extension scan: {C} candidates a frame do not fit "
                         f"a tile of 32 frames in shared memory ({e})") from e
    counter.add()
    return out


def extension_scan(base: torch.Tensor, flags: torch.Tensor,
                   limits: torch.Tensor, cands: torch.Tensor,
                   allowed_range: float, backward: bool = False):
    """FixStep3's (forward) or FixStep4's (backward) scan of rows base
    (B, n): :func:`extension_scan_plain`'s function, by the kernel on the
    card."""
    if base.is_cuda:
        return extension_scan_cuda(base, flags, limits, cands, allowed_range,
                                   backward)
    return extension_scan_plain(base, flags, limits, cands, allowed_range,
                                backward)
