"""Rank-select and row shifts (what the main path uses of world_tpu/dsp/scanops.py).

The JAX package replaces gathers with compare-reduce and radix-select tricks
because TPU gathers serialize; here they are plain ``torch.searchsorted``
and ``gather``.  Every select copies values exactly.
"""
import torch


def compact_rows(values: torch.Tensor, keep: torch.Tensor, k: int):
    """The first ``k`` kept entries of each row, in order, zero-filled.

    values, keep: (..., N).  Returns (compacted (..., k), rank (..., N)) with
    ``rank`` the inclusive running count of kept entries (1-based rank of a
    kept entry)."""
    n = values.shape[-1]
    rank = torch.cumsum(keep.to(torch.int64), dim=-1)
    q = torch.arange(1, k + 1, device=values.device, dtype=torch.int64)
    q = q.expand(rank.shape[:-1] + (k,)).contiguous()
    pos = torch.searchsorted(rank.contiguous(), q)
    valid = q <= rank[..., -1:]
    picked = torch.gather(values, -1, pos.clamp(max=n - 1))
    return torch.where(valid, picked, torch.zeros_like(picked)), rank


def shift_rows(slab: torch.Tensor, shift: torch.Tensor, width: int) -> torch.Tensor:
    """out[r, j] = slab[r, shift[r] + j] for j < width; reads past the end of
    a row give 0."""
    n = slab.shape[-1]
    idx = shift.to(torch.int64)[:, None] + torch.arange(
        width, device=slab.device)[None, :]
    got = torch.gather(slab, -1, idx.clamp(max=n - 1))
    return torch.where(idx < n, got, torch.zeros_like(got))


def running_sum(t: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(t, dim=-1)`` summed in a fixed order on every device.
    On the card PyTorch scans a tensor that is a single row with CUB's
    decoupled look-back, whose floating-point sums follow the order in which
    its blocks finish: past one tile a row's bits change from run to run.
    Two or more rows take the row-wise scan, whose order is fixed, so a
    single row is scanned beside a copy of itself.  On the CPU both scans
    are sequential and give the same bits."""
    if t.numel() != t.shape[-1]:
        return torch.cumsum(t, dim=-1)
    row = t.reshape(1, -1)
    return torch.cumsum(row.expand(2, -1), dim=-1)[0].reshape(t.shape)
