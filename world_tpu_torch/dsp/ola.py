"""Overlap-add (world_tpu/dsp/ola.py).

The JAX package avoids scatter-adds, which serialize on a TPU; here the
irregularly spaced pulses go through ``index_add_`` and the uniform frame
grid keeps the shift-and-fold form, whose summation order is fixed.
"""
import torch
import torch.nn.functional as F


def uniform_ola(resp: torch.Tensor, start0: int, hop: int,
                y_length: int) -> torch.Tensor:
    """Overlap-add of resp (F, W) at starts start0 + f*hop; parts outside
    [0, y_length) are dropped.  Chunk c of frame f lands in output block
    f + c, added in chunk order."""
    Fr, W = resp.shape
    n_chunks = -(-W // hop)
    r = F.pad(resp, (0, n_chunks * hop - W))
    blocks = torch.zeros((Fr + n_chunks, hop), dtype=resp.dtype,
                         device=resp.device)
    for c in range(n_chunks):
        blocks[c:c + Fr] += r[:, c * hop:(c + 1) * hop]
    flat = blocks.reshape(-1)
    out = torch.zeros(y_length, dtype=resp.dtype, device=resp.device)
    lo = max(0, start0)
    src_lo = lo - start0
    n = min(y_length - lo, flat.shape[0] - src_lo)
    if n > 0:
        out[lo:lo + n] = flat[src_lo:src_lo + n]
    return out


def scatter_ola(resp: torch.Tensor, starts: torch.Tensor,
                y_length: int) -> torch.Tensor:
    """y[starts[p] + j] += resp[p, j] for every in-range sample.  Rows whose
    start lies past the end contribute nothing."""
    W = resp.shape[1]
    idx = starts.to(torch.int64)[:, None] + torch.arange(W, device=resp.device)
    ok = (idx >= 0) & (idx < y_length)
    out = torch.zeros(y_length, dtype=resp.dtype, device=resp.device)
    return out.index_add_(0, idx[ok], resp[ok])
