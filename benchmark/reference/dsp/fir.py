"""FIR filtering as direct (im2col + GEMM) convolution (world_tpu/dsp/fir.py).

cuDNN is bypassed for these convolutions: its algorithm choice (FFT,
Winograd, TF32 tensor cores) would change the rounding of the band-filtered
signals whose zero crossings Harvest times.  PyTorch's own path lowers a
convolution to im2col + a full-precision GEMM, the same sum of products as
the JAX package's im2col matmul.

Long signals: the unfolded columns of a convolution hold L values per output
sample, and the bank's output holds one per band and sample.  Past a budget
of bytes (:data:`.._backend.STAGE_BYTES_BUDGET`) the bank runs in blocks of
output samples (overlap-save: a block of ``block`` outputs reads
``block + L - 1`` inputs, so every output is still one dot product over the
same L taps) and the callers run it a chunk of bands at a time.
"""
import threading

import torch
import torch.nn.functional as F

from .._backend import STAGE_BYTES_BUDGET, chunk_size

# what the band stage holds alive per (row, band, sample), in items: the
# bank's output at the bands' offsets, the four event rows made from it, K1's
# crossing scratch (half a row for each event row) and one temporary.  A
# count, not a measurement: on an NVIDIA H100 the stage of 38 bands of one
# 441,000-sample float32 row peaked at 1.62 times it, set by the bank's
# unfolded columns (bank_bytes_per_sample counts those), inside the budget
# the chunk was cut for (chip_smoke.py phase 14 prints both).
BAND_STAGE_COPIES = 8


# cudnn.flags sets and restores a switch of the whole process: two threads
# (one per device) inside it at once could restore it under each other
_CUDNN_SWITCH = threading.Lock()


def _conv_valid(xp: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """out[r, b, t] = sum_j taps[b, j] * xp[r, t + L-1 - j] (valid part)."""
    weight = torch.flip(taps, dims=(-1,)).unsqueeze(1)        # (B, 1, L)
    with _CUDNN_SWITCH, torch.backends.cudnn.flags(enabled=False):
        return F.conv1d(xp.unsqueeze(1), weight)


def fir_bank_full(y: torch.Tensor, bank: torch.Tensor,
                  block: int = None) -> torch.Tensor:
    """Full linear convolution of every row of ``y`` (R, n) with every row
    of ``bank`` (B, L): out[r, b, k] = sum_j bank[b, j] * y[r, k - j],
    shape (R, B, n + L - 1).

    ``block``: compute ``block`` output samples at a time into a
    preallocated result, so that the unfolded columns hold ``block * L``
    values and not ``(n + L - 1) * L``.  Every output is the same dot
    product either way; the blocks' matrix products may sum it in another
    order than the single one."""
    L = bank.shape[-1]
    total = y.shape[-1] + L - 1
    yp = F.pad(y, (L - 1, L - 1))
    if block is None or total <= block:
        return _conv_valid(yp, bank)
    out = torch.empty((y.shape[0], bank.shape[0], total), dtype=y.dtype,
                      device=y.device)
    for k0 in range(0, total, block):
        k1 = min(k0 + block, total)
        out[..., k0:k1] = _conv_valid(yp[:, k0:k1 + L - 1], bank)
    return out


def fir_causal(x: torch.Tensor, h: torch.Tensor,
               pre: torch.Tensor) -> torch.Tensor:
    """y[t] = sum_j h[j] * x[t - j] with x[t < 0] := pre, for rows x (R, n),
    taps h (T,) and per-row prehistory pre (R, 1)."""
    T = h.shape[0]
    xp = torch.cat([pre.expand(x.shape[0], T - 1), x], dim=-1)
    return _conv_valid(xp, h.unsqueeze(0))[:, 0]


def band_filtered(y: torch.Tensor, bank: torch.Tensor, offsets: torch.Tensor,
                  block: int = None, span: tuple = None) -> torch.Tensor:
    """(B, n_bands, ny) outputs of the FIR bank on rows y (B, ny), band b
    read from sample offsets[b] of its full convolution.

    ``block``: as in :func:`fir_bank_full`, with each band's slice taken
    inside the block loop: the full convolution of all bands, its gathered
    copy and the gather's index never exist at the full length.  The blocks
    read the samples from the least to the greatest offset, ``span`` (two
    host integers; read from ``offsets``, a host sync, when None)."""
    B, y_len = y.shape
    n_bands, L = bank.shape
    if block is None or y_len <= block:
        conv = fir_bank_full(y, bank)                     # (B, n_bands, y_len+L-1)
        idx = offsets[:, None] + torch.arange(y_len, device=y.device)[None, :]
        return torch.gather(conv, 2, idx.expand(B, n_bands, y_len))
    lo, hi = span if span is not None else (int(offsets.min()), int(offsets.max()))
    yp = F.pad(y, (L - 1, L - 1))
    out = torch.empty((B, n_bands, y_len), dtype=y.dtype, device=y.device)
    rel = (offsets - lo)[:, None]
    for t0 in range(0, y_len, block):
        t1 = min(t0 + block, y_len)
        # samples [t0 + lo, t1 + hi) of the full convolution
        conv = _conv_valid(yp[:, t0 + lo:t1 + hi + L - 1], bank)
        idx = rel + torch.arange(t1 - t0, device=y.device)[None, :]
        out[..., t0:t1] = torch.gather(conv, 2, idx.expand(B, n_bands, t1 - t0))
    return out


def band_stage_bytes(n_rows: int, y_len: int, itemsize: int) -> int:
    """What the band stage holds alive for one band of ``n_rows`` signals."""
    return BAND_STAGE_COPIES * n_rows * y_len * itemsize


def bank_bytes_per_sample(n_rows: int, n_bands: int, n_taps: int,
                          itemsize: int) -> int:
    """What the bank holds alive per output sample: the unfolded columns
    (``n_taps`` items), its output and the gathered copy (one item each per
    row and band) and the gather's int64 index."""
    return itemsize * (n_taps + 2 * n_rows * n_bands) + 8 * n_bands


def band_blocking(n_rows: int, n_bands: int, y_len: int, n_taps: int,
                  itemsize: int, budget: int = STAGE_BYTES_BUDGET):
    """(band_chunk, block) that keep the band stage of ``n_rows`` signals of
    ``y_len`` samples inside ``budget`` bytes; None where the whole fits
    (:func:`.._backend.chunk_size`).  The bands are chunked by
    :func:`band_stage_bytes`, then the bank of one chunk is blocked over its
    output samples by :func:`bank_bytes_per_sample`, never shorter than
    4,096 samples."""
    band_chunk = chunk_size(band_stage_bytes(n_rows, y_len, itemsize), n_bands,
                            budget)
    bands = n_bands if band_chunk is None else min(band_chunk, n_bands)
    block = chunk_size(bank_bytes_per_sample(n_rows, bands, n_taps, itemsize),
                       y_len, budget)
    return band_chunk, None if block is None else max(4096, block)
