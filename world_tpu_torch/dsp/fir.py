"""FIR filtering as direct (im2col + GEMM) convolution (world_tpu/dsp/fir.py).

cuDNN is bypassed for these convolutions: its algorithm choice (FFT,
Winograd, TF32 tensor cores) would change the rounding of the band-filtered
signals whose zero crossings Harvest times.  PyTorch's own path lowers a
convolution to im2col + a full-precision GEMM, the same sum of products as
the JAX package's im2col matmul.
"""
import torch
import torch.nn.functional as F


def _conv_valid(xp: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """out[r, b, t] = sum_j taps[b, j] * xp[r, t + L-1 - j] (valid part)."""
    weight = torch.flip(taps, dims=(-1,)).unsqueeze(1)        # (B, 1, L)
    with torch.backends.cudnn.flags(enabled=False):
        return F.conv1d(xp.unsqueeze(1), weight)


def fir_bank_full(y: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """Full linear convolution of every row of ``y`` (R, n) with every row
    of ``bank`` (B, L): out[r, b, k] = sum_j bank[b, j] * y[r, k - j],
    shape (R, B, n + L - 1)."""
    L = bank.shape[-1]
    return _conv_valid(F.pad(y, (L - 1, L - 1)), bank)


def fir_causal(x: torch.Tensor, h: torch.Tensor,
               pre: torch.Tensor) -> torch.Tensor:
    """y[t] = sum_j h[j] * x[t - j] with x[t < 0] := pre, for rows x (R, n),
    taps h (T,) and per-row prehistory pre (R, 1)."""
    T = h.shape[0]
    xp = torch.cat([pre.expand(x.shape[0], T - 1), x], dim=-1)
    return _conv_valid(xp, h.unsqueeze(0))[:, 0]


def band_filtered(y: torch.Tensor, bank: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """(B, n_bands, ny) outputs of the FIR bank on rows y (B, ny), band b
    read from sample offsets[b] of its full convolution."""
    B, y_len = y.shape
    n_bands = bank.shape[0]
    conv = fir_bank_full(y, bank)                         # (B, n_bands, y_len+L-1)
    idx = offsets[:, None] + torch.arange(y_len, device=y.device)[None, :]
    return torch.gather(conv, 2, idx.expand(B, n_bands, y_len))
