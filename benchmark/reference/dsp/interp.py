"""Linear interpolation with end-segment extrapolation (world_tpu/dsp/interp.py)."""
import torch


def interp1_extrap(xp: torch.Tensor, fp: torch.Tensor,
                   xq: torch.Tensor) -> torch.Tensor:
    """scipy ``interp1d(xp, fp, fill_value='extrapolate')`` for ascending
    ``xp`` (n,), ``fp`` (..., n) and queries ``xq`` (m,)."""
    n = xp.shape[-1]
    j = torch.searchsorted(xp, xq, right=True) - 1
    j = j.clamp(0, n - 2)
    x0, x1 = xp[j], xp[j + 1]
    y0, y1 = fp[..., j], fp[..., j + 1]
    denom = x1 - x0
    slope = (y1 - y0) / torch.where(denom == 0, torch.ones_like(denom), denom)
    return y0 + slope * (xq - x0)


def interp_rows(xq: torch.Tensor, xp: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``np.interp(xq, xp, row)`` for each row of Y (..., n): ``xp`` (n,)
    ascending (ties allowed), queries ``xq`` (m,) clamped to the end values."""
    n = xp.shape[0]
    j = (torch.searchsorted(xp, xq, right=True) - 1).clamp(0, n - 2)
    x0, x1 = xp[j], xp[j + 1]
    denom = torch.where(x1 == x0, torch.ones_like(x0), x1 - x0)
    t = ((xq - x0) / denom).clamp(0.0, 1.0)
    return Y[..., j] * (1 - t) + Y[..., j + 1] * t
