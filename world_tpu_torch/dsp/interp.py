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
