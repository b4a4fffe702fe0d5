"""MATLAB-compatible rounding (world_tpu/dsp/rounding.py)."""
import torch


def matlab_round_half(x: torch.Tensor) -> torch.Tensor:
    """The reference's round_matlab verbatim: x + 0.5 (x > 0) / x - 0.5,
    NOT truncated; callers truncate where they index."""
    return torch.where(x > 0, x + 0.5, x - 0.5)


def round_matlab(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero, as an integer-valued float tensor."""
    return torch.where(x > 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def round_half_even_decimals(x: torch.Tensor, decimals: int) -> torch.Tensor:
    """float("{:.Nf}".format(x)): round to N decimals, ties to even."""
    s = 10.0 ** decimals
    return torch.round(x * s) / s
