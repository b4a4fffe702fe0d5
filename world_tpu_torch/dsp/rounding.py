"""MATLAB-compatible rounding (world_tpu/dsp/rounding.py)."""
import torch


def matlab_round_half(x: torch.Tensor) -> torch.Tensor:
    """The reference's round_matlab verbatim: x + 0.5 (x > 0) / x - 0.5,
    NOT truncated; callers truncate where they index."""
    return torch.where(x > 0, x + 0.5, x - 0.5)
