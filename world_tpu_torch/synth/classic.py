"""From world_tpu/synth/classic.py, what Requiem synthesis uses.  Classic
pulse/noise synthesis itself is not ported yet (see ROADMAP)."""
import torch

from .._backend import sdiv


def grid_interp(values: torch.Tensor, temporal_positions: torch.Tensor,
                queries: torch.Tensor, frame_period_s: float) -> torch.Tensor:
    """interp1d(tp, values, fill_value='extrapolate') on the uniform frame
    grid, by index arithmetic; values (..., n)."""
    n = values.shape[-1]
    pos = sdiv(queries - temporal_positions[0], frame_period_s)
    j = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
    frac = pos - j
    y0 = values[..., j]
    y1 = values[..., j + 1]
    return y0 + (y1 - y0) * frac
