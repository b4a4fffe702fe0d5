"""Zero-crossing interval extraction into a fixed-capacity table
(world_tpu/dsp/zc.py): the negative-going crossings of one signal, their
interval midpoints and the interval-based instantaneous f0."""
from typing import NamedTuple

import torch

from .._backend import rdiv, sdiv


class Events(NamedTuple):
    locations: torch.Tensor  # (capacity,) interval midpoints in seconds
    f0: torch.Tensor         # (capacity,) interval-based instantaneous f0
    count: torch.Tensor      # 0-dim int64: number of valid intervals


def zero_crossing_events(x: torch.Tensor, fs: float, capacity: int) -> Events:
    """Negative-going zero crossings of ``x`` (n,) -> interval locations and
    f0, with the reference's 1-based sub-sample edge formula.  Events beyond
    ``capacity`` are dropped."""
    n = x.shape[0]
    dtype, dev = x.dtype, x.device
    x_next = torch.cat([x[1:], x[-1:]])
    mask = (x_next * x < 0) & (x_next < x)
    idx1 = torch.arange(1, n + 1, dtype=dtype, device=dev)
    denom = x_next - x
    fine = idx1 - x / torch.where(denom == 0, torch.ones_like(denom), denom)
    at = mask.nonzero()[:capacity + 1, 0]
    n_edges = at.shape[0]
    edges = torch.zeros(capacity + 1, dtype=dtype, device=dev)
    edges[:n_edges] = fine[at]
    locations = sdiv((edges[:-1] + edges[1:]) / 2.0, fs)
    diffs = edges[1:] - edges[:-1]
    f0 = rdiv(float(fs), torch.where(diffs == 0, torch.ones_like(diffs), diffs))
    count = max(n_edges - 1, 0)
    valid = torch.arange(capacity, device=dev) < count
    zero = torch.zeros((), dtype=dtype, device=dev)
    return Events(torch.where(valid, locations, zero),
                  torch.where(valid, f0, zero),
                  torch.tensor(count, device=dev))
