"""K1, the event engine: wrapper of csrc/event_engine.cu.

Replaces world_tpu/ops/edge_interp.py::_interval_interp_pallas (Pallas
kernel ``_event_kernel``).  A CUDA tensor goes to the hand-written kernel; a
CPU tensor goes to the plain PyTorch version,
world_tpu_torch/f0/events.py::batched_interval_interp.  There is no fallback
from the kernel to the plain version.

In the benchmark's frozen reference every call runs the plain version, on
any device: the kernels and their wrappers are left out of this copy.
"""
import functools

import torch

from ..f0.events import batched_interval_interp, stride_fraction


# samples per block of the kernel's first pass (csrc/event_engine.cu kTile);
# tile t keeps its crossings at slots [t*TILE/2, (t+1)*TILE/2) of its row
EVENT_TILE = 4096

_ALIGN = 256            # byte alignment of each scratch array


_stride_fraction = functools.lru_cache(maxsize=64)(stride_fraction)


def interval_interp(signals: torch.Tensor, fs: float, t_frames: torch.Tensor,
                    stride_samples: float):
    """(f0 (S, Q), n_intervals (S,)): crossing intervals linearly
    interpolated at the uniform frame grid."""
    return batched_interval_interp(signals, fs, t_frames, stride_samples)
