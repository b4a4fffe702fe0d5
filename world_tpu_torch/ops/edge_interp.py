"""K1, the event engine: wrapper of csrc/event_engine.cu.

Replaces world_tpu/ops/edge_interp.py::_interval_interp_pallas (Pallas
kernel ``_event_kernel``).  A CUDA tensor goes to the hand-written kernel; a
CPU tensor goes to the plain PyTorch version,
world_tpu_torch/f0/events.py::batched_interval_interp.  There is no fallback
from the kernel to the plain version.
"""
import torch

from .._backend import LaunchCounter, check_kernel_input, launch
from ..f0.events import batched_interval_interp, stride_fraction


counter = LaunchCounter()


def event_engine_cuda(signals: torch.Tensor, fs: float, t_frames: torch.Tensor,
                      stride_samples: float):
    """Launch the CUDA event engine: (f0 (S, Q), n_intervals (S,) int32)."""
    dev = signals.device
    check_kernel_input(signals, "signals", signals.dtype, dev, 2)
    check_kernel_input(t_frames, "t_frames", signals.dtype, dev, 1)
    if signals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"event engine: unsupported dtype {signals.dtype}")
    S, n = signals.shape
    Q = t_frames.shape[0]
    if n < 2 or Q < 1:
        raise ValueError(f"event engine: bad shape n={n}, Q={Q}")
    pnum, qden = stride_fraction(stride_samples)
    scratch = torch.empty((S, n), dtype=torch.int32, device=dev)
    count = torch.empty(S, dtype=torch.int32, device=dev)
    out = torch.empty((S, Q), dtype=signals.dtype, device=dev)
    m = torch.empty(S, dtype=torch.int32, device=dev)
    launch("event_engine", signals.dtype, signals.data_ptr(), S, n,
           t_frames.data_ptr(), Q, pnum, qden, float(fs), scratch.data_ptr(),
           count.data_ptr(), out.data_ptr(), m.data_ptr())
    counter.launches += 1
    return out, m


def interval_interp(signals: torch.Tensor, fs: float, t_frames: torch.Tensor,
                    stride_samples: float):
    """(f0 (S, Q), n_intervals (S,)): crossing intervals linearly
    interpolated at the uniform frame grid."""
    if signals.is_cuda:
        return event_engine_cuda(signals, fs, t_frames, stride_samples)
    return batched_interval_interp(signals, fs, t_frames, stride_samples)
