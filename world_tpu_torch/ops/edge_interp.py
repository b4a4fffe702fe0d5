"""K1, the event engine: wrapper of csrc/event_engine.cu.

Replaces world_tpu/ops/edge_interp.py::_interval_interp_pallas (Pallas
kernel ``_event_kernel``).  A CUDA tensor goes to the hand-written kernel; a
CPU tensor goes to the plain PyTorch version,
world_tpu_torch/f0/events.py::batched_interval_interp.  There is no fallback
from the kernel to the plain version.
"""
import functools

import torch

from .._backend import (KernelGeometryError, LaunchCounter,
                        check_kernel_input, launch)
from ..f0.events import batched_interval_interp, stride_fraction
from ..utils.profiling import TRACER


counter = LaunchCounter()

# samples per block of the kernel's first pass (csrc/event_engine.cu kTile);
# tile t keeps its crossings at slots [t*TILE/2, (t+1)*TILE/2) of its row
EVENT_TILE = 4096

_ALIGN = 256            # byte alignment of each scratch array


def crossing_capacity(n: int) -> int:
    """Crossing slots per row of n samples.  A crossing needs
    x[i] > 0 > x[i+1], so no two are adjacent, and the last sample is never
    one: a row holds at most ceil((n-1)/2) <= n//2 crossings, and the tiled
    layout (EVENT_TILE even) needs no more."""
    return n // 2 + 1


@functools.lru_cache(maxsize=64)
def event_scratch_layout(rows: int, n: int, Q: int, itemsize: int) -> dict:
    """Byte offsets of the kernel's scratch arrays in one allocation:
    ``pos`` (rows, crossing_capacity(n)) positions of the working type,
    ``rank`` (rows, Q) int32 frame ranks and ``tile_count`` (rows, tiles)
    int32; ``bytes`` is the total.  Cached: the same dict for the same
    shapes, not to be mutated."""
    n_tiles = -(-n // EVENT_TILE)
    out, at = {}, 0
    for name, count, size in (("pos", rows * crossing_capacity(n), itemsize),
                              ("rank", rows * Q, 4),
                              ("tile_count", rows * n_tiles, 4)):
        out[name] = at
        at += -(-count * size // _ALIGN) * _ALIGN
    out["bytes"] = at
    out["n_tiles"] = n_tiles
    return out


_stride_fraction = functools.lru_cache(maxsize=64)(stride_fraction)


@TRACER.spanned("world.kernel.K1")
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
    pnum, qden = _stride_fraction(float(stride_samples))
    lay = event_scratch_layout(S, n, Q, signals.element_size())
    work = torch.empty(lay["bytes"], dtype=torch.uint8, device=dev)
    out = torch.empty((S, Q), dtype=signals.dtype, device=dev)
    m = torch.empty(S, dtype=torch.int32, device=dev)
    base = work.data_ptr()
    try:
        launch("event_engine", signals.dtype, signals.data_ptr(), S, n,
               t_frames.data_ptr(), Q, pnum, qden, float(fs), EVENT_TILE,
               crossing_capacity(n), base + lay["pos"], base + lay["rank"],
               base + lay["tile_count"], out.data_ptr(), m.data_ptr())
    except KernelGeometryError as e:
        raise ValueError(
            f"event engine: the geometry rows {S} x samples {n}, Q {Q} frames "
            f"at stride {pnum}/{qden} is too large: a launch holds at most "
            f"65,535 rows (f0.events splits the band signals it is given), "
            f"and its second pass keeps a block's crossings and the row's "
            f"tile offsets in shared memory ({e})") from e
    counter.add()
    return out, m


def interval_interp(signals: torch.Tensor, fs: float, t_frames: torch.Tensor,
                    stride_samples: float):
    """(f0 (S, Q), n_intervals (S,)): crossing intervals linearly
    interpolated at the uniform frame grid."""
    if signals.is_cuda:
        return event_engine_cuda(signals, fs, t_frames, stride_samples)
    return batched_interval_interp(signals, fs, t_frames, stride_samples)
