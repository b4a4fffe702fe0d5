"""Device and arithmetic helpers of the plain reference.

A frozen copy of world_tpu_torch/_backend.py without its kernel loader: the
reference runs every stage as plain PyTorch on any device.  It sets no
process-wide precision switch; the benchmark's harness owns those (the
control of ``benchmark/judge.py`` turns TF32 on around its own run).
"""
import torch

# What one analysis stage may hold alive in temporaries before it blocks its
# work (bands, output samples, frames, voiced sections): 1 GiB, 1/80 of an
# 80 GB card's memory, so that a stage's leftovers, the allocator's cache
# and the stages after it stay far inside the card at any length.  The
# stages size their blocks from the shapes they are given, batch included.
STAGE_BYTES_BUDGET = 2 ** 30


def chunk_size(unit_bytes: int, count: int, budget: int = STAGE_BYTES_BUDGET):
    """How a stage whose temporaries hold ``unit_bytes`` for each of ``count``
    independent units (bands, samples, frames, sections) blocks its work:
    None where the whole fits ``budget``, else the units of one chunk.  A
    chunk gets half of the budget: the stage's result, which grows while
    the chunks run, and the chunks' own leftovers have the other half."""
    if unit_bytes * count <= budget:
        return None
    return max(1, budget // 2 // unit_bytes)

# float64's machine epsilon: the reference's guards add or floor at it, and
# the port keeps it in every working type (float32's own eps, 1.2e-7, lies
# above much of a speech spectrum).
F64_EPS = 2.220446049250313e-16


def resolve_device(device=None) -> torch.device:
    """``device``, or the GPU when it is None.  Without a GPU that raises:
    a run on the CPU is asked for by name, never fallen back to."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: world_tpu_torch runs on the GPU "
                           "by default; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def torch_dtype(dtype) -> torch.dtype:
    """Accept a torch dtype or a numpy-style name ("float32", "float64")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "float64": torch.float64}[str(dtype)]


def scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim tensor of ``like``'s dtype on ``like``'s device."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def rdiv(v: float, x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded ``v / x``.  ``v / x`` with a Python ``v`` is
    ``x.reciprocal() * v`` in PyTorch, and a CUDA tensor divided by a Python
    scalar is multiplied by the scalar's reciprocal: both round twice."""
    return torch.div(scalar(v, x), x)


def sdiv(x: torch.Tensor, v: float) -> torch.Tensor:
    """The correctly rounded ``x / v`` on every device (see :func:`rdiv`)."""
    return torch.div(x, scalar(v, x))


