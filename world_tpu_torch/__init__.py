"""world_tpu_torch: the WORLD vocoder on PyTorch and CUDA (NVIDIA Hopper).

A port of ``world_tpu`` (JAX/Pallas), which stays the reference.  Importing
the package applies the precision policy of :mod:`world_tpu_torch._backend`
and builds nothing; the CUDA kernels build on first use.
"""
from . import _backend  # noqa: F401  (precision policy)
from .api import World
from .parallel.batch import (DioClassic, HarvestClassic, HarvestRequiem,
                             SwipeF0, batch_encode_decode,
                             batch_encode_decode_ragged, encode_classic_one,
                             encode_decode_classic_one, encode_decode_one,
                             frame_sharded_cheaptrick, make_devices)

__all__ = ["World", "HarvestRequiem", "DioClassic", "HarvestClassic",
           "SwipeF0", "encode_decode_one", "encode_classic_one",
           "encode_decode_classic_one", "batch_encode_decode",
           "batch_encode_decode_ragged", "frame_sharded_cheaptrick",
           "make_devices"]
