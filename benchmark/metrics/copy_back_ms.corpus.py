"""copy_back_ms.corpus: the device ms of the ragged entry's copies of its
outputs to the host (the program's spans ``world.batch.copy_back``, CUDA
events around them) per second of samples computed, over the traced run's
profiled window (stage_ms.f0.corpus's reading).  A DioClassic caller
copies the module's outputs itself: there the program holds no such span
and the reading is None."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "stage_ms_f0_corpus", Path(__file__).with_name("stage_ms.f0.corpus.py"))
_f0 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_f0)


def read(run):
    return _f0.ms_per_computed_s("world.batch.copy_back")
