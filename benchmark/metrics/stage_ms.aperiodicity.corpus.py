"""stage_ms.aperiodicity.corpus: stage_ms.f0.corpus's reading for
D4C-Requiem or classic D4C (K6, K7): the device ms of the program's spans
``world.stage.aperiodicity`` per second of samples computed, over the
traced run's profiled window."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "stage_ms_f0_corpus", Path(__file__).with_name("stage_ms.f0.corpus.py"))
_f0 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_f0)


def read(run):
    return _f0.ms_per_computed_s("world.stage.aperiodicity")
