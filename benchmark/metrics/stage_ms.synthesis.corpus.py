"""stage_ms.synthesis.corpus: stage_ms.f0.corpus's reading for the
Requiem or the classic synthesis: the device ms of the program's spans
``world.stage.synthesis`` per second of samples computed, over the traced
run's profiled window."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "stage_ms_f0_corpus", Path(__file__).with_name("stage_ms.f0.corpus.py"))
_f0 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_f0)


def read(run):
    return _f0.ms_per_computed_s("world.stage.synthesis")
