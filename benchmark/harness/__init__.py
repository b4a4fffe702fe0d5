"""The benchmark's harness: one run of a cell (:mod:`.core`), the check of
its outputs (:mod:`.judge`) and what it reads off the card (:mod:`.trace`)."""
import importlib.util
from pathlib import Path


def load_module(path: Path):
    """A module of the benchmark by its file (metric names hold dots): a
    metric's reader, a reference path."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
