"""chip_smoke.py, the repository root's GPU smoke script, loaded by path as a
module for the port's tests: it imports numpy only at import, and its
operand builders and layouts take a device."""
import functools
import importlib.util
from pathlib import Path


@functools.lru_cache(maxsize=None)
def chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
