"""What the benchmark loads: no module of JAX or of the JAX package
(world_tpu), compared by whole top-level names, in a CPU dry run of
everything a run of any cell loads, and nothing of the program in the
plain reference or in the reference paths."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "world_tpu"}

DRY_RUN = r"""
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
from harness import core, judge, trace
from roofline import bounds, kernels
bench = core.load_json(core.ROOT / "BENCHMARK.json")
import importlib
for w in bench["workloads"]:
    _, cell, cfg, mix = core.cell_of(w["name"])
    importlib.import_module("traffic." + mix["driver"])
    importlib.import_module("entries." + cfg["entry"])
    judge.path_of(cfg["reference"])
    for m in core.metrics_of(bench, cell, 0) + core.metrics_of(bench, cell, 1):
        core.load_module(core.BENCH / "metrics" / (m["name"] + ".py"))
import world_tpu_torch, world_tpu_torch.parallel.graphs
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_dry_run_loads_no_jax():
    code = DRY_RUN.format(bench=str(BENCH), root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 0, res.stderr
    loaded = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "world_tpu_torch" in loaded and "reference" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_no_benchmark_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    files = list((BENCH / "reference").rglob("*.py"))
    assert len(files) > 20
    paths = list((BENCH / "paths").glob("*.py"))
    assert len(paths) >= 4
    for path in files + paths:
        names = top_level_imports(path)
        assert not names & (FORBIDDEN | {"world_tpu_torch"}), (path, names)


def test_harness_has_no_tie_to_the_jax_benchmark():
    for path in BENCH.rglob("*.py"):
        text = path.read_text()
        for name in ("bench.py", "bench_torch.py", "chip_smoke", "tools/"):
            assert f"import {name.split('.')[0]}" not in text, (path, name)
