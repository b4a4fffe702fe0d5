"""On the card: the control comes out not correct, and a run whose timed
path is broken underneath comes out not correct, in every cell.

The control is the plain reference put in the program's place on a run's
sampled requests, one precision below the configuration's float32 (the
``CONTROL`` of the reference path, benchmark/paths/<name>.py): in float32
with TF32 on where TF32 reaches the path (Harvest's FIR banks and the
Requiem synthesis), and in the classic cells, which TF32 does not reach,
so with its input rounded to bfloat16.
The faults are planted in the program before set-up, so that its graphs
capture them: answers altered where they are produced (the analysis' f0
detuned by 1% where voiced; every frame unvoiced, as an analysis that finds
no candidate; every other frame's f0 5% high; the synthesis' waveform
scaled by one half), and, in the cells whose calls hold 16 rows, half of
each call's rows answered with the other half's outputs.

    python -m pytest benchmark/tests/test_benchmark_chip.py -m gpu -q
"""
import argparse
import json
import time

import pytest

from faults import FAULTS, plant_fault
from harness import core, judge

CELLS = [w["name"] for w in json.loads((core.ROOT / "BENCHMARK.json").read_text())
         ["workloads"]]
SEED = 2 ** 32 + 99
SECONDS = 1.5


def run_cell(cell, seed=SEED, seconds=SECONDS):
    return core.run(argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                                       trace=0), time.perf_counter())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    out = run_cell(cell)
    cfg, x32, samples = out["cfg"], out["x32"], out["samples"]
    ctrl = judge.control(cfg, x32, samples, device=card)
    ref = judge.reference(cfg, x32, samples, device=card, gots=[ctrl])
    values, _ = judge.judge(cfg, ctrl, ref)
    correct, rows = judge.verdict(values, judge.limits_of(cell))
    assert out["correct"], out["checked"]
    assert not correct, rows


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(card, monkeypatch, cell, fault):
    if fault == "half_rows" and core.cell_of(cell)[3]["params"].get("rows", 1) < 2:
        pytest.skip("the cell's calls hold one row")
    plant_fault(monkeypatch, fault)
    out = run_cell(cell)
    assert not out["correct"], out["checked"]
