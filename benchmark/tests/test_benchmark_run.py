"""A whole run of a cell on the CPU at a tiny size, past the harness's look
for a card: set-up, warm-up, the window, the metric readers and the check
against the reference, with the result line's keys; and the same run with
its timed path broken underneath (benchmark/tests/faults.py), which the
check has to find."""
import argparse
import copy
import json
import time

import pytest

from faults import FAULTS, plant_fault
from harness import core

TINY = {"min_s": 0.3, "max_s": 0.6, "quantum_s": 0.25, "keep_share": 0.5}


def tiny_run(cell, seed=2 ** 31 + 17):
    bench, c, cfg, mix = core.cell_of(cell)
    mix = copy.deepcopy(mix)
    p = mix["params"]
    p.update({k: v for k, v in TINY.items() if k in p or k == "keep_share"})
    if "rows" in p:
        p.update(rows=2, calls_per_pass=4)
    if "lengths_per_pass" in p:
        p["lengths_per_pass"] = 2
    cfg = dict(cfg, bucket_quantum_s=0.25)
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.5, trace=0)
    return bench, c, core.run(args, time.perf_counter(), device="cpu",
                              cell_data=(bench, c, cfg, mix))


@pytest.mark.parametrize("cell", ["harvest_requiem.corpus_b16",
                                  "dio_classic.world_api"])
def test_a_tiny_run_on_the_cpu(cell):
    bench, c, out = tiny_run(cell)
    res = json.loads(json.dumps(out["result"]))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checked"
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    names = {m["name"] for m in core.metrics_of(bench, c, 0)}
    assert set(res["metrics"]) == names
    assert set(res["checked"]) == set(core.judge.limits_of(cell))


@pytest.mark.parametrize("cell", ["harvest_requiem.corpus_b16",
                                  "dio_classic.corpus_b16",
                                  "dio_classic.world_api"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_tiny_run_broken_underneath_is_not_correct(monkeypatch, cell, fault):
    if fault == "half_rows" and cell.endswith("world_api"):
        pytest.skip("the cell's calls hold one row")
    plant_fault(monkeypatch, fault)
    _, _, out = tiny_run(cell)
    assert not out["correct"], out["checked"]
