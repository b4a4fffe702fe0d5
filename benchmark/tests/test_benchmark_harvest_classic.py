"""The 48 kHz cell of pyworld's default chain (harvest_classic48k.corpus_b16)
run whole on the CPU at a tiny size, as test_benchmark_run.py runs the
16 kHz cells: a sound run comes out correct with the cell's metrics and
checked numbers, and the same run with its timed path broken underneath
(every frame unvoiced; the waveform scaled by one half) comes out not
correct."""
import json

import pytest

from faults import plant_fault
from harness import core
from test_benchmark_run import tiny_run

CELL = "harvest_classic48k.corpus_b16"


@pytest.mark.parametrize("fault", [None, "all_unvoiced", "synthesis_scaled"])
def test_a_tiny_run_of_the_48_khz_cell(monkeypatch, fault):
    if fault:
        plant_fault(monkeypatch, fault)
    bench, cell, out = tiny_run(CELL)
    assert out["correct"] == (fault is None), out["checked"]
    assert out["cfg"]["fs"] == 48000 and out["cfg"]["entry"] == "HarvestClassic"
    for req, *_ in out["samples"]:
        assert req.audio_s == req.n / 48000
    if fault is None:
        res = json.loads(json.dumps(out["result"]))
        assert res["attempted"] >= 1 and res["failed"] == 0
        assert set(res["metrics"]) == {m["name"] for m in core.metrics_of(bench, cell, 0)}
        assert set(res["checked"]) == set(core.judge.limits_of(CELL))
