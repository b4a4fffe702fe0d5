"""A whole run of a cell on the CPU at a tiny size, past the harness's look
for a card: set-up, warm-up, the window, the metric readers and the check
against the reference, with the result line's keys; the same run with its
timed path broken underneath (benchmark/tests/faults.py), which the check
has to find; and a deployment at another rate, with its own audio and
reference path, added by new files alone."""
import argparse
import copy
import json
import time

import numpy as np
import pytest

from faults import FAULTS, plant_fault
from harness import core, judge
from traffic import cuts

TINY = {"min_s": 0.3, "max_s": 0.6, "quantum_s": 0.25, "keep_share": 0.5}


def tiny_run(cell, seed=2 ** 31 + 17, cell_data=None):
    bench, c, cfg, mix = cell_data or core.cell_of(cell)
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


@pytest.fixture
def deployment_32k(tmp_path, monkeypatch):
    """A 32 kHz deployment of the facade cell in files of its own, outside
    the repository: x16 upsampled by 2 with its manifest, a configuration
    naming it, a reference path and a limits file; the harness's audio,
    path and limits directories pointed there.  The upsampled speech is
    rounded to 16-bit PCM steps, as a 16-bit file holds it: with no noise
    floor at all above 8 kHz (float64 straight from the resampler) D4C's
    bands at 9 and 12 kHz hold nothing but round-off, and float32 and
    float64 aperiodicity part by tens of dB."""
    from scipy.signal import resample_poly
    bench, cell, cfg, mix = core.cell_of("dio_classic.world_api")
    for sub in ("data", "paths", "limits"):
        (tmp_path / sub).mkdir()
    x = np.round(resample_poly(np.load(cuts.DATA / "x16.npy"), 2, 1) * 32768) / 32768
    np.save(tmp_path / "data" / "x16_up2.npy", x)
    (tmp_path / "data" / "x16_up2.json").write_text(json.dumps(
        {"fs": 32000, "source": "benchmark/data/x16.npy",
         "made": "scipy.signal.resample_poly(x16, 2, 1), rounded to 16-bit PCM steps",
         "seconds": x.shape[0] / 32000}))
    (tmp_path / "paths" / "world_dio_classic_32k.py").write_text(
        "from paths.world_dio_classic import CONTROL, outputs  # noqa: F401\n")
    (tmp_path / "limits" / "dio_classic32k.world_api.json").write_text(
        json.dumps(judge.limits_file(cell["name"])))
    monkeypatch.setattr(cuts, "DATA", tmp_path / "data")
    monkeypatch.setattr(judge, "PATH_DIR", tmp_path / "paths")
    monkeypatch.setattr(judge, "LIMITS", tmp_path / "limits")
    cell = dict(cell, name="dio_classic32k.world_api")
    cfg = dict(cfg, name="arctic32k_dio_classic", fs=32000, audio="x16_up2",
               fft_size=2048, reference="world_dio_classic_32k")
    return bench, cell, cfg, mix


@pytest.mark.parametrize("fault", [None, "all_unvoiced", "synthesis_scaled"])
def test_a_deployment_at_another_rate_with_its_own_path(monkeypatch,
                                                        deployment_32k, fault):
    if fault:
        plant_fault(monkeypatch, fault)
    _, _, out = tiny_run(deployment_32k[1]["name"], cell_data=deployment_32k)
    assert out["correct"] == (fault is None), out["checked"]
    assert out["cfg"]["fs"] == 32000 and out["x32"].shape[0] == 2 * 74304
    for req, *_ in out["samples"]:
        assert req.audio_s == req.n / 32000
        assert TINY["min_s"] * 32000 <= req.n <= TINY["max_s"] * 32000


@pytest.mark.parametrize("change,error", [
    (dict(fs=22050), "at 16000 Hz"),
    (dict(audio="x22"), "is missing"),
    (dict(audio=None), "names no audio"),
    (dict(max_s=5.0), "cuts of up to 5.0 s")])
def test_audio_that_does_not_fit_the_cell_stops_the_run(change, error):
    _, _, cfg, mix = core.cell_of("harvest_requiem.corpus_b16")
    cfg = dict(cfg, **{k: v for k, v in change.items() if k != "max_s"})
    if change.get("audio", "") is None:
        del cfg["audio"]
    mix = dict(mix, params=dict(mix["params"], **{k: v for k, v in change.items()
                                                  if k == "max_s"}))
    with pytest.raises(core.Setup, match=error):
        core.audio_of(cfg, mix)
    assert core.audio_of(*core.cell_of("harvest_requiem.corpus_b16")[2:]).fs == 16000
