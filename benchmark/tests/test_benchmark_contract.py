"""BENCHMARK.json as the benchmark's contract has it: its keys, names,
units, files and bounds; and each configuration's audio and reference
paths, found by the names it gives."""
import json
import re
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (ROOT / "benchmark" / "mixes" / f"{w['traffic']}.json").exists()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert TEXT.match(m["layer"]) and m["moves"] in e2e
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in BENCH["per_layer"])
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").exists()


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_a_configuration_names_its_audio_at_its_rate(conf):
    cfg = json.loads((ROOT / conf["file"]).read_text())
    data = ROOT / "benchmark" / "data"
    assert (data / f"{cfg['audio']}.npy").is_file()
    manifest = json.loads((data / f"{cfg['audio']}.json").read_text())
    assert set(manifest) == {"fs", "source", "made", "seconds"}
    assert TEXT.match(manifest["source"])
    assert manifest["fs"] == cfg["fs"]
    n = np.load(data / f"{cfg['audio']}.npy", mmap_mode="r").shape[0]
    assert abs(manifest["seconds"] - n / manifest["fs"]) < 1e-3


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_a_configuration_names_reference_paths_with_known_controls(conf):
    from harness import judge
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert set(cfg["references"]) == set(cfg["entries"])
    for name in cfg["references"].values():
        assert (ROOT / "benchmark" / "paths" / f"{name}.py").is_file()
        path = judge.path_of(name)
        assert path.CONTROL in judge.CONTROLS and callable(path.outputs)
