"""The programs around world_tpu_torch on the CPU, on a 0.5 s cut of x16:
bench_torch.py, tools/bench_paths_torch.py, tools/profile_stages_torch.py,
tools/bench_stream_torch.py and the two examples run and print what they
promise; and no file of the port imports JAX or the JAX package."""
import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
CUT = ["--device", "cpu", "--seconds", "0.5"]


def _load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def on_path(monkeypatch):
    """The repository root on sys.path, as PYTHONPATH=. gives the tools."""
    monkeypatch.syspath_prepend(str(ROOT))


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_files():
    return (sorted((ROOT / "world_tpu_torch").rglob("*.py"))
            + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
            + sorted((ROOT / "tools").glob("*_torch.py"))
            + sorted((ROOT / "examples").glob("*_torch.py")))


def test_no_port_file_imports_jax_or_world_tpu():
    files = _port_files()
    assert len(files) > 40
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "world_tpu")]
    assert not bad, bad


def test_bench_torch_on_cpu(on_path, capsys):
    bench = _load("bench_torch.py")
    doc = bench.main(CUT + ["--readings", "2", "--rounds", "1"])
    assert _last_json(capsys) == json.loads(json.dumps(doc))
    for key in ("metric", "value", "unit", "fixture", "caps", "timing", "paths",
                "device", "kind", "card", "torch"):
        assert key in doc, key
    assert doc["device"] == "cpu" and doc["card"] is None and "a cut" in doc["fixture"]
    assert set(doc["paths"]) == {"single", "batch4"}
    for p in doc["paths"].values():
        assert p["gate"] == "n/a" and p["readings"] == 2
        assert p["xrt"]["min"] <= p["xrt"]["median"] <= p["xrt"]["max"]
        assert set(p["ms_per_call"]) == {"min", "median", "max"}
        assert p["launches"] == {"event_engine": 0, "refine_dft": 0,
                                 "extension_scan": 0}
    assert doc["value"] == max(p["xrt"]["median"] for p in doc["paths"].values())


def test_bench_paths_torch_on_cpu(on_path, capsys, tmp_path):
    tool = _load("tools/bench_paths_torch.py")
    out = tmp_path / "paths.json"
    doc = tool.main(CUT + ["--readings", "1", "--rounds", "1", "--batch", "1", "2",
                           "--out", str(out)])
    assert _last_json(capsys) == json.loads(out.read_text()) == json.loads(
        json.dumps(doc))
    assert set(doc["paths"]) == {"dio_encode", "classic_roundtrip",
                                 "harvest_roundtrip", "swipe_f0"}
    gates = {k: p["gate"] for k, p in doc["paths"].items()}
    assert gates == {"dio_encode": "PASS", "classic_roundtrip": "PASS",
                     "harvest_roundtrip": "n/a", "swipe_f0": "PASS"}, gates
    # the classic paths also run eagerly on the same static code
    for name in ("dio_encode", "classic_roundtrip"):
        eager = doc["paths"][name]["eager"]
        assert eager["gate"] == "PASS" and eager["launches"] == doc["paths"][name][
            "launches"]
    assert doc["paths"]["classic_roundtrip"]["launches"] == {
        "event_engine": 0, "refine_dft": 0, "extension_scan": 0}
    assert set(doc["batch_sweep"]) == {"1", "2"}
    for B, row in doc["batch_sweep"].items():
        assert row["gate"] == "PASS"
        assert row["ms_per_utterance"] == pytest.approx(
            row["ms_per_call"]["median"] / int(B))


def test_profile_stages_torch_on_cpu(on_path, capsys):
    tool = _load("tools/profile_stages_torch.py")
    doc = tool.main(CUT + ["--signal", "x16"])
    assert _last_json(capsys) == json.loads(json.dumps(doc))
    (sig,) = doc["signals"]
    stages = sig["stages"]
    assert set(stages) == {label.strip() for label, _, _ in tool.STAGES}
    assert all(r["calls"] == 1 and r["ms"] > 0 for r in stages.values())
    # on the CPU only the host clock is measured
    assert all(r["host_syncs"] is None and r["device_events"] is None
               for r in stages.values())
    assert stages["K2"]["ms"] <= stages["refine_candidates"]["ms"] <= stages["Harvest"]["ms"]


def test_bench_stream_torch_on_cpu(on_path, capsys, tmp_path):
    tool = _load("tools/bench_stream_torch.py")
    out = tmp_path / "stream.json"
    doc = tool.main(CUT + ["--calls", "3", "--max-utts", "3", "--min-seconds", "0.2",
                           "--max-seconds", "0.5", "--readings", "1",
                           "--out", str(out)])
    assert _last_json(capsys) == json.loads(json.dumps(doc))
    full = json.loads(out.read_text())
    assert {k: v for k, v in full.items() if k != "contours"} == json.loads(
        json.dumps(doc))
    st = doc["stream"]
    assert st["all"]["calls"] == 3 and st["first_half"]["calls"] == 1
    assert len(full["contours"]) == 2 + st["utterances"]
    assert st["all"]["audio_s"] == pytest.approx(
        st["first_half"]["audio_s"] + st["second_half"]["audio_s"])
    # no graphs on the CPU: every bucket runs eagerly outside BATCH_GRAPHS
    assert st["graph_calls"] == {"eager": 0, "captured": 0, "replayed": 0}
    assert set(doc["encode"]) == {"harvest", "harvest_fft2048"}
    same = tool.main(["--compare", str(out), str(out)])
    assert same["vuv_flips_total"] == 0 and same["max_abs_df0_hz"] == 0.0


def test_examples_on_cpu(tmp_path, capsys):
    from world_tpu_torch.io.wav import read_wav, write_wav

    g = np.load(ROOT / "tests" / "golden" / "harvest_16k.npz")
    wav = tmp_path / "cut.wav"
    write_wav(wav, int(g["fs"]), np.asarray(g["x16"])[:8000])
    out = tmp_path / "resynth.wav"
    res = _load("examples/prosody_torch.py").main(
        [str(wav), "--device", "cpu", "--pitch", "1.2", "--out", str(out)])
    fs, y = read_wav(out)
    assert fs == 16000 and y.shape == res["y"].shape and np.isfinite(res["y"]).all()
    assert 0 < np.abs(y).max() <= 1.0
    feats = _load("examples/spectral_features_torch.py").main(
        [str(wav), "--device", "cpu"])
    assert feats["lfbank_shape"][1] == 32
    assert feats["lsd_db"] < 8.0, feats
    assert "MCEP-40 round-trip LSD" in capsys.readouterr().out
