"""pyworld's default chain, Harvest -> CheapTrick -> classic D4C -> classic
synthesis, as ``HarvestClassic`` at 48 kHz on the CPU:

  * against the benchmark's frozen plain reference path
    (benchmark/paths/harvest_classic.py) in float64 on two cuts of x48
    (benchmark/data/x48.npy: x16 upsampled three times, rounded to 16-bit
    PCM steps), with seeded noise; a bfloat16-rounded input fails the same
    tolerances;
  * its rows equal their single calls;
  * the classic caps at the DIO default are the values they always had, and
    Harvest's caps hold a contour at its ceiling with no overflow;
  * ``parallel.batch.analyze`` patched changes the module's output (it is
    looked up at call time, where the benchmark plants its faults).

One analysis is shared by the cases (a module fixture); the file runs on
one torch thread, in about 20 s.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FS, FP = 48000, 5
L = 14400                                   # 0.3 s at 48 kHz
OFFSETS = (30000, 100000)
# The port's plain code and the frozen copy run the same operations in the
# same order on the CPU, so they agree to the last bit here; 1e-9 of each
# output's largest value leaves room for the library's rounding of a row by
# its alignment in memory (~1e-12 of scale), and nothing a lower precision
# would give: a bfloat16-rounded input moves every output by far more.
REL_TOL = 1e-9
KEYS = ("f0", "vuv", "sp", "ap", "y")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the file: the suite runs its files in parallel
    processes on shared cores, where torch's own pool of threads made the
    first case some 30 times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_path():
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))           # after the repository's own
    from harness import load_module
    return load_module(BENCH / "paths" / "harvest_classic.py")


@pytest.fixture(scope="module")
def case():
    """Two requests of one 0.3 s bucket, cuts of x48 (the second fills the
    bucket, the first is 1,000 samples short and zero-padded), the rows of
    the benchmark's noise draw for their call, the module, and its outputs
    (float64, CPU)."""
    from types import SimpleNamespace

    from world_tpu_torch import HarvestClassic

    path = _reference_path()
    from paths._lib import classic_noise
    x32 = np.load(BENCH / "data" / "x48.npy").astype(np.float32)
    call = SimpleNamespace(rows=2, noise_seed=2 ** 31 + 5)
    items = [(SimpleNamespace(offset=o, n=n, bucket=L), call, r)
             for r, (o, n) in enumerate(zip(OFFSETS, (L - 1000, L)))]
    xb = torch.zeros((2, L), dtype=torch.float64)
    for r, (req, _, _) in enumerate(items):
        xb[r, :req.n] = torch.from_numpy(x32[req.offset:req.offset + req.n])
    module = HarvestClassic(FS, L, FP, dtype=torch.float64, device="cpu")
    _, P, N = module.caps()
    noise = classic_noise(call.noise_seed, (2, P, N), "cpu").double()
    return {"path": path, "x32": x32, "items": items, "x": xb, "noise": noise,
            "module": module, "out": module(xb, noise=noise)}


def _strip(out, items) -> list:
    """Each request's own frames and samples of the module's rows, in the
    layout of the reference path's outputs."""
    res = []
    for r, (req, _, _) in enumerate(items):
        nf = int(1000 * req.n / FS / FP + 1)
        ny = int(np.floor((nf - 1) * FP / 1000 * FS)) + 1
        res.append({"f0": out["f0"][r, :nf], "vuv": out["vuv"][r, :nf],
                    "sp": out["spectrogram"][r, :, :nf].T,
                    "ap": out["aperiodicity"][r, :, :nf].T, "y": out["y"][r, :ny]})
    return res


def _largest_error(a, b) -> float:
    """max |a - b| over the largest |b|."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def test_matches_the_plain_reference_path_at_48_khz(case):
    """The module against the reference path the benchmark judges the cell
    with (benchmark/paths/harvest_classic.py), request by request, on the
    same rows and noise rows, and the path's synthesis of the module's own
    analysis against the module's waveform; the reference's analysis of
    the rows rounded to bfloat16 fails at least one of the same
    tolerances."""
    path, items = case["path"], case["items"]
    assert path.CONTROL == "tf32"
    cfg = {"fs": FS, "frame_period_ms": FP}
    out = case["out"]
    assert out["vuv"].any() and not out["_overflow"].any()
    got = _strip(out, items)
    refs = path.outputs(cfg, case["x32"], items, torch.float64, "cpu", gots=[got])
    for g, ref in zip(got, refs):
        for k in KEYS:
            assert g[k].shape == ref[k].shape, k
            assert _largest_error(g[k], ref[k]) <= REL_TOL, k
        assert _largest_error(g["y"], ref["y_syn"][0]) <= REL_TOL
    from reference import harvest_classic as RH
    low = RH.encode_classic_one(case["x"].to(torch.bfloat16).double(), FS, FP)
    assert max(_largest_error(low[k], case["out"][k]) for k in
               ("f0", "vuv", "spectrogram", "aperiodicity")) > REL_TOL


def test_rows_equal_single_calls(case):
    module, xb, noise = case["module"], case["x"], case["noise"]
    for r in range(2):
        one = module(xb[r], noise=noise[r:r + 1])
        for k in ("f0", "vuv", "spectrogram", "aperiodicity", "y", "_overflow"):
            assert torch.equal(one[k][0], case["out"][k][r]), (r, k)


def test_classic_caps_at_the_dio_default_are_unchanged():
    from world_tpu_torch.parallel.batch import (classic_caps, classic_rank_bound,
                                                classic_tables)

    want = {1: (16001, 1024, 404), 2: (32001, 2048, 404), 3: (48001, 4096, 404),
            4: (64001, 4096, 404), 5: (80001, 8192, 404)}
    for s, caps in want.items():
        assert classic_caps(16000 * s, 16000, 5) == caps
        assert classic_caps(16000 * s, 16000, 5, "dio") == caps
    assert classic_rank_bound(16000) == classic_rank_bound(16000, "dio") == 3
    with pytest.raises(ValueError, match="swipe"):
        classic_tables(16000, torch.float64, "cpu", "swipe")


@pytest.mark.parametrize("fs", [16000, 48000])
def test_harvest_caps_hold_a_contour_at_its_ceiling(fs):
    """Every frame voiced at Harvest's ceiling ((F0_CEIL + 1) times the
    smoothing's gain) fits the Harvest caps: no pulse past max_pulses and no
    slot past the overlap-add's passes.  Twice the ceiling does not."""
    from world_tpu_torch.parallel import batch as PB
    from world_tpu_torch.spectral.cheaptrick import default_fft_size

    n = int(0.4 * fs)
    y_length, P, N = PB.classic_caps(n, fs, FP, "harvest")
    ceiling = PB.classic_ceiling("harvest")
    assert ceiling == PB.harvest_ceiling() > 800.0
    frames = int(1000 * n / fs / FP + 1)
    bins = default_fft_size(fs) // 2 + 1
    g = torch.Generator().manual_seed(3)
    noise = torch.randn((1, P, N), generator=g, dtype=torch.float64)
    flags = []
    for f0 in (ceiling, 2 * ceiling):
        dat = {"f0": torch.full((1, frames), f0, dtype=torch.float64),
               "vuv": torch.ones((1, frames), dtype=torch.float64),
               "temporal_positions": torch.arange(frames, dtype=torch.float64)
               * FP / 1000,
               "spectrogram": torch.full((1, bins, frames), 1e-3, dtype=torch.float64),
               "aperiodicity": torch.full((1, bins, frames), 0.5, dtype=torch.float64)}
        y, overflow = PB.synthesize_classic(dat, noise, fs, n, FP, "harvest")
        assert y.shape == (1, y_length) and torch.isfinite(y).all()
        flags.append(bool(overflow[0]))
    assert flags == [False, True]


def test_a_patched_analysis_reaches_the_module(case, monkeypatch):
    from world_tpu_torch.parallel import batch

    analyze = batch.analyze

    def detuned(*args, **kw):
        out = dict(analyze(*args, **kw))
        out["f0"] = out["f0"] * 1.01
        return out

    monkeypatch.setattr(batch, "analyze", detuned)
    got = case["module"](case["x"][0], noise=case["noise"][:1])
    want = case["out"]
    assert torch.equal(got["vuv"][0], want["vuv"][0])
    voiced = want["vuv"][0] > 0
    assert torch.allclose(got["f0"][0][voiced], want["f0"][0][voiced] * 1.01,
                          rtol=1e-12)
    assert not torch.equal(got["y"][0], want["y"][0])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph replays and kernels K1, K2 "
                    "and K4-K8 are CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
def test_one_graph_replay_a_call_on_the_card(cuda):
    """At 48 kHz in float32 on the card: the first call runs eagerly, the
    second captures, the third replays, bitwise the eager call, with one
    launch of K2, K7 and K8 a replay and no capacity flag raised."""
    from world_tpu_torch import HarvestClassic
    from world_tpu_torch.ops import classic_pulses, d4c_spectra, refine_dft

    x = np.load(BENCH / "data" / "x48.npy")
    xb = torch.tensor(np.stack([x[o:o + FS] for o in OFFSETS]),
                      dtype=torch.float32, device=cuda)
    module = HarvestClassic(FS, FS, FP, dtype=torch.float32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    noise = torch.randn((2,) + module.caps()[1:], generator=g, device=cuda)
    eager = module(xb, noise=noise)
    module(xb, noise=noise)                                   # capture
    counters = (refine_dft.counter, d4c_spectra.band_ap_counter,
                classic_pulses.pulse_counter)
    before = [c.launches for c in counters]
    replay = module(xb, noise=noise)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1]
    # the capturing call replays its new graph for its outputs
    assert module.graphs.calls == {"eager": 1, "captured": 1, "replayed": 2}
    for k, v in eager.items():
        assert torch.equal(replay[k], v), k
    assert eager["vuv"].any() and not eager["_overflow"].any()
