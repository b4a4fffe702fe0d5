"""The rest of the port's World facade against world_tpu.World, in float64
on the CPU: the modification ops, save/load across the two packages, an
explicit fft_size, encode_w_gvn_f0, the analyses on a non-uniform frame
grid, and both syntheses after modify_duration.

Analyses are compared at 1e-9 of each output's scale (the sums' orders
differ, nothing else), host-side modification ops exactly.
"""
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

GOLDEN = Path(__file__).parent / "golden"
FS = 16000


def _rel_close(got, want, rtol=1e-9, key=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (key, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=key)


@pytest.fixture(scope="module")
def x_small():
    return np.asarray(np.load(GOLDEN / "harvest_small.npz")["x"], np.float64)


@pytest.fixture(scope="module")
def jax_world():
    from world_tpu import World

    return World()


@pytest.fixture(scope="module")
def cpu_world():
    from world_tpu_torch import World

    return World(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def dio_dat(cpu_world, x_small):
    """The port's default DIO analysis of harvest_small (held to the JAX
    package's in test_torch_classic.py)."""
    return cpu_world.encode(FS, x_small, f0_method="dio")


def _warped_source(dat):
    """dat's contour on a non-uniform grid: 0.2 -> 0.3 s, 0.5 -> 0.55 s."""
    from world_tpu import World

    src = {k: np.array(dat[k]) for k in ("f0", "vuv", "temporal_positions")}
    World().modify_duration(src, [0.2, 0.5], [0.3, 0.55])
    return src


# ---------------------------------------------------------------------------
# modification ops, persistence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("to_time", [[0.3, 0.55], [0.3, -1], [0.1, 0.45]])
def test_modify_duration_matches_jax(to_time, dio_dat, cpu_world, jax_world):
    a, b = copy.deepcopy(dio_dat), copy.deepcopy(dio_dat)
    given = list(to_time)
    assert cpu_world.modify_duration(a, [0.2, 0.5], given) is None
    jax_world.modify_duration(b, [0.2, 0.5], list(to_time))
    np.testing.assert_array_equal(a["temporal_positions"], b["temporal_positions"])
    assert given == to_time                     # the caller's list is untouched
    tp, end = a["temporal_positions"], dio_dat["temporal_positions"][-1]
    assert np.all(np.diff(tp) > 0)
    if to_time[-1] == -1:
        assert tp[-1] == pytest.approx(end)     # total duration preserved
    else:
        assert tp[-1] == pytest.approx(to_time[-1] + end - 0.5)


def test_modify_duration_refuses_bad_anchors(dio_dat, cpu_world):
    for frm, to in (([0.5, 0.2], [0.3, 0.6]), ([0.2, 0.5], [0.6, 0.3]),
                    ([0.2, 5.0], [0.3, 0.6]), ([0.0, 0.5], [0.3, 0.6])):
        with pytest.raises(AssertionError):
            cpu_world.modify_duration(copy.deepcopy(dio_dat), frm, to)


def test_scale_ops_match_jax(dio_dat, cpu_world, jax_world):
    a, b = copy.deepcopy(dio_dat), copy.deepcopy(dio_dat)
    assert cpu_world.scale_pitch(a, 1.5) is a
    assert cpu_world.scale_duration(a, 0.8) is a
    jax_world.scale_duration(jax_world.scale_pitch(b, 1.5), 0.8)
    np.testing.assert_array_equal(a["f0"], b["f0"])
    np.testing.assert_array_equal(a["temporal_positions"], b["temporal_positions"])
    np.testing.assert_array_equal(a["f0"], dio_dat["f0"] * 1.5)


@pytest.mark.parametrize("factor", [1.1, 0.9, 1.0])
def test_warp_spectrum_matches_jax(factor, dio_dat, cpu_world, jax_world):
    a, b = copy.deepcopy(dio_dat), copy.deepcopy(dio_dat)
    assert cpu_world.warp_spectrum(a, factor) is a
    jax_world.warp_spectrum(b, factor)
    assert isinstance(a["spectrogram"], np.ndarray)
    _rel_close(a["spectrogram"], b["spectrogram"], rtol=1e-12)
    if factor == 1.0:
        _rel_close(a["spectrogram"], dio_dat["spectrogram"], rtol=1e-12)


def test_set_pitch_is_unimplemented_as_in_the_reference(cpu_world, jax_world):
    for w in (cpu_world, jax_world):
        with pytest.raises(NotImplementedError):
            w.set_pitch({}, 0.1, 100.0)


@pytest.mark.parametrize("saver", ["torch", "jax"])
def test_save_by_one_package_load_by_the_other(saver, dio_dat, tmp_path):
    from world_tpu import World as JaxWorld
    from world_tpu_torch import World

    dat = dict(copy.deepcopy(dio_dat), coarse_ap=None, note="a b")
    dat["as_tensor"] = torch.arange(3.0) if saver == "torch" else np.arange(3.0)
    save, load = ((World.save, JaxWorld.load) if saver == "torch"
                  else (JaxWorld.save, World.load))
    path = tmp_path / "analysis.npz"
    save(dat, path)
    back = load(path)
    assert set(back) == set(dat)
    for k, v in dat.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
        else:
            assert back[k] == v and type(back[k]) is type(v), k


def test_draw_runs_headless(dio_dat, cpu_world, x_small, monkeypatch):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(len(plt.gcf().axes)))
    dat = cpu_world.decode(copy.deepcopy(dio_dat))
    cpu_world.draw(x_small, dat)
    plt.close("all")
    assert shown == [5]


# ---------------------------------------------------------------------------
# an explicit fft_size; encode_w_gvn_f0
# ---------------------------------------------------------------------------

ENCODE_KEYS = ("temporal_positions", "vuv", "f0", "aperiodicity",
               "ps spectrogram", "spectrogram")


@pytest.mark.parametrize("is_requiem", [False, True])
def test_encode_with_fft_size_matches_jax(is_requiem, cpu_world, jax_world,
                                          x_small):
    """fft_size 2048 lowers the F0 floor to 23.4 Hz before DIO, and sizes
    CheapTrick, classic D4C's spectrum and D4C-Requiem."""
    want = jax_world.encode(FS, x_small, f0_method="dio", fft_size=2048,
                            is_requiem=is_requiem)
    got = cpu_world.encode(FS, x_small, f0_method="dio", fft_size=2048,
                           is_requiem=is_requiem)
    assert got["spectrogram"].shape == (1025, 201)
    assert got["aperiodicity"].shape == ((3, 201) if is_requiem else (1025, 201))
    np.testing.assert_array_equal(got["vuv"], np.asarray(want["vuv"]))
    for k in ENCODE_KEYS:
        _rel_close(got[k], want[k], key=k)
    assert got["fs"] == want["fs"] and got["is_requiem"] == is_requiem


def test_get_spectrum_with_fft_size_matches_jax(cpu_world, jax_world, x_small):
    want = jax_world.get_spectrum(FS, x_small, f0_method="dio", fft_size=2048)
    got = cpu_world.get_spectrum(FS, x_small, f0_method="dio", fft_size=2048)
    assert set(got) == set(want)
    for k in ("f0", "temporal_positions", "spectrogram", "ps spectrogram"):
        _rel_close(got[k], want[k], key=k)


@pytest.mark.parametrize("f0_method", ["harvest", "dio", "swipe"])
def test_world_encode_with_fft_size_is_the_batch_analysis(f0_method):
    """World.encode(fft_size=...) is parallel/batch.py's analyze: the F0
    floor follows fft_size there too (the Harvest case runs more bands and
    longer refinement windows than the default)."""
    from world_tpu_torch import World
    from world_tpu_torch.parallel.batch import analyze

    fs, n, fp = 12000, 3072, 10
    t = np.arange(n) / fs
    x = 0.6 * np.sin(2 * np.pi * 150 * t) + 0.01 * np.random.RandomState(0).randn(n)
    dat = World(device="cpu").encode(fs, x, f0_method=f0_method, frame_period=fp,
                                     fft_size=1024, is_requiem=True)
    an = analyze(torch.tensor(x)[None], fs, fp, f0_method, True, fft_size=1024)
    np.testing.assert_array_equal(dat["f0"], an["f0"][0].numpy())
    np.testing.assert_array_equal(dat["spectrogram"], an["spectrogram"][0].T.numpy())
    np.testing.assert_array_equal(dat["aperiodicity"],
                                  an["aperiodicity"][0].T.numpy())
    assert dat["spectrogram"].shape[0] == 513
    voiced = dat["f0"][dat["f0"] > 0]
    assert voiced.size > 5 and 140 < np.median(voiced) < 160


@pytest.mark.parametrize("is_requiem", [False, True])
@pytest.mark.parametrize("grid", ["uniform", "warped"])
def test_encode_w_gvn_f0_matches_jax(grid, is_requiem, dio_dat, cpu_world,
                                     jax_world, x_small):
    src = ({k: np.array(dio_dat[k]) for k in ("f0", "vuv", "temporal_positions")}
           if grid == "uniform" else _warped_source(dio_dat))
    want = jax_world.encode_w_gvn_f0(FS, x_small, src, is_requiem=is_requiem)
    got = cpu_world.encode_w_gvn_f0(FS, x_small, copy.deepcopy(src),
                                    is_requiem=is_requiem)
    assert set(got) == set(want)
    for k in ("f0", "spectrogram", "aperiodicity"):
        _rel_close(got[k], want[k], key=k)
    np.testing.assert_array_equal(got["temporal_positions"],
                                  src["temporal_positions"])
    np.testing.assert_array_equal(got["vuv"], src["vuv"])
    if is_requiem:
        assert got["coarse_ap"] is None and want["coarse_ap"] is None
    else:
        _rel_close(got["coarse_ap"], want["coarse_ap"], key="coarse_ap")
    if grid == "uniform" and not is_requiem:
        # the default fft_size is CheapTrick's: the one-call analysis again
        _rel_close(got["spectrogram"], dio_dat["spectrogram"], rtol=1e-12)
        _rel_close(got["aperiodicity"], dio_dat["aperiodicity"], rtol=1e-12)


def test_encode_w_gvn_f0_names_the_floor(dio_dat, cpu_world, jax_world, x_small):
    src = {k: np.array(dio_dat[k]) for k in ("f0", "vuv", "temporal_positions")}
    src["f0"] = np.where(src["f0"] > 0, 30.0, 0.0)
    for w in (cpu_world, jax_world):
        with pytest.raises(ValueError, match=r"3\*fs/fft_size = 46\.88 Hz; min "
                                             r"voiced f0 = 30\.00 Hz"):
            w.encode_w_gvn_f0(FS, x_small, src)
    out = cpu_world.encode_w_gvn_f0(FS, x_small, src, fft_size=2048)
    assert out["spectrogram"].shape == (1025, 201)


# ---------------------------------------------------------------------------
# the dict-level analyses on a non-uniform frame grid
# ---------------------------------------------------------------------------

def test_cheaptrick_and_d4c_on_a_non_uniform_grid_match_jax(dio_dat, x_small):
    from world_tpu.aperiodicity.d4c import d4c as jax_d4c
    from world_tpu.aperiodicity.d4c_requiem import d4c_requiem as jax_d4c_requiem
    from world_tpu.spectral.cheaptrick import cheaptrick as jax_cheaptrick
    from world_tpu_torch.aperiodicity.d4c import d4c
    from world_tpu_torch.aperiodicity.d4c_requiem import d4c_requiem
    from world_tpu_torch.frames import uniform_frame_period_ms
    from world_tpu_torch.spectral.cheaptrick import cheaptrick

    src = _warped_source(dio_dat)
    assert uniform_frame_period_ms(src["temporal_positions"]) is None
    xt = torch.tensor(x_small)
    want = jax_cheaptrick(x_small, FS, src, fft_size=2048)
    got = cheaptrick(xt, FS, src, fft_size=2048)
    assert set(got) == set(want)
    for k in ("spectrogram", "ps spectrogram", "f0_effective"):
        _rel_close(got[k].numpy(), np.asarray(want[k]), key=k)
    want = jax_d4c(x_small, FS, src, fft_size_for_spectrum=2048)
    got = d4c(xt, FS, src, fft_size_for_spectrum=2048)
    for k in ("f0", "aperiodicity", "coarse_ap"):
        _rel_close(got[k].numpy(), np.asarray(want[k]), key=k)
    assert got["aperiodicity"].shape == (1025, 201)
    want = jax_d4c_requiem(x_small, FS, src)
    got = d4c_requiem(xt, FS, src)
    for k in ("f0", "aperiodicity"):
        _rel_close(got[k].numpy(), np.asarray(want[k]), key=k)


def test_gather_path_equals_the_uniform_path(dio_dat, x_small):
    """On the uniform grid itself, the anchors from temporal_positions
    (float64 floor) are the anchors of the exact integer arithmetic."""
    from world_tpu_torch.aperiodicity.common import frame_slabs

    x = torch.tensor(x_small)[None]
    tp = torch.tensor(dio_dat["temporal_positions"])
    a = frame_slabs(x, FS, 5.0, tp.shape[0], 300)
    b = frame_slabs(x, FS, None, tp.shape[0], 300, tp)
    assert torch.equal(a, b) and a.shape == (201, 601)


# ---------------------------------------------------------------------------
# synthesis after modify_duration (a non-uniform frame grid)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def warped_golden():
    """The first second of the 22.05 kHz golden parameters, time-warped.
    At 22.05 kHz the 500 Hz default period is 44.1 samples, so no pulse of
    an unvoiced stretch falls on an exact phase wrap, where the order of a
    running sum would decide its sample."""
    from world_tpu import World

    src = np.load(GOLDEN / "source_dio.npz")
    n = 200
    rng = np.random.RandomState(0)
    dat = {"f0": np.load(GOLDEN / "d4c.npz")["f0_after_mutation"][:n],
           "vuv": src["vuv"][:n], "temporal_positions": src["temporal_positions"][:n],
           "spectrogram": np.load(GOLDEN / "cheaptrick.npz")["spectrogram"][:, :n],
           "aperiodicity": np.load(GOLDEN / "d4c.npz")["aperiodicity"][:, :n],
           "fs": 22050, "is_requiem": False}
    World().modify_duration(dat, [0.3, 0.6], [0.4, -1])
    band = np.vstack([np.full(n, -60.0), rng.uniform(-30, -1, (2, n)),
                      np.full(n, -1e-12)])
    band[:, dat["vuv"] == 0] = -1e-12
    return dat, dict(dat, aperiodicity=band, is_requiem=True)


def test_requiem_decode_after_modify_duration_matches_jax(warped_golden,
                                                          cpu_world, jax_world):
    _, dat = warped_golden
    assert 0 < dat["vuv"].mean() < 1
    offsets = [5, 1234, 777, 31]
    want = jax_world.decode(copy.deepcopy(dat), seed=2,
                            noise_offsets=np.asarray(offsets))["out"]
    got = cpu_world.decode(copy.deepcopy(dat), seed=2, noise_offsets=offsets)["out"]
    fs, tp = dat["fs"], dat["temporal_positions"]
    assert got.shape == (len(np.arange(tp[0], tp[-1] + 1 / fs, 1.0 / fs)),)
    _rel_close(got, want, key="y")
    assert np.abs(got).max() > 0


def test_classic_decode_after_modify_duration_matches_jax(warped_golden):
    """The classic synthesis cores on the warped grid with one explicit
    draw (the two packages' generators differ), then World.decode: finite,
    of the warped length, and the generator's draw."""
    import jax
    import jax.numpy as jnp

    from world_tpu.synth.classic import _synthesis_core as jax_core
    from world_tpu_torch import World
    from world_tpu_torch.synth.classic import (default_max_pulses,
                                               max_noise_length, synthesis_core)

    dat, _ = warped_golden
    # every frame voiced, as in test_torch_classic.py: at the 500 Hz of an
    # unvoiced stretch every 441st sample is an exact phase wrap, the order
    # of the running sum decides which of two samples holds the pulse (the
    # fractional shift makes up for it), and the pulse's noise row moves by
    # that sample
    dat = dict(dat, f0=np.where(dat["vuv"] > 0, dat["f0"], 137.0),
               vuv=np.ones_like(dat["vuv"]))
    fs, tp = dat["fs"], dat["temporal_positions"]
    y_len = len(np.arange(tp[0], tp[-1] + 1 / fs, 1.0 / fs))
    fft_size = (dat["spectrogram"].shape[0] - 1) * 2
    mp, mn = default_max_pulses(tp, dat["f0"]), max_noise_length(fs)
    key = jax.random.PRNGKey(4)
    draw = np.asarray(jax.random.normal(key, (mp, mn), dtype=jnp.float64))
    names = ("f0", "vuv", "temporal_positions", "spectrogram", "aperiodicity")
    want, _ = jax_core(*(jnp.asarray(dat[k]) for k in names), key, fs, y_len,
                       fft_size, mp, mn, "gaussian", "standard", 48, None)
    got, over = synthesis_core(*(torch.tensor(dat[k]) for k in names),
                               torch.tensor(draw), fs, y_len, fft_size, mp, mn,
                               "gaussian", "standard", None)
    assert not bool(over)
    _rel_close(got.numpy(), np.asarray(want), rtol=1e-8, key="y")
    y = World(device="cpu").decode(copy.deepcopy(dat),
                                   key=torch.Generator().manual_seed(1))["out"]
    assert y.shape == (y_len,) and np.all(np.isfinite(y)) and np.abs(y).max() > 0


def test_swipe_encode_decode_matches_jax(cpu_world, jax_world, x_small):
    """Path A on the CPU: encode(f0_method="swipe") against the JAX package,
    then decode."""
    want = jax_world.encode(FS, x_small, f0_method="swipe", is_requiem=True)
    got = cpu_world.encode(FS, x_small, f0_method="swipe", is_requiem=True)
    np.testing.assert_array_equal(got["vuv"], np.asarray(want["vuv"]))
    for k in ENCODE_KEYS:
        _rel_close(got[k], want[k], key=k)
    y = cpu_world.decode(got)["out"]
    assert np.all(np.isfinite(y)) and np.abs(y).max() > 0


# ---------------------------------------------------------------------------
# the small modules around the facade: dsp/zc.py, io/, utils/profiling.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [64, 7])
def test_zero_crossing_events_match_jax(capacity):
    import jax.numpy as jnp

    from world_tpu.dsp.zc import zero_crossing_events as jax_events
    from world_tpu_torch.dsp.zc import zero_crossing_events

    rng = np.random.RandomState(3)
    t = np.arange(2000) / 4000.0
    x = np.sin(2 * np.pi * 93.0 * t + 0.3) + 0.05 * rng.randn(2000)
    want = jax_events(jnp.asarray(x), 4000.0, capacity)
    got = zero_crossing_events(torch.tensor(x), 4000.0, capacity)
    assert int(got.count) == int(want.count) == min(capacity, int(want.count))
    np.testing.assert_allclose(got.locations.numpy(), np.asarray(want.locations),
                               rtol=1e-14, atol=0)
    np.testing.assert_allclose(got.f0.numpy(), np.asarray(want.f0), rtol=1e-12,
                               atol=0)
    if capacity == 64:
        n = int(got.count)
        assert 40 < n < 64 and abs(np.median(got.f0.numpy()[:n]) - 93.0) < 3.0
    flat = zero_crossing_events(torch.ones(50, dtype=torch.float64), 4000.0, 8)
    assert int(flat.count) == 0 and not flat.f0.any()


def test_wav_io_roundtrip(tmp_path):
    from world_tpu.io.wav import read_wav as jax_read
    from world_tpu_torch.io import native
    from world_tpu_torch.io.wav import read_wav, write_wav

    y = np.sin(np.linspace(0, 100, 4000)) * 0.5
    p = tmp_path / "t.wav"
    write_wav(p, 16000, y)
    fs, back = read_wav(p)
    assert fs == 16000 and back.dtype == np.float64
    np.testing.assert_allclose(back, y, atol=1e-4)
    fs2, back2 = jax_read(p)
    assert fs2 == fs
    np.testing.assert_array_equal(back, back2)
    # the native path reads what the scipy path wrote, or falls back to it
    fs3, back3 = native.read_wav(p)
    assert fs3 == 16000
    np.testing.assert_allclose(back3, y, atol=1e-4)
    native.write_wav(tmp_path / "n.wav", 16000, y)
    np.testing.assert_allclose(read_wav(tmp_path / "n.wav")[1], y, atol=1e-4)


def test_xrt_meter_timed_and_trace(tmp_path):
    """Per-stage wall time and xRT over calls, from the tracer's spans and
    sample counters (what XrtMeter measured before), then ``timed`` and
    ``device_trace``, whose Chrome trace holds the tracer's spans."""
    import json
    import time

    from world_tpu_torch.utils.profiling import Tracer, device_trace, timed

    tr = Tracer()
    with tr.tracing():
        with tr.span("world.test.call", fs=16000):
            tr.count("samples.true", 16000)
            with tr.span("world.test.stage_a"):
                time.sleep(0.01)
    stage, call = tr.spans()
    assert stage.parent == call.id and stage.call == call.id
    assert call.host_ms >= stage.host_ms >= 10.0
    xrt = call.counts["samples.true"] / call.attrs["fs"] / (call.host_ms / 1e3)
    assert 0 < xrt <= 100
    dt, out = timed(lambda a: {"y": a * 2}, torch.ones(8), repeats=2)
    assert dt >= 0 and bool((out["y"] == 2).all())
    with device_trace(str(tmp_path / "trace")):
        with tr.span("world.test.traced"):
            torch.ones(4).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert "world.test.traced" in {e.get("name") for e in trace["traceEvents"]}
