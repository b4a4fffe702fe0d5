"""Classic D4C, classic synthesis, the classic round trip and the World
facade in the port against the JAX package and the goldens, in float64 on
the CPU.

  * Classic synthesis on the golden parameters (source_dio.npz,
    cheaptrick.npz, d4c.npz) with ``noise_mode="constant"`` against
    synthesis.npz ``y_det``: test_synthesis.py's bars (> 90% of samples
    within 1e-9 of scale, correlation > 0.995), and the port's own tighter
    bar, relative L2 error < 1e-9.  The port's phase cumsum is sequential,
    as the reference's is, so its pulses are the golden ones exactly.
  * Classic synthesis (both variants) against JAX ``_synthesis_core`` fed
    the same standard-normal draw: variant "a" to 1e-9 of scale, the
    standard variant to 1e-8.  XLA sums the phase cumsum as a tree, the
    port sequentially as the reference does; late in the utterance the two
    phases differ by ~1e-12 rad, which moves the standard variant's
    fractional pulse shifts by up to 3e-8 samples (variant "a" has none).
    The contour is the golden one with every frame voiced (unvoiced frames
    at 137 Hz, left to the aperiodicity gate): unvoiced stretches run at
    the 500 Hz default, whose phase steps at 22.05 kHz return to a multiple
    of 2*pi exactly every 441 samples, and there the two sums place the
    wrap on neighbouring samples.
  * ``d4c_core`` against JAX ``_d4c_core`` on harvest_small.npz ``x``:
    aperiodicity, coarse_ap and f0 to 1e-9 of scale.
  * ``encode_decode_classic_one`` against ``_encode_decode_classic_one`` at
    test_robustness.py's tiny shape (fs 12000, 3072 samples, 10 ms) with
    the JAX draw: every output to 1e-9 of scale, vuv exactly.
  * ``encode_classic_one`` against ``_encode_classic_one`` on
    harvest_16k.npz ``x16`` (4.644 s): vuv exactly; f0 to 1e-9 of scale;
    the aperiodicity to 1e-8 (one unvoiced frame differs by 1.1e-9); the
    spectrogram to 1e-9 of scale against the JAX CheapTrick run on its own
    on the composite's contour.  Inside the one fused JAX program the
    unvoiced frames' envelopes come out up to 11% off both that and the
    float64 golden of harvest_16k.npz, which the port meets to 5e-9; the
    voiced frames are held to the fused program too.
  * ``World(device="cpu")``: encode with DIO for both D4Cs against the JAX
    World; the default encode (Harvest + classic D4C) against the JAX
    CheapTrick and D4C fed the port's Harvest contour (Harvest itself is
    held to JAX in test_torch_harvest.py; the JAX Harvest program at the
    World's table sizes takes minutes to compile here); get_f0 and
    get_spectrum; decode from an explicit generator; encode equals
    parallel/batch.py's ``analyze`` bit for bit at the tiny shape; and no
    device without CUDA raises.
"""
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

GOLDEN = Path(__file__).parent / "golden"
FS_SMALL = 16000
TINY_FS, TINY_N, TINY_FP = 12000, 3072, 10


def _rel_close(got, want, rtol=1e-9, key=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (key, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=key)


# ---------------------------------------------------------------------------
# classic synthesis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_dat():
    src = np.load(GOLDEN / "source_dio.npz")
    ct = np.load(GOLDEN / "cheaptrick.npz")
    d4 = np.load(GOLDEN / "d4c.npz")
    return {"f0": d4["f0_after_mutation"], "vuv": src["vuv"],
            "temporal_positions": src["temporal_positions"],
            "spectrogram": ct["spectrogram"], "aperiodicity": d4["aperiodicity"],
            "fs": 22050}


def test_synthesis_matches_golden_y_det(golden_dat):
    from world_tpu_torch.synth.classic import synthesis

    ref = np.load(GOLDEN / "synthesis.npz")["y_det"]
    y = synthesis(golden_dat, golden_dat, noise_mode="constant",
                  device="cpu").numpy()
    assert y.shape == ref.shape
    scale = np.abs(ref).max()
    assert (np.abs(y - ref) < 1e-9 * max(scale, 1.0)).mean() > 0.90
    assert np.corrcoef(y, ref)[0, 1] > 0.995
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-9


def test_pulse_locations_match_golden(golden_dat):
    from world_tpu_torch.synth.classic import time_base

    g = np.load(GOLDEN / "synthesis.npz")
    fs = golden_dat["fs"]
    tp = golden_dat["temporal_positions"]
    y_len = len(np.arange(tp[0], tp[-1] + 1 / fs, 1 / fs))
    time_axis = torch.arange(y_len, dtype=torch.float64) / fs + tp[0]
    locs, pli, shift, _, count = time_base(
        torch.tensor(tp), torch.tensor(golden_dat["f0"]),
        torch.tensor(golden_dat["vuv"]), float(fs), time_axis, 4096,
        frame_period_s=0.005)
    assert count == g["pulse_locations"].shape[0]
    # the static pulse axis: the slots past the count are not pulses
    locs, pli, shift = (t[:int(count)] for t in (locs, pli, shift))
    np.testing.assert_allclose(locs.numpy(), g["pulse_locations"], rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(pli.numpy(), g["pulse_locations_index"])
    # the shifts to 1e-9 of a sample
    np.testing.assert_allclose(shift.numpy(), g["pulse_time_shift"], rtol=0,
                               atol=1e-9 / fs)


@pytest.mark.parametrize("variant,rtol", [("standard", 1e-8), ("a", 1e-9)])
def test_synthesis_matches_jax_with_the_same_draw(golden_dat, variant, rtol):
    import jax
    import jax.numpy as jnp

    from world_tpu.synth.classic import _synthesis_core as jax_core
    from world_tpu_torch.synth.classic import (default_max_pulses,
                                               max_noise_length, synthesis_core)

    fs = golden_dat["fs"]
    tp = golden_dat["temporal_positions"]
    f0 = np.where(golden_dat["vuv"] > 0, golden_dat["f0"], 137.0)
    vuv = np.ones_like(f0)
    spec, ap = golden_dat["spectrogram"], golden_dat["aperiodicity"]
    y_len = len(np.arange(tp[0], tp[-1] + 1 / fs, 1 / fs))
    fft_size = (spec.shape[0] - 1) * 2
    mp, mn = default_max_pulses(tp, f0), max_noise_length(fs)
    key = jax.random.PRNGKey(3)
    draw = np.asarray(jax.random.normal(key, (mp, mn), dtype=jnp.float64))
    want, want_over = jax_core(jnp.asarray(f0), jnp.asarray(vuv), jnp.asarray(tp),
                               jnp.asarray(spec), jnp.asarray(ap), key, fs, y_len,
                               fft_size, mp, mn, "gaussian", variant, 48, 0.005)
    got, over = synthesis_core(torch.tensor(f0), torch.tensor(vuv),
                               torch.tensor(tp), torch.tensor(spec),
                               torch.tensor(ap), torch.tensor(draw), fs, y_len,
                               fft_size, mp, mn, "gaussian", variant, 0.005)
    assert bool(over) == bool(want_over)
    _rel_close(got.numpy(), np.asarray(want), rtol=rtol, key="y")


def test_float32_eps_floor_of_classic_synthesis(golden_dat):
    """A float32 fault of the JAX package: its classic synthesis floors the
    envelope x periodicity at finfo(float32).eps = 1.19e-7 before the
    logarithm, above most of the golden spectrum's values, and misses the
    golden waveform's bars (correlation > 0.999, relative L2 < 1e-2).  The
    port floors at float64's eps in every type and meets them in float32."""
    from world_tpu.synth.classic import synthesis as jax_synthesis
    from world_tpu_torch.synth.classic import synthesis

    ref = np.load(GOLDEN / "synthesis.npz")["y_det"]
    dat32 = {k: (np.asarray(v, np.float32) if k != "fs" else v)
             for k, v in golden_dat.items()}

    def bars(y):
        y = np.asarray(y, np.float64)
        return (np.corrcoef(y, ref)[0, 1],
                np.linalg.norm(y - ref) / np.linalg.norm(ref))

    jax_corr, jax_rel = bars(jax_synthesis(dat32, dat32, noise_mode="constant"))
    corr, rel = bars(synthesis(dat32, dat32, noise_mode="constant",
                               dtype=torch.float32, device="cpu"))
    assert jax_corr < 0.999 or jax_rel > 1e-2, (jax_corr, jax_rel)
    assert corr > 0.999 and rel < 1e-2, (corr, rel)


def test_synthesis_takes_its_noise_from_the_generator(golden_dat):
    """The same generator seed gives the same waveform, another seed
    another one; the global RNG is never read."""
    from world_tpu_torch.synth.classic import synthesis

    def run(seed):
        return synthesis(golden_dat, golden_dat, device="cpu",
                         generator=torch.Generator().manual_seed(seed)).numpy()

    torch.manual_seed(0)
    a = run(5)
    torch.manual_seed(1)
    b = run(5)
    c = run(6)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-3
    assert np.all(np.isfinite(a))


def test_synthesis_a_matches_jax(golden_dat):
    """The public synthesis_a with the constant noise, against the JAX
    package's, to 1e-9 of scale."""
    from world_tpu.synth.classic import synthesis_a as jax_synthesis_a
    from world_tpu_torch.synth.classic import synthesis_a

    want = np.asarray(jax_synthesis_a(golden_dat, golden_dat,
                                      noise_mode="constant"))
    got = synthesis_a(golden_dat, golden_dat, noise_mode="constant",
                      device="cpu").numpy()
    _rel_close(got, want, key="y")


# ---------------------------------------------------------------------------
# D4C and the World facade on harvest_small.npz
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def x_small():
    return np.asarray(np.load(GOLDEN / "harvest_small.npz")["x"])


@pytest.fixture(scope="module")
def jax_world():
    from world_tpu import World as JaxWorld

    return JaxWorld()


@pytest.fixture(scope="module")
def cpu_world():
    from world_tpu_torch import World

    return World(device="cpu")


@pytest.fixture(scope="module")
def jax_dio_dat(jax_world, x_small):
    return jax_world.encode(FS_SMALL, x_small, f0_method="dio")


@pytest.fixture(scope="module")
def cpu_harvest(cpu_world, x_small):
    """World's default analysis of x_small (Harvest, classic D4C) and its
    default contour (Harvest), computed once for the tests that read them."""
    return {"encode": cpu_world.encode(FS_SMALL, x_small),
            "f0": cpu_world.get_f0(FS_SMALL, x_small)}


def test_d4c_core_matches_jax(x_small, jax_dio_dat):
    import jax.numpy as jnp

    from world_tpu.aperiodicity.d4c import _d4c_core as jax_d4c
    from world_tpu_torch.aperiodicity import d4c as D4C
    from world_tpu_torch.aperiodicity.common import d4c_fft_size

    f0 = np.asarray(jax_dio_dat["f0"])
    tp = np.asarray(jax_dio_dat["temporal_positions"])
    assert (f0 > 0).sum() > 10
    fi, n_ap = D4C.frequency_interval(FS_SMALL), D4C.n_bands(FS_SMALL)
    args = (FS_SMALL,)
    want = jax_d4c(jnp.asarray(x_small), *args, jnp.asarray(f0), jnp.asarray(tp),
                   d4c_fft_size(FS_SMALL), 1024, 0.85, fi, n_ap, 5.0)
    got = D4C.d4c_core(torch.tensor(x_small)[None], *args, torch.tensor(f0)[None],
                       torch.tensor(tp), d4c_fft_size(FS_SMALL), 1024, 0.85, fi,
                       n_ap, 5.0)
    for name, g, w in zip(("aperiodicity", "coarse_ap", "f0"), got, want):
        _rel_close(g[0].numpy(), np.asarray(w), key=name)


def test_public_dio_stonemask_d4c_match_jax(x_small, jax_dio_dat):
    """dio, stonemask and d4c on one utterance (n,), with the JAX package's
    signatures and outputs, to 1e-9 of scale."""
    from world_tpu.aperiodicity.d4c import d4c as jax_d4c
    from world_tpu.f0.dio import dio as jax_dio
    from world_tpu.f0.stonemask import stonemask as jax_stonemask
    from world_tpu_torch.aperiodicity.d4c import d4c
    from world_tpu_torch.f0.dio import dio
    from world_tpu_torch.f0.stonemask import stonemask

    xt = torch.tensor(x_small)
    want = jax_dio(x_small, FS_SMALL)
    got = dio(xt, FS_SMALL)
    for key in ("f0", "vuv", "temporal_positions", "f0_candidates"):
        _rel_close(got[key].numpy(), np.asarray(want[key]), key=key)
    tp, f0 = got["temporal_positions"], got["f0"]
    refined = stonemask(xt, FS_SMALL, tp, f0)
    _rel_close(refined.numpy(), np.asarray(jax_stonemask(
        x_small, FS_SMALL, np.asarray(tp), np.asarray(f0))), key="stonemask")
    source = {"f0": jax_dio_dat["f0"], "vuv": jax_dio_dat["vuv"],
              "temporal_positions": jax_dio_dat["temporal_positions"]}
    want = jax_d4c(x_small, FS_SMALL, source)
    got = d4c(xt, FS_SMALL, source)
    for key in ("f0", "aperiodicity", "coarse_ap"):
        _rel_close(got[key].numpy(), np.asarray(want[key]), key=key)


ENCODE_KEYS = ("temporal_positions", "vuv", "f0", "aperiodicity",
               "ps spectrogram", "spectrogram")


def _assert_dat_close(got, want):
    for key in ENCODE_KEYS:
        if key == "vuv":
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
        else:
            _rel_close(got[key], np.asarray(want[key]), key=key)
    assert got["fs"] == int(want["fs"])
    assert got["is_requiem"] == bool(want["is_requiem"])


@pytest.mark.parametrize("is_requiem", [False, True])
def test_world_dio_encode_matches_jax(is_requiem, cpu_world, jax_world,
                                      jax_dio_dat, x_small):
    want = (jax_dio_dat if not is_requiem else
            jax_world.encode(FS_SMALL, x_small, f0_method="dio", is_requiem=True))
    got = cpu_world.encode(FS_SMALL, x_small, f0_method="dio",
                           is_requiem=is_requiem)
    _assert_dat_close(got, want)


def test_world_default_encode_matches_jax_stages(cpu_harvest, x_small):
    """World().encode(fs, x): Harvest, CheapTrick, classic D4C.  The JAX
    CheapTrick and D4C run on the port's Harvest contour."""
    from world_tpu.aperiodicity.d4c import d4c as jax_d4c
    from world_tpu.spectral.cheaptrick import cheaptrick as jax_cheaptrick

    got = cpu_harvest["encode"]
    assert not got["is_requiem"] and got["aperiodicity"].shape == (513, 201)
    tp, f0, vuv = cpu_harvest["f0"]
    source = {"temporal_positions": tp, "f0": f0, "vuv": vuv}
    filt = jax_cheaptrick(x_small, FS_SMALL, source)
    src2 = jax_d4c(x_small, FS_SMALL, dict(source, f0=filt["f0_effective"]))
    want = {"temporal_positions": tp, "vuv": vuv, "f0": src2["f0"],
            "aperiodicity": src2["aperiodicity"],
            "ps spectrogram": filt["ps spectrogram"],
            "spectrogram": filt["spectrogram"], "fs": FS_SMALL,
            "is_requiem": False}
    _assert_dat_close(got, want)


@pytest.mark.parametrize("f0_method", ["dio", "harvest"])
def test_world_get_f0_and_get_spectrum(f0_method, cpu_world, jax_world,
                                       jax_dio_dat, x_small, cpu_harvest):
    if f0_method == "harvest":          # the defaults' calls, made once
        (tp, f0, vuv), enc = cpu_harvest["f0"], cpu_harvest["encode"]
    else:
        tp, f0, vuv = cpu_world.get_f0(FS_SMALL, x_small, f0_method=f0_method)
        enc = cpu_world.encode(FS_SMALL, x_small, f0_method=f0_method)
    spec = cpu_world.get_spectrum(FS_SMALL, x_small, f0_method=f0_method)
    np.testing.assert_array_equal(spec["spectrogram"], enc["spectrogram"])
    np.testing.assert_array_equal(spec["temporal_positions"], tp)
    if f0_method == "dio":
        # the StoneMask-refined contour, as the JAX World returns it
        _, want_f0, want_vuv = jax_world.get_f0(FS_SMALL, x_small, "dio")
        _rel_close(f0, want_f0, key="f0")
        np.testing.assert_array_equal(vuv, np.asarray(want_vuv))
        _rel_close(spec["spectrogram"], jax_dio_dat["spectrogram"],
                   key="spectrogram")
    else:
        assert ((f0 > 0) == (vuv > 0)).all() and vuv.sum() > 10
    # an explicit fft_size sizes the envelope; get_spectrum keeps the F0
    # floor it was given (encode lowers it to 3 fs / fft_size)
    wide = cpu_world.get_spectrum(FS_SMALL, x_small, f0_method=f0_method,
                                  fft_size=2048)
    assert wide["spectrogram"].shape == (1025, tp.shape[0])
    np.testing.assert_array_equal(wide["f0"], spec["f0"])


def test_world_classic_decode_draws_from_the_given_generator(cpu_world,
                                                             x_small):
    """decode(dat, key=generator) synthesizes with that generator's draw;
    without one, with a generator seeded 0."""
    from world_tpu_torch.synth.classic import (default_max_pulses,
                                               max_noise_length, synthesis)

    dat = cpu_world.encode(FS_SMALL, x_small, f0_method="dio")
    y = cpu_world.decode(dict(dat), key=torch.Generator().manual_seed(9))["out"]
    mp = default_max_pulses(dat["temporal_positions"], dat["f0"])
    draw = torch.randn((mp, max_noise_length(FS_SMALL)),
                       generator=torch.Generator().manual_seed(9),
                       dtype=torch.float64)
    want = synthesis(dat, dat, noise=draw, device="cpu").numpy()
    want = want / max(1.0, np.abs(want).max())
    np.testing.assert_array_equal(y, want)
    y0 = cpu_world.decode(dict(dat))["out"]
    y0_again = cpu_world.decode(dict(dat), key=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(y0, y0_again["out"])
    assert y.shape == (16001,) and np.all(np.isfinite(y)) and np.abs(y).max() > 0


@pytest.mark.parametrize("f0_method,is_requiem", [("dio", False),
                                                  ("harvest", True)])
def test_world_encode_is_the_batch_analysis(f0_method, is_requiem):
    """World.encode is parallel/batch.py's analysis of a batch of one:
    equal outputs, bit for bit."""
    from world_tpu_torch import World
    from world_tpu_torch.parallel.batch import analyze

    x = _tiny_signal()
    got = World(device="cpu").encode(TINY_FS, x, f0_method=f0_method,
                                     frame_period=TINY_FP, is_requiem=is_requiem)
    an = analyze(torch.tensor(x)[None], TINY_FS, TINY_FP, f0_method, is_requiem)
    for key, want in (("f0", an["f0"][0]), ("vuv", an["vuv"][0]),
                      ("temporal_positions", an["temporal_positions"]),
                      ("spectrogram", an["spectrogram"][0].T),
                      ("ps spectrogram", an["ps_spectrogram"][0].T),
                      ("aperiodicity", an["aperiodicity"][0].T)):
        np.testing.assert_array_equal(got[key], want.numpy(), err_msg=key)


def test_no_device_without_cuda_raises():
    from world_tpu_torch import DioClassic, HarvestRequiem, World

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the GPU")
    for make in (World, lambda: HarvestRequiem(12000, 3072),
                 lambda: DioClassic(12000, 3072)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


# ---------------------------------------------------------------------------
# the classic round trip against the JAX composites
# ---------------------------------------------------------------------------

def _tiny_signal(seed=0):
    t = np.arange(TINY_N) / TINY_FS
    rng = np.random.RandomState(seed)
    return (0.6 * (np.sin(2 * np.pi * 150 * t) + 0.3 * np.sin(2 * np.pi * 300 * t))
            + 0.01 * rng.randn(TINY_N))


@pytest.fixture(scope="module")
def tiny_pair():
    import jax
    import jax.numpy as jnp

    from world_tpu.parallel.batch import _encode_decode_classic_one
    from world_tpu_torch import encode_decode_classic_one
    from world_tpu_torch.parallel.batch import classic_caps

    x = _tiny_signal()
    key = jax.random.PRNGKey(0)
    fn = jax.jit(partial(_encode_decode_classic_one, fs=TINY_FS,
                         frame_period=TINY_FP))
    want = {k: np.asarray(v) for k, v in fn(jnp.asarray(x), key).items()}
    _, mp, mn = classic_caps(TINY_N, TINY_FS, TINY_FP)
    draw = np.asarray(jax.random.normal(key, (mp, mn), dtype=jnp.float64))
    got = encode_decode_classic_one(torch.tensor(x)[None], TINY_FS, TINY_FP,
                                    noise=torch.tensor(draw)[None])
    got = {k: (v.numpy() if k == "temporal_positions" else v[0].numpy())
           for k, v in got.items()}
    return got, want, draw


TINY_OUTPUTS = ("f0", "vuv", "temporal_positions", "spectrogram", "aperiodicity",
                "y", "_overflow")


def _assert_tiny_close(got, want, key):
    if key in ("vuv", "_overflow"):
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        _rel_close(got, want, key=key)


@pytest.mark.parametrize("key", TINY_OUTPUTS)
def test_encode_decode_classic_matches_jax_tiny(key, tiny_pair):
    got, want, _ = tiny_pair
    _assert_tiny_close(got[key], want[key], key)


def test_dio_classic_with_jax_tables_matches_jax(tiny_pair):
    """DioClassic loaded with the JAX package's own tables computes what the
    JAX round trip computes."""
    from test_torch_state import jax_dio_state
    from world_tpu_torch import DioClassic

    _, want, draw = tiny_pair
    module = DioClassic(TINY_FS, TINY_N, frame_period=TINY_FP,
                        dtype=torch.float64, device="cpu")
    module.from_numpy_state(jax_dio_state(TINY_FS))
    out = module(torch.tensor(_tiny_signal()), noise=torch.tensor(draw)[None])
    for key in TINY_OUTPUTS:
        got = out[key] if key == "temporal_positions" else out[key][0]
        _assert_tiny_close(got.numpy(), want[key], key)


def test_tiny_round_trip_is_voiced_at_150_hz(tiny_pair):
    got, _, _ = tiny_pair
    voiced = got["f0"][got["f0"] > 0]
    assert voiced.size > 10 and 140 < np.median(voiced) < 160
    assert np.all(np.isfinite(got["y"])) and np.abs(got["y"]).max() > 0


@pytest.fixture(scope="module")
def x16_pair():
    import jax
    import jax.numpy as jnp

    from world_tpu.parallel.batch import _encode_classic_one
    from world_tpu.spectral.cheaptrick import _cheaptrick_core, default_fft_size
    from world_tpu_torch import encode_classic_one

    g = np.load(GOLDEN / "harvest_16k.npz")
    x16, fs = np.asarray(g["x16"]), int(g["fs"])
    fn = jax.jit(partial(_encode_classic_one, fs=fs, frame_period=5))
    want = {k: np.asarray(v) for k, v in fn(jnp.asarray(x16)).items()}
    f0_ct = np.where(want["vuv"] == 0, 500.0, want["f0"])
    env = _cheaptrick_core(jnp.asarray(x16), fs, jnp.asarray(f0_ct),
                           jnp.asarray(want["temporal_positions"]),
                           default_fft_size(fs), -0.15, 5.0)[0]
    want["spectrogram_standalone"] = np.asarray(env).T
    got = encode_classic_one(torch.tensor(x16)[None], fs, 5)
    got = {k: (v.numpy() if k == "temporal_positions" else v[0].numpy())
           for k, v in got.items()}
    return got, want


@pytest.mark.parametrize("key", ["f0", "vuv", "temporal_positions",
                                 "spectrogram", "aperiodicity"])
def test_encode_classic_matches_jax_x16(key, x16_pair):
    got, want = x16_pair
    if key == "vuv":
        np.testing.assert_array_equal(got[key], want[key])
        assert 0.2 < got[key].mean() < 0.9
    elif key == "spectrogram":
        _rel_close(got[key], want["spectrogram_standalone"], key=key)
        voiced = want["vuv"] > 0
        _rel_close(got[key][:, voiced], want[key][:, voiced], key="voiced")
    else:
        _rel_close(got[key], want[key], key=key,
                   rtol=1e-8 if key == "aperiodicity" else 1e-9)


def test_dio_classic_module_equals_the_function():
    from world_tpu_torch import DioClassic, encode_decode_classic_one
    from world_tpu_torch.parallel.batch import classic_caps

    xs = np.stack([_tiny_signal(s) for s in range(2)])
    _, mp, mn = classic_caps(TINY_N, TINY_FS, TINY_FP)
    noise = torch.randn((2, mp, mn), generator=torch.Generator().manual_seed(1),
                        dtype=torch.float64)
    module = DioClassic(TINY_FS, TINY_N, frame_period=TINY_FP,
                        dtype=torch.float64, device="cpu")
    got = module(torch.tensor(xs), noise=noise)
    want = encode_decode_classic_one(torch.tensor(xs), TINY_FS, TINY_FP,
                                     noise=noise)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    single = module(torch.tensor(xs[1]), noise=noise[1:])
    for key in ("f0", "vuv", "spectrogram", "aperiodicity"):
        torch.testing.assert_close(single[key][0], got[key][1], rtol=1e-12,
                                   atol=1e-12)
    with pytest.raises(ValueError):
        module(torch.zeros(TINY_N + 1, dtype=torch.float64))


def test_x16_unvoiced_envelopes_match_golden(x16_pair):
    """On frames unvoiced for DIO and for the golden Harvest contour, CheapTrick
    runs at 500 Hz in both, so harvest_16k.npz's float64 envelope is the
    reference's own: the port meets it to 1e-8 of each frame's peak."""
    got, _ = x16_pair
    g = np.load(GOLDEN / "harvest_16k.npz")
    both = (got["vuv"] == 0) & (g["vuv"] == 0)
    assert both.sum() > 100
    spec, gold = got["spectrogram"][:, both], g["spectrogram"][:, both]
    per_frame = np.abs(spec - gold).max(axis=0) / np.abs(gold).max(axis=0)
    assert per_frame.max() < 1e-8, per_frame.max()
