"""SWIPE' in the port against the JAX package, in float64 on the CPU.

Both sides build the same static tables on the host (compared bit for bit)
and run the same operations; the products sum in another order, and the
result is a pitch on a discrete fine grid (2 ** (k / 768)), so f0 is held
to rtol 1e-8 and vuv exactly.  The float32 run is held to the port's own
float64 run at tests/test_swipe.py's bars.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

GOLDEN = Path(__file__).parent / "golden"
FS = 16000
PLIM = (71, 800)


@pytest.fixture(scope="module")
def x_small():
    return np.asarray(np.load(GOLDEN / "harvest_small.npz")["x"], np.float64)


@pytest.fixture(scope="module")
def x16():
    return np.asarray(np.load(GOLDEN / "harvest_16k.npz")["x16"], np.float64)


def _jax_swipe(x, **kw):
    from world_tpu.f0.swipe import swipe

    return {k: np.asarray(v) for k, v in swipe(FS, x, plim=PLIM, **kw).items()}


def _torch_swipe(x, dtype=torch.float64, **kw):
    from world_tpu_torch.f0.swipe import swipe

    out = swipe(FS, x, plim=PLIM, dtype=dtype, device="cpu", **kw)
    return {k: v.numpy() for k, v in out.items()}


def _jax_config():
    from world_tpu.f0.swipe import _static_config

    return _static_config(FS, PLIM, 1 / 96, 0.1, 2)


def test_static_config_equals_jax_bit_for_bit():
    from world_tpu_torch.f0.swipe import static_config

    want, got = _jax_config(), static_config(FS, PLIM)
    for key in ("pc", "log2pc", "fERBs"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert len(got["per_octave"]) == len(want["per_octave"]) == 5
    for i, (g, w) in enumerate(zip(got["per_octave"], want["per_octave"])):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"{key}{i}")
    # the geometry of the 16 kHz default: windows 2048...128 at hop w/2,
    # 326 ERB points, 336 candidates
    assert [o["ws"] for o in got["per_octave"]] == [2048, 1024, 512, 256, 128]
    assert all(o["dn"] == o["ws"] // 2 for o in got["per_octave"])
    assert got["fERBs"].shape == (326,) and got["pc"].shape == (336,)


def _assert_matches(got, want):
    assert got["f0"].shape == want["f0"].shape
    np.testing.assert_array_equal(got["temporal_positions"],
                                  want["temporal_positions"])
    np.testing.assert_array_equal(got["vuv"], want["vuv"])
    np.testing.assert_allclose(got["f0"], want["f0"], rtol=1e-8, atol=0)


@pytest.mark.parametrize("sTHR", [0.3, float("-inf")])
def test_swipe_matches_jax_small(sTHR, x_small):
    want = _jax_swipe(x_small, sTHR=sTHR)
    got = _torch_swipe(x_small, sTHR=sTHR)
    _assert_matches(got, want)
    assert got["f0"].shape == (201,)
    if sTHR == 0.3:
        assert 0.05 < got["vuv"].mean() < 0.95
    else:
        assert got["vuv"].all()


@pytest.fixture(scope="module")
def x16_f64(x16):
    return _torch_swipe(x16, sTHR=0.3)


def test_swipe_matches_jax_x16(x16, x16_f64):
    _assert_matches(x16_f64, _jax_swipe(x16, sTHR=0.3))


def test_swipe_float32_against_float64_x16(x16, x16_f64):
    """tests/test_swipe.py's bars, float32 against float64."""
    got = _torch_swipe(x16, dtype=torch.float32, sTHR=0.3)
    ref = x16_f64
    assert got["f0"].dtype == np.float32
    assert ((got["f0"] > 0) == (ref["f0"] > 0)).mean() > 0.97
    both = (got["f0"] > 0) & (ref["f0"] > 0)
    rel = np.abs(got["f0"][both] - ref["f0"][both]) / ref["f0"][both]
    assert np.median(rel) < 1e-4
    assert (rel < 0.01).mean() > 0.97


def test_swipe_x16_sanity_against_the_22k_golden(x16_f64):
    """swipe.npz was made from the same utterance at 22.05 kHz: not a
    parity bar, a sanity line (the JAX package reads 0.977 / 2.7e-3 here)."""
    g = np.load(GOLDEN / "swipe.npz")
    f0 = x16_f64["f0"]
    n = min(f0.shape[0], g["f0"].shape[0])
    a, b = f0[:n], g["f0"][:n]
    assert ((a > 0) == (b > 0)).mean() > 0.95
    both = (a > 0) & (b > 0)
    assert np.median(np.abs(a[both] - b[both]) / b[both]) < 1e-2


def test_module_with_jax_tables_matches_own_tables(x_small):
    """SwipeF0's buffers loaded with the JAX package's tables
    (from_numpy_state) give what the port's own tables give, and what the
    function gives."""
    from world_tpu_torch import SwipeF0

    cfg = _jax_config()
    state = {"pc": cfg["pc"], "log2pc": cfg["log2pc"]}
    for i, oc in enumerate(cfg["per_octave"]):
        state.update({f"{name}{i}": oc[name] for name in ("A", "K", "mu", "win")})
    own = SwipeF0(FS, x_small.shape[0], sTHR=0.3, dtype=torch.float64,
                  device="cpu")
    assert set(state) == {k for k, _ in own.named_buffers()}
    loaded = SwipeF0(FS, x_small.shape[0], sTHR=0.3, dtype=torch.float64,
                     device="cpu")
    for buf in loaded.buffers():
        buf.zero_()
    loaded.from_numpy_state(state)
    a, b = own(torch.tensor(x_small)), loaded(torch.tensor(x_small))
    want = _torch_swipe(x_small, sTHR=0.3)
    for key in ("f0", "vuv"):
        assert torch.equal(a[key], b[key]), key
        np.testing.assert_array_equal(a[key][0].numpy(), want[key])


def test_batched_rows_equal_single_rows(x_small):
    from world_tpu_torch.f0.swipe import swipe_core

    rng = np.random.RandomState(0)
    xs = np.stack([x_small, x_small + 1e-3 * rng.randn(x_small.shape[0]),
                   np.zeros_like(x_small)])
    batch = swipe_core(torch.tensor(xs), FS, PLIM, sTHR=0.3)
    assert batch["f0"].shape == (3, 201)
    for i in range(3):
        single = swipe_core(torch.tensor(xs[i:i + 1]), FS, PLIM, sTHR=0.3)
        np.testing.assert_allclose(batch["f0"][i].numpy(), single["f0"][0].numpy(),
                                   rtol=1e-12, atol=0)
    assert not batch["vuv"][2].any()      # silence is unvoiced, and finite
    assert torch.isfinite(batch["f0"]).all()


@pytest.mark.parametrize("n", [40, 160, 700])
def test_short_signals_match_jax(n, x_small):
    """Signals shorter than the longest window (2048): every octave is
    mostly padding and has 2 frames."""
    x = x_small[4000:4000 + n]
    _assert_matches(_torch_swipe(x), _jax_swipe(x))


def test_frames_outside_an_octave_are_nan_and_unvoiced():
    """An output time outside an octave's frame times is NaN in all of the
    octave's candidates (swipe.py:37-39), and the frame comes out unvoiced.
    With hop w/2 the last frame time exceeds the signal's end, so the branch
    needs a time past it: the geometry is checked on the host, and the NaN's
    way through max, argmax and the gate against jnp's."""
    import jax.numpy as jnp

    from world_tpu_torch.f0.swipe import time_interpolation

    t = np.array([0.0, 0.004, 0.02, 0.0200001, 0.5])
    pos, frac, outside = time_interpolation(4, 128, 64, 16000.0, t)
    ti = np.r_[0.0, (np.arange(3) * 64 + 64) / 16000.0]      # 0, .004, .008, .012
    np.testing.assert_array_equal(outside, [False, False, True, True, True])
    np.testing.assert_array_equal(pos, [0, 1, 2, 2, 2])
    np.testing.assert_allclose(frac[:2], [0.0, 0.0], atol=1e-15)
    assert ti[-1] == 0.012

    S = np.array([[0.2, np.nan, 0.1], [0.9, 0.3, np.nan], [0.1, 0.5, 0.7]])
    tv, ti_ = torch.max(torch.tensor(S), dim=0)
    jv, ji = jnp.max(jnp.asarray(S), axis=0), jnp.argmax(jnp.asarray(S), axis=0)
    np.testing.assert_array_equal(np.isnan(tv.numpy()), np.isnan(np.asarray(jv)))
    np.testing.assert_array_equal(ti_.numpy(), np.asarray(ji))


def test_world_get_f0_swipe_matches_jax(x_small):
    from world_tpu import World as JaxWorld
    from world_tpu_torch import World

    want = JaxWorld().get_f0(FS, x_small, f0_method="swipe")
    got = World(device="cpu").get_f0(FS, x_small, f0_method="swipe")
    for g, w, key in zip(got, want, ("temporal_positions", "f0", "vuv")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-8, atol=0, err_msg=key)
    voiced = got[1][got[2] == 1]
    assert voiced.size and (voiced >= 71).all() and (voiced <= 800 * 1.01).all()


def test_swipe_without_cuda_needs_the_cpu_by_name(x_small):
    from world_tpu_torch.f0.swipe import swipe

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        swipe(FS, x_small)
