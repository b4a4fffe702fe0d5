"""Harvest in the port against the JAX package, stage by stage, in float64.

The fixture is harvest_small.npz (1 s at 16 kHz).  Both sides run with the
small static tables of test_harvest_small.py (8 candidates, 64 sections),
so the JAX program is the one that file compiles.  Every ``_``-prefixed
stage, then f0/vuv, must agree to 1e-9 relative (1e-9 Hz absolute); the
port's float64 arithmetic differs from JAX's only in summation order.

pyworld's default chain as the port's graph module, ``HarvestClassic``
(Harvest at its default caps -> CheapTrick -> classic D4C -> classic
synthesis), is held to the JAX package's chain: the JAX Harvest at the
shape and caps above (8 candidates and 64 sections saturate nothing here,
so the module's larger default caps keep the same candidates), the JAX
CheapTrick and D4C on that contour, and the JAX ``_synthesis_core`` on the
same standard-normal draw of the module's caps.  The input is harvest_small's
shape, so the JAX Harvest program is the one compiled above; it is a
two-partial tone for 0.6 s, then noise.  It starts voiced because the
synthesis' unvoiced stretches run at 500 Hz, whose phase at 16 kHz returns
to a multiple of 2*pi exactly every 32 samples from the start, and there
the port's sequential phase sum and XLA's tree sum wrap on neighbouring
samples (as test_torch_classic.py sets out); after a voiced stretch the
phase is off those multiples.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

GOLDEN = Path(__file__).parent / "golden"
STAGES = ("_raw_candidates", "_cands_detected", "_cands_overlap",
          "_cands_refined", "_scores_refined", "_cands_clean", "_scores_clean",
          "_f0_base", "_f0_step1", "_f0_step2", "_f0_step3", "_f0_step4",
          "_smoothed", "f0", "vuv", "temporal_positions")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN / "harvest_small.npz")


@pytest.fixture(scope="module")
def jax_hv(g):
    from world_tpu.f0.harvest import harvest

    return {k: np.asarray(v)
            for k, v in harvest(np.asarray(g["x"]), int(g["fs"]),
                                max_candidates=8, max_sections=64,
                                debug_outputs=True).items()}


@pytest.fixture(scope="module")
def torch_hv(g):
    from world_tpu_torch.f0.harvest import harvest

    out = harvest(torch.tensor(np.asarray(g["x"])), int(g["fs"]),
                  max_candidates=8, max_sections=64, debug_outputs=True)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_jax(stage, jax_hv, torch_hv):
    want, got = jax_hv[stage], torch_hv[stage]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_no_overflow_flags(jax_hv, torch_hv):
    for key in ("_refine_overflow", "_section_overflow"):
        assert not bool(torch_hv[key]) and not bool(jax_hv[key])


def test_golden_bars(torch_hv, g):
    """test_harvest_small.py's bars, on the port."""
    ref = g["f0_candidates_refined"]
    mc_ref = ref.shape[0] // 7
    got = torch_hv["_cands_refined"]
    mc = got.shape[0] // 7
    for i in range(7):
        agree = np.isclose(got[i * mc:i * mc + mc_ref],
                           ref[i * mc_ref:(i + 1) * mc_ref], rtol=1e-5, atol=1e-3)
        assert agree.mean() > 0.995, f"refine block {i}: {agree.mean()}"
    for stage, key in [("_f0_base", "f0_base"), ("_f0_step2", "f0_step2"),
                       ("_f0_step4", "f0_step4")]:
        agree = np.isclose(torch_hv[stage], g[key], rtol=1e-5, atol=1e-3)
        assert agree.mean() > 0.99, f"{stage} agreement {agree.mean()}"
    vuv = torch_hv["vuv"] > 0
    gvuv = np.asarray(g["vuv"]) > 0
    assert np.mean(vuv == gvuv) > 0.99
    both = vuv & gvuv
    rmse = np.sqrt(np.mean((torch_hv["f0"][both] - g["f0"][both]) ** 2))
    assert rmse < 0.1, rmse


def test_extend_chains_keep_reference_write_order():
    """FixStep3 on a contour with two sections whose extensions overlap:
    the port's merge gives the JAX package's contour exactly."""
    import jax.numpy as jnp

    from world_tpu.f0.harvest import fix_step3 as jax_fix_step3
    from world_tpu_torch.f0.harvest import fix_step3

    rng = np.random.RandomState(5)
    n, C = 400, 6
    f0 = np.zeros(n)
    f0[60:140] = 200 + np.linspace(0, 10, 80)
    f0[180:260] = 205 + np.linspace(0, 5, 80)
    cands = 200 + rng.rand(C, n) * 15
    cands[rng.rand(C, n) < 0.3] = 0.0
    scores = np.where(cands > 0, rng.rand(C, n) * 10 + 2.5, 0.0)
    want = np.asarray(jax_fix_step3(jnp.asarray(f0), jnp.asarray(cands),
                                    jnp.asarray(scores), 0.18, max_sections=16))
    got = fix_step3(torch.tensor(f0), torch.tensor(cands), torch.tensor(scores),
                    0.18, max_sections=16).numpy()
    np.testing.assert_array_equal(got, want)


CLASSIC_OUTPUTS = ("temporal_positions", "vuv", "f0", "spectrogram",
                   "aperiodicity", "y", "_overflow")


def _voiced_then_noise(n: int, fs: int):
    t = np.arange(n) / fs
    tone = 0.6 * (np.sin(2 * np.pi * 150 * t) + 0.3 * np.sin(2 * np.pi * 300 * t))
    return (np.where(t < 0.6, tone, 0.0)
            + 0.02 * np.random.RandomState(1).randn(n))


@pytest.fixture(scope="module")
def classic_pair(g, jax_hv):
    """HarvestClassic's eager CPU outputs (float64) and the JAX package's
    chain, on the same input and draw."""
    import jax
    import jax.numpy as jnp

    from world_tpu.aperiodicity.d4c import d4c as jax_d4c
    from world_tpu.f0.harvest import harvest as jax_harvest
    from world_tpu.spectral.cheaptrick import cheaptrick as jax_cheaptrick
    from world_tpu.synth.classic import _synthesis_core as jax_synthesis
    from world_tpu_torch import HarvestClassic
    from world_tpu_torch.parallel.batch import classic_ceiling

    fs = int(g["fs"])
    x = _voiced_then_noise(np.asarray(g["x"]).shape[0], fs)
    module = HarvestClassic(fs, x.shape[0], 5, dtype=torch.float64, device="cpu")
    y_length, P, N = module.caps()
    key = jax.random.PRNGKey(7)
    draw = np.asarray(jax.random.normal(key, (P, N), dtype=jnp.float64))
    out = module(torch.tensor(x), noise=torch.tensor(draw)[None])
    got = {k: (v if k == "temporal_positions" else v[0]).numpy()
           for k, v in out.items()}

    hv = {k: np.asarray(v) for k, v in
          jax_harvest(x, fs, max_candidates=8, max_sections=64,
                      debug_outputs=True).items()}
    src = {k: hv[k] for k in ("temporal_positions", "f0", "vuv")}
    filt = jax_cheaptrick(x, fs, src)
    dat = jax_d4c(x, fs, dict(src, f0=filt["f0_effective"]))
    fft_size = 2 * (filt["spectrogram"].shape[0] - 1)
    # the pulses one pulse's response overlaps, at the module's ceiling
    k_overlap = min(int(np.ceil(fft_size * classic_ceiling("harvest") / fs / 8)
                        + 1) * 8, P)
    y, pulse_overflow = jax_synthesis(
        jnp.asarray(dat["f0"]), jnp.asarray(src["vuv"]),
        jnp.asarray(src["temporal_positions"]),
        jnp.asarray(filt["spectrogram"]), jnp.asarray(dat["aperiodicity"]),
        key, fs, y_length, fft_size, P, N, "gaussian", "standard", k_overlap,
        0.005)
    want = {"temporal_positions": src["temporal_positions"], "vuv": src["vuv"],
            "f0": np.asarray(dat["f0"]),
            "spectrogram": np.asarray(filt["spectrogram"]),
            "aperiodicity": np.asarray(dat["aperiodicity"]), "y": np.asarray(y),
            "_overflow": np.asarray(hv["_refine_overflow"]
                                    | hv["_section_overflow"]
                                    | pulse_overflow)}
    return got, want


@pytest.mark.parametrize("key", CLASSIC_OUTPUTS)
def test_harvest_classic_matches_the_jax_chain(key, classic_pair):
    """Every output to 1e-9 of its scale (the two differ in summation order
    only; the classic synthesis' phase cumsum is sequential in the port and
    a tree in XLA), vuv and the capacity flag exactly."""
    got, want = classic_pair
    got, want = got[key], want[key]
    assert got.shape == want.shape, (got.shape, want.shape)
    if key in ("vuv", "_overflow"):
        np.testing.assert_array_equal(got, want)
        return
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * scale)


def test_harvest_classic_is_voiced_without_overflow(classic_pair):
    """The comparison is not vacuous: the module's contour is voiced on the
    tone and unvoiced on the noise, its waveform is not silent, and no cap
    (Harvest's tables, the pulse slots sized from Harvest's ceiling)
    overflowed."""
    got, _ = classic_pair
    assert 0.5 < got["vuv"].mean() < 0.8 and np.abs(got["y"]).max() > 0.01
    assert not bool(got["_overflow"])
