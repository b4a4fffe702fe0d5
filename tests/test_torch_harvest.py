"""Harvest in the port against the JAX package, stage by stage, in float64.

The fixture is harvest_small.npz (1 s at 16 kHz).  Both sides run with the
small static tables of test_harvest_small.py (8 candidates, 64 sections),
so the JAX program is the one that file compiles.  Every ``_``-prefixed
stage, then f0/vuv, must agree to 1e-9 relative (1e-9 Hz absolute); the
port's float64 arithmetic differs from JAX's only in summation order.
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
