"""Harvest in the port on 22.05 kHz speech, stage by stage, in float64.

tests/golden/harvest.npz holds the reference's decimated signal of a
22.05 kHz utterance (102,400 samples: 34,134 at actual_fs 7,350 Hz) and
every stage after it.  Harvest reads nothing of the signal but the
decimated one, so the port runs from ``y_decimated`` on
(:func:`world_tpu_torch.f0.harvest.harvest_decimated`, the stages
``harvest_core`` runs after its downsampler) and each stage is held to the
bars tests/test_harvest.py holds the JAX package to where the wav is
present.  It is the only real speech at K1's 22.05 kHz stride (147/20) and
K2's 22.05 kHz windows.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

GOLDEN = Path(__file__).parent / "golden"
SIGNAL_LENGTH = 102_400      # ceil(n / 3) = 34,134 and int(1000 n / fs + 1) = 4,644
CANDIDATE_STAGES = [("_cands_overlap", "f0_candidates_overlap", 1e-6, 1e-4, 0.999),
                    ("_cands_refined", "f0_candidates_refined", 1e-5, 1e-3, 0.995),
                    ("_scores_refined", "f0_scores_refined", 1e-3, 1e-2, 0.99),
                    ("_cands_clean", "f0_candidates_clean", 1e-5, 1e-3, 0.995)]
CONTOUR_STAGES = [("_f0_base", "f0_base"), ("_f0_step1", "f0_step1"),
                  ("_f0_step2", "f0_step2"), ("_f0_step3", "f0_step3"),
                  ("_f0_step4", "f0_step4"), ("_smoothed", "smoothed_f0")]


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN / "harvest.npz")


@pytest.fixture(scope="module")
def hv(g):
    from world_tpu_torch.f0 import harvest as H

    fs = int(g["fs"])
    _, actual_fs = H.decimation(fs)
    y = torch.tensor(np.asarray(g["y_decimated"]))[None]
    out = H.harvest_decimated(y, actual_fs, SIGNAL_LENGTH, fs, 71.0, 800.0, 5.0,
                              H.default_max_candidates(),
                              H.default_max_sections(SIGNAL_LENGTH, fs),
                              debug_outputs=True)
    return {k: (v if k == "temporal_positions" else v[0]).numpy()
            for k, v in out.items()}


def test_geometry(g, hv):
    from world_tpu_torch.f0 import harvest as H

    assert H.decimation(int(g["fs"])) == (3, 7350.0)
    assert g["y_decimated"].shape == (-(-SIGNAL_LENGTH // 3),)
    assert hv["_raw_candidates"].shape == g["raw_f0_candidates"].shape == (152, 4644)
    np.testing.assert_allclose(hv["temporal_positions"], g["temporal_positions"],
                               rtol=0, atol=1e-15)
    assert not hv["_refine_overflow"] and not hv["_section_overflow"]


def test_raw_candidates(g, hv):
    ref = g["raw_f0_candidates"].astype(np.float64)        # stored float32
    agree = np.isclose(hv["_raw_candidates"], ref, rtol=2e-5, atol=1e-2)
    assert agree.mean() > 0.999, agree.mean()


def test_detected_candidates(g, hv):
    ref = g["f0_candidates_detected"]
    assert hv["_cands_detected"].shape == ref.shape
    agree = np.isclose(hv["_cands_detected"], ref, rtol=1e-6, atol=1e-4)
    assert agree.mean() > 0.999, agree.mean()


@pytest.mark.parametrize("stage,key,rtol,atol,share", CANDIDATE_STAGES)
def test_candidate_stage(g, hv, stage, key, rtol, atol, share):
    """The reference keeps 7 x n_detected rows, the port 7 x its static
    count: block i of the reference is the first rows of the port's block
    i, whose other rows are zero (the overlap's block 0 holds the
    reference's row-copy quirk in its row 0)."""
    ref, got = g[key], hv[stage]
    mc_ref, mc = ref.shape[0] // 7, got.shape[0] // 7
    assert mc_ref == int(g["n_detected"])
    for i in range(7):
        agree = np.isclose(got[i * mc:i * mc + mc_ref],
                           ref[i * mc_ref:(i + 1) * mc_ref], rtol=rtol, atol=atol)
        assert agree.mean() > share, (i, agree.mean())
        if stage == "_cands_overlap" and i != 0:
            assert np.abs(got[i * mc + mc_ref:(i + 1) * mc]).max() < 1e-9


@pytest.mark.parametrize("stage,key", CONTOUR_STAGES)
def test_contour_stage(g, hv, stage, key):
    agree = np.isclose(hv[stage], g[key], rtol=1e-5, atol=1e-3)
    assert agree.mean() > 0.99, agree.mean()


def test_f0_and_vuv_on_the_5ms_grid(g, hv):
    vuv_agree = (hv["vuv"] == g["vuv"]).mean()
    assert vuv_agree > 0.99, vuv_agree
    both = (hv["vuv"] == 1) & (g["vuv"] == 1)
    rmse = np.sqrt(np.mean((hv["f0"][both] - g["f0"][both]) ** 2))
    assert rmse < 0.2, rmse
