"""DIO and StoneMask in the port against the JAX package and the goldens,
in float64 on the CPU.

  * ``decimate_world`` against the JAX package's at every ratio with
    coefficients and at one without: 1e-12 of the signal's scale (the two
    sum the same truncated-FIR products in another order).
  * DIO's stages after the decimation on dio.npz's ``y_decimated`` (the
    reference's own decimated signal, so no wav is needed) against every
    golden in that file: the bars of test_dio.py (raw candidates agreeing on
    > 99.9%, sorted ones on > 99.5%, vuv > 0.99, voiced F0 RMSE < 0.1 Hz),
    and the contour stages on > 99.9% of frames.
  * ``dio_core`` and ``stonemask_core`` against the live ``_dio_core`` and
    ``_stonemask_core`` on harvest_small.npz's ``x``: every output to 1e-9
    of its scale, vuv exactly.  The float64 arithmetic differs from JAX's
    only in summation order and in XLA's reciprocal products; StoneMask's
    rounded window offsets are the JAX package's
    (world_tpu_torch/f0/stonemask.py::base_times).
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from smoke_loader import chip_smoke as _chip_smoke

GOLDEN = Path(__file__).parent / "golden"
FS_SMALL = 16000


def _rel_close(got, want, rtol=1e-9, key=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, key
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=key)


@pytest.mark.parametrize("r", [2, 3, 4, 5, 6, 12, 13])
def test_decimate_world_matches_jax(r):
    import jax.numpy as jnp

    from world_tpu.dsp.iir import decimate_world as jax_decimate
    from world_tpu_torch.dsp.iir import decimate_world

    x = np.random.RandomState(r).randn(2, 4001)
    want = np.stack([np.asarray(jax_decimate(jnp.asarray(row), r)) for row in x])
    got = decimate_world(torch.tensor(x), r).numpy()
    if r == 13:                          # no coefficients: the zero filter
        assert not want.any()
    _rel_close(got, want, rtol=1e-12, key=f"r={r}")


# ---------------------------------------------------------------------------
# DIO's stages on the reference's decimated signal
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN / "dio.npz")


@pytest.fixture(scope="module")
def stages(g):
    from world_tpu_torch.f0.dio import dio_stages

    out = dio_stages(torch.tensor(np.asarray(g["y_decimated"]))[None], 4000.0,
                     71.0, 800.0, 2, 5.0, 0.1, g["temporal_positions"].shape[0])
    return {k: (v.numpy() if k == "temporal_positions" else v[0].numpy())
            for k, v in out.items()}


# (port stage, golden key, rtol, atol, share of entries that must agree)
GOLDEN_STAGES = [
    ("raw_f0_candidates", "raw_f0_candidate", 1e-6, 1e-4, 0.999),
    ("_raw_stability", "raw_stability", 1e-5, 1e-6, 0.999),
    ("f0_candidates", "f0_candidates", 1e-6, 1e-4, 0.995),
    ("_f0_scores", "f0_scores", 1e-5, 1e-6, 0.995),
    ("_f0_candidates_mutated", "f0_candidates_mutated", 1e-6, 1e-4, 0.995),
    ("_f0_step1", "f0_step1", 1e-6, 1e-4, 0.999),
    ("_f0_step2", "f0_step2", 1e-6, 1e-4, 0.999),
    ("_f0_step3", "f0_step3", 1e-6, 1e-4, 0.999),
    ("f0", "f0_step4", 1e-6, 1e-4, 0.999),
    ("temporal_positions", "temporal_positions", 0.0, 0.0, 1.0),
]


@pytest.mark.parametrize("stage,key,rtol,atol,share", GOLDEN_STAGES,
                         ids=[s[0] for s in GOLDEN_STAGES])
def test_dio_stage_matches_golden(stage, key, rtol, atol, share, stages, g):
    got, want = stages[stage], g[key]
    assert got.shape == want.shape
    agree = np.isclose(got, want, rtol=rtol, atol=atol).mean()
    assert agree >= share, f"{stage}: agreement {agree}"


def test_dio_final_f0_meets_golden_bars(stages, g):
    """test_dio.py::test_final_f0_matches's bars."""
    vuv, gvuv = stages["vuv"], g["vuv"]
    assert (vuv == gvuv).mean() > 0.99
    both = (vuv == 1) & (gvuv == 1)
    rmse = np.sqrt(np.mean((stages["f0"][both] - g["f0"][both]) ** 2))
    assert rmse < 0.1, rmse


def test_float32_crossing_positions_bound_raw_candidates(g):
    """A float32 fault of the JAX package, kept by the port: K1 places each
    zero crossing at (i+1) - frac in the working type, so in float32 a
    position in a row of n < 32768 samples carries up to 2**-9 samples of
    rounding, and a 5-sample interval (800 Hz at 4 kHz) up to 7.8e-4 of
    relative error.  Both packages' float32 raw candidates miss
    test_dio.py's float64 tolerance (rtol 1e-6) on over a third of the
    entries and meet rtol 1e-3 on > 99.9%; the fixed contour still meets
    test_dio.py's bars."""
    import jax.numpy as jnp

    from world_tpu.f0.dio import _candidates_and_stability
    from world_tpu_torch.f0.dio import boundary_f0_list, dio_stages

    y = np.asarray(g["y_decimated"])
    want = g["raw_f0_candidate"]
    st = dio_stages(torch.tensor(y, dtype=torch.float32)[None], 4000.0, 71.0,
                    800.0, 2, 5.0, 0.1, g["temporal_positions"].shape[0])
    jax_raw, _ = _candidates_and_stability(
        jnp.asarray(y, jnp.float32), 4000.0, 71.0, 800.0,
        boundary_f0_list(71.0, 800.0, 2),
        jnp.asarray(g["temporal_positions"], jnp.float32), 5.0)
    for raw in (st["raw_f0_candidates"][0].double().numpy(),
                np.asarray(jax_raw, np.float64)):
        assert np.isclose(raw, want, rtol=1e-6, atol=1e-4).mean() < 0.7
        assert np.isclose(raw, want, rtol=1e-3, atol=1e-4).mean() > 0.999
    f0, vuv = st["f0"][0].double().numpy(), st["vuv"][0].numpy()
    assert (vuv == g["vuv"]).mean() > 0.99
    both = (vuv == 1) & (g["vuv"] == 1)
    assert np.sqrt(np.mean((f0[both] - g["f0"][both]) ** 2)) < 0.1


def test_dio_short_sections_follow_the_scan():
    """FixStep3/4 on contours whose voiced sections are 1-3 frames long,
    where one section's extension writes the values the next one starts
    from: the port's chains reproduce the JAX package's frame scan."""
    import jax.numpy as jnp

    from world_tpu.f0.dio import _fix_step3, _fix_step4
    from world_tpu_torch.f0.dio import fix_step3, fix_step4

    rng = np.random.RandomState(7)
    n, C = 120, 4
    cands = 180 + rng.rand(C, n) * 20
    cands[rng.rand(C, n) < 0.2] = 0.0
    f0 = np.zeros(n)
    for s, length in ((10, 1), (13, 2), (17, 3), (22, 1), (40, 5), (47, 1),
                      (90, 3), (95, 2)):
        f0[s:s + length] = 190.0 + rng.rand(length)
    want3 = np.asarray(_fix_step3(jnp.asarray(f0), jnp.asarray(cands), 0.1))
    want4 = np.asarray(_fix_step4(jnp.asarray(want3), jnp.asarray(f0),
                                  jnp.asarray(cands), 0.1))
    got3 = fix_step3(torch.tensor(f0)[None], torch.tensor(cands)[None], 0.1)
    got4 = fix_step4(got3, torch.tensor(f0)[None], torch.tensor(cands)[None], 0.1)
    np.testing.assert_array_equal(got3[0].numpy(), want3)
    np.testing.assert_array_equal(got4[0].numpy(), want4)


# ---------------------------------------------------------------------------
# the live JAX programs on harvest_small.npz
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def x_small():
    return np.asarray(np.load(GOLDEN / "harvest_small.npz")["x"])


@pytest.fixture(scope="module")
def jax_dio(x_small):
    import jax.numpy as jnp

    from world_tpu.f0.dio import _dio_core

    out = _dio_core(jnp.asarray(x_small), FS_SMALL, 71.0, 800.0, 2, 4000, 5.0,
                    0.1, x_small.shape[0])
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def torch_dio(x_small):
    from world_tpu_torch.f0.dio import dio_core

    out = dio_core(torch.tensor(x_small)[None], FS_SMALL)
    return {k: (v.numpy() if k == "temporal_positions" else v[0].numpy())
            for k, v in out.items()}


DIO_OUTPUTS = ("f0", "vuv", "f0_candidates", "raw_f0_candidates",
               "temporal_positions", "_f0_scores", "_raw_stability")


@pytest.mark.parametrize("key", DIO_OUTPUTS)
def test_dio_core_matches_jax(key, jax_dio, torch_dio):
    if key == "vuv":
        np.testing.assert_array_equal(torch_dio[key], jax_dio[key])
    else:
        _rel_close(torch_dio[key], jax_dio[key], key=key)


def test_stonemask_core_matches_jax(x_small, jax_dio):
    import jax.numpy as jnp

    from world_tpu.f0.stonemask import _stonemask_core
    from world_tpu_torch.f0.stonemask import max_half_window, stonemask_core

    f0, tp = jax_dio["f0"], jax_dio["temporal_positions"]
    voiced = f0 != 0
    assert voiced.sum() > 10
    mh = max_half_window(FS_SMALL, 71.0)
    want = np.asarray(_stonemask_core(jnp.asarray(x_small), FS_SMALL,
                                      jnp.asarray(tp), jnp.asarray(f0), mh))
    got = stonemask_core(torch.tensor(x_small)[None], FS_SMALL, torch.tensor(tp),
                         torch.tensor(f0)[None], mh)[0].numpy()
    # the JAX core refines unvoiced frames too; its callers zero them
    _rel_close(got[voiced], want[voiced], key="refined f0")
    assert not got[~voiced].any()
    assert np.abs(got[voiced] - f0[voiced]).max() > 1e-3   # it did refine


def test_stonemask_refuses_f0_below_its_floor(x_small):
    from world_tpu_torch.f0.stonemask import stonemask

    tp = torch.arange(201, dtype=torch.float64) * 0.005
    f0 = torch.full((201,), 60.0, dtype=torch.float64)
    with pytest.raises(ValueError, match="f0_floor"):
        stonemask(torch.tensor(x_small), FS_SMALL, tp, f0, f0_floor=71.0)


# ---------------------------------------------------------------------------
# K3's decomposition: heads, and each group walked on its own
# ---------------------------------------------------------------------------

def _grouped_scan(base, flags, limits, cands, allowed_range, backward):
    """extension_scan_plain's function as csrc/extension_scan.cu computes
    it: in scan order, the heads (a flag with no flag before it, or whose
    previous flag f' has f' < f - 1 and reach(f') < f - 1), each head's
    group walked on its own from the carry (base[f], base[f - 1] or 0,
    active, reach(f)), the frames between flags jumped over where the carry
    is inactive, every other frame base.  It models the kernel's walk, not
    the kernel: change it whenever the walk in extension_scan.cu changes.
    The kernel itself is held on the same layouts by
    test_torch_kernels.py::test_k3_cuda_matches_plain (gpu) and by
    chip_smoke.py's phase 2."""
    from world_tpu_torch.ops.extension_scan import select_best_f0

    B, n = base.shape
    out = base.clone()
    for b in range(B):
        frame = (lambda s: n - 1 - s) if backward else (lambda s: s)
        lim = limits[b].tolist()
        reach = [(n - lim[frame(s)]) if backward else lim[frame(s)]
                 for s in range(n)]
        fl = [s for s in range(n) if bool(flags[b, frame(s)])]
        heads = [f for i, f in enumerate(fl)
                 if i == 0 or (fl[i - 1] < f - 1 and reach[fl[i - 1]] < f - 1)]
        is_flag = set(fl)
        for h in heads:
            prev1 = base[b, frame(h)]
            prev2 = base[b, frame(h - 1)] if h > 0 else torch.zeros_like(prev1)
            last, active, s = h, True, h
            while s + 1 < n:
                s1 = s + 1
                if active and s1 <= reach[last]:
                    v = select_best_f0(prev1[None], prev2[None],
                                       cands[b, :, frame(s1)][None],
                                       allowed_range)[0]
                    out[b, frame(s1)] = v
                    active = bool(v != 0)
                    if s1 in is_flag:
                        last, active = s1, True
                    prev2, prev1, s = prev1, v, s1
                    continue
                g_ = next((f for f in fl if f >= s1), n)
                if g_ >= n or (g_ - last > 1 and g_ - 1 > reach[last]):
                    break
                prev2 = prev1 if g_ - 1 == s else base[b, frame(g_ - 1)]
                prev1 = base[b, frame(g_)]
                last, active, s = g_, True, g_
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_decomposition_matches_the_scan_on_adversarial_layouts(dtype):
    """The head rule and each group walked on its own reproduce the serial
    scan bitwise, both directions, on chip_smoke.k3_adversarial_operands
    (adjacent flags, flags at frames 0 and n - 1, every frame flagged,
    limits before their flag and past n, one group spanning every flag,
    C = 1 and 12, rows with no flag, rows of 1 and 33 frames)."""
    from world_tpu_torch.ops.extension_scan import extension_scan_plain

    cs = _chip_smoke()
    layouts = cs.k3_adversarial_operands(dtype, device="cpu", long_row=False)
    for name, scans in layouts.items():
        for args in scans:
            want = extension_scan_plain(*args)
            got = _grouped_scan(*args)
            assert torch.equal(got, want), (name, args[5])
    # the layouts reach what they name
    st = cs.k3_groups(layouts["one_group"][0], extension_scan_plain(
        *layouts["one_group"][0]))
    assert st["heads"] == 2 and st["largest_group"] > 50
    st = cs.k3_groups(layouts["every_frame"][1], extension_scan_plain(
        *layouts["every_frame"][1]))
    assert st["flags"] == 2 * cs.K3_ADV_N and st["heads"] == 2


def test_k3_decomposition_matches_the_scan_on_dio(x_small):
    """The same on DIO's own operands of harvest_small (both scans of one
    dio_core call, captured where DIO calls K3), in float32 and float64."""
    from world_tpu_torch.ops.extension_scan import extension_scan_plain

    cs = _chip_smoke()
    for dtype in (torch.float32, torch.float64):
        scans = cs.k3_operands(x_small, FS_SMALL, dtype, device="cpu")
        assert len(scans) == 2 and [a[5] for a in scans] == [False, True]
        for args in scans:
            want = extension_scan_plain(*args)
            assert torch.equal(_grouped_scan(*args), want)
            st = cs.k3_groups(args, want)
            assert st["heads"] >= 1 and st["extended"] > 0
