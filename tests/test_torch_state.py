"""The port's static tables against the JAX package's, and the port's
independence from JAX.

The round trip has no learned weights; its state is its static tables.
``jax_state`` collects them from the JAX package as numpy arrays, in the
layout of HarvestRequiem's buffers; the module built by the port must hold
the same values (exactly, except the refinement DFT table, whose JAX basis
angles n*(-2*pi*k/S) round differently from -2*pi*m/S: 1e-12).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FS_CASES = (12000, 16000)


def jax_state(fs: int) -> dict:
    """HarvestRequiem's tables for ``fs``, built by the JAX package."""
    import jax.numpy as jnp

    from world_tpu.dsp.iir import _trunc_impulse, cheby1_sos
    from world_tpu.f0.harvest import (_band_filter_bank,
                                      _smooth_zero_phase_kernel)
    from world_tpu.ops.refine_dft import dft_basis
    from world_tpu.synth.seeds import get_seeds_signals

    ratio = int(fs / 8000 + 0.5)
    actual_fs = fs / ratio if fs > 8000 else float(fs)
    adj_floor, adj_ceil = 71.0 * 0.9, 800.0 * 1.1
    bfl = adj_floor * 2.0 ** ((np.arange(np.ceil(np.log2(adj_ceil / adj_floor)
                                                 * 40)) + 1) / 40)
    bank, bias = _band_filter_bank(bfl, actual_fs)
    decim = _trunc_impulse(*cheby1_sos(3, 0.05, 0.8 / ratio))
    # the refinement basis (W, S/2+1) holds cos/sin of -2*pi*(n*k mod S)/S:
    # read the S-entry table the CUDA kernel indexes out of it
    max_half = int(np.ceil(3 * actual_fs / 71.0 / 2))
    W = 2 * max_half + 1
    S = int(2 ** np.ceil(np.log2(W) + 1))
    nb = S // 2 + 1
    basis = np.asarray(dft_basis(W, nb, jnp.float64))
    n, k = np.meshgrid(np.arange(W), np.arange(nb), indexing="ij")
    m = (n * k) % S
    first = {}
    for mi, ni, ki in zip(m.ravel(), n.ravel(), k.ravel()):
        first.setdefault(int(mi), (ni, ki))
    assert len(first) == S
    at = np.array([first[i] for i in range(S)])
    seeds = get_seeds_signals(fs)
    return {"band_bank": bank, "band_bias": bias, "decimator_ir": decim,
            "refine_cos": basis[at[:, 0], at[:, 1]],
            "refine_sin": basis[at[:, 0], nb + at[:, 1]],
            "smooth_kernel": _smooth_zero_phase_kernel(),
            "pulse_seed": np.asarray(seeds["pulse"]),
            "noise_seed": np.asarray(seeds["noise"])}


@pytest.mark.parametrize("fs", FS_CASES)
def test_tables_equal_jax(fs):
    from world_tpu_torch import HarvestRequiem

    module = HarvestRequiem(fs, fs, dtype=torch.float64)
    state = jax_state(fs)
    assert set(state) == {name for name, _ in module.named_buffers()}
    for name, want in state.items():
        got = getattr(module, name).numpy()
        assert got.shape == want.shape, name
        if name.startswith("refine_"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_from_numpy_state_loads_and_checks_shapes():
    from world_tpu_torch import HarvestRequiem

    module = HarvestRequiem(12000, 3072, dtype=torch.float32)
    state = jax_state(12000)
    module.from_numpy_state(state)
    assert torch.equal(module.noise_seed,
                       torch.tensor(state["noise_seed"], dtype=torch.float32))
    with pytest.raises(ValueError):
        module.from_numpy_state({"band_bank": state["band_bank"][1:]})


def test_package_imports_no_jax():
    code = ("import sys, numpy as np, torch, world_tpu_torch\n"
            "from world_tpu_torch.f0.harvest import harvest\n"
            "harvest(torch.tensor(np.random.RandomState(0).randn(4000)), 8000,"
            " max_candidates=8, max_sections=16)\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules"
            " if m.startswith('jax'))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
