"""The port's static tables against the JAX package's, and the port's
independence from JAX.

The round trips have no learned weights; their state is their static
tables.  ``jax_state`` and ``jax_dio_state`` collect them from the JAX
package as numpy arrays, in the layout of HarvestRequiem's and DioClassic's
buffers; the modules built by the port must hold the same values (exactly,
except the DFT tables, whose JAX angles round differently from the port's
host-built -2*pi*m/S: 1e-12).
"""
import math
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


def jax_dio_state(fs: int) -> dict:
    """DioClassic's tables for ``fs``, built by the JAX package: DIO's band
    bank and read offsets (target_fs 4000), its decimator's truncated
    impulse response, and StoneMask's DFT angles -2*pi*m/S for the largest
    fft_size S (world_tpu/f0/stonemask.py::_dft_bins)."""
    import jax.numpy as jnp

    from world_tpu.dsp.iir import _DECIMATE_COEFFS, _trunc_impulse
    from world_tpu.f0.dio import _band_bank

    bfl = 71.0 * 2.0 ** ((np.arange(math.ceil(np.log2(800.0 / 71.0) * 2)) + 1)
                         / 2)
    bank, offsets = _band_bank(bfl, 4000.0)
    a, (b0, b1) = _DECIMATE_COEFFS[int(fs / 4000)]
    decim = _trunc_impulse((b0, b1, b1, b0), (1.0, -a[0], -a[1], -a[2]))
    max_half = int(math.ceil(3 * fs / 71.0 / 2))
    S = int(2 ** (math.ceil(math.log2(2 * max_half + 1)) + 1))
    theta = (-2.0 * jnp.pi) * (jnp.arange(S, dtype=jnp.float64) / S)
    return {"dio_bank": bank, "dio_offsets": offsets, "dio_decimator_ir": decim,
            "stonemask_cos": np.asarray(jnp.cos(theta)),
            "stonemask_sin": np.asarray(jnp.sin(theta))}


@pytest.mark.parametrize("fs", FS_CASES)
def test_dio_tables_equal_jax(fs):
    from world_tpu_torch import DioClassic

    module = DioClassic(fs, fs, dtype=torch.float64, device="cpu")
    state = jax_dio_state(fs)
    assert set(state) == {name for name, _ in module.named_buffers()}
    for name, want in state.items():
        got = getattr(module, name).numpy()
        assert got.shape == want.shape, name
        if name.startswith("stonemask_"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("fs", FS_CASES)
def test_tables_equal_jax(fs):
    from world_tpu_torch import HarvestRequiem

    module = HarvestRequiem(fs, fs, dtype=torch.float64, device="cpu")
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

    module = HarvestRequiem(12000, 3072, dtype=torch.float32, device="cpu")
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


def test_classic_path_imports_no_jax():
    code = ("import sys, numpy as np, torch\n"
            "from world_tpu_torch import World\n"
            "w = World(device='cpu')\n"
            "x = np.random.RandomState(0).randn(6000)\n"
            "w.decode(w.encode(12000, x, f0_method='dio'))\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules"
            " if m.startswith('jax'))\n"
            "assert 'world_tpu' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
