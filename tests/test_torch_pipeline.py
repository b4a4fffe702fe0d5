"""The whole Harvest -> CheapTrick -> D4C-Requiem -> Requiem round trip in the
port against the JAX package, in float64.

At the tiny shape test_robustness.py compiles (fs 12000, 3072 samples,
frame period 10 ms, 256 pulses, 8 candidates, 16 sections), every output of
world_tpu.parallel.batch._encode_decode_one must agree: f0 (Harvest),
spectrogram (CheapTrick), band aperiodicity (D4C-Requiem) and the waveform
(Requiem) to 1e-9 of each output's scale, vuv exactly.  The orders of the
port's float64 sums differ from JAX's, nothing else.  On the 16 kHz golden
utterance the port is held to the golden bars of test_api.py.
"""
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_state import jax_state

GOLDEN = Path(__file__).parent / "golden"
FS, N, FP = 12000, 3072, 10
CAPS = dict(max_pulses=256, max_candidates=8, max_sections=16)
OUTPUTS = ("f0", "vuv", "spectrogram", "band_aperiodicity", "y", "_overflow")


def _tiny_signal(seed=0):
    t = np.arange(N) / FS
    rng = np.random.RandomState(seed)
    return (0.6 * (np.sin(2 * np.pi * 150 * t) + 0.3 * np.sin(2 * np.pi * 300 * t))
            + 0.01 * rng.randn(N))


def _assert_close(got, want, key):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, key
    if want.dtype == bool or key == "vuv":
        np.testing.assert_array_equal(got, want, err_msg=key)
        return
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * scale,
                               err_msg=key)


@pytest.fixture(scope="module")
def seeds():
    from world_tpu_torch.synth.seeds import get_seeds_signals

    return get_seeds_signals(FS)


@pytest.fixture(scope="module")
def jax_out(seeds):
    import jax
    import jax.numpy as jnp

    from world_tpu.parallel.batch import _encode_decode_one

    fn = jax.jit(partial(_encode_decode_one, fs=FS, frame_period=FP, **CAPS))
    out = fn(jnp.asarray(_tiny_signal()), jnp.asarray(seeds["pulse"]),
             jnp.asarray(seeds["noise"]))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def torch_out(seeds):
    from world_tpu_torch import encode_decode_one

    out = encode_decode_one(torch.tensor(_tiny_signal())[None],
                            torch.tensor(seeds["pulse"]),
                            torch.tensor(seeds["noise"]), FS, FP, **CAPS)
    return {k: v[0].numpy() for k, v in out.items()}


@pytest.mark.parametrize("key", OUTPUTS)
def test_round_trip_output_matches_jax(key, jax_out, torch_out):
    _assert_close(torch_out[key], jax_out[key], key)


def test_round_trip_is_voiced_at_150_hz(torch_out):
    voiced = torch_out["f0"][torch_out["f0"] > 0]
    assert voiced.size > 10 and 140 < np.median(voiced) < 160
    assert np.all(np.isfinite(torch_out["y"])) and np.abs(torch_out["y"]).max() > 0


def test_module_with_jax_tables_matches_jax(jax_out):
    """HarvestRequiem loaded with the JAX package's own tables computes what
    the JAX round trip computes."""
    from world_tpu_torch import HarvestRequiem

    module = HarvestRequiem(FS, N, frame_period=FP, dtype=torch.float64,
                            device="cpu", **CAPS)
    module.from_numpy_state(jax_state(FS))
    out = module(torch.tensor(_tiny_signal()))
    for key in OUTPUTS:
        _assert_close(out[key][0].numpy(), jax_out[key], key)


def _synthesis_inputs(jax_out):
    tp = np.arange(jax_out["f0"].shape[0]) * FP / 1000.0
    return tp, jax_out["f0"], jax_out["vuv"], jax_out["band_aperiodicity"].T


def test_pulse_locations_match_exactly(jax_out):
    """Requiem's pulse table (1-based sample indices and count) is compared
    exactly: the phase cumsum runs over the same float64 values in the same
    order on both sides."""
    import jax.numpy as jnp

    from world_tpu.synth.requiem import _pulse_locations as jax_pulses
    from world_tpu_torch.synth.requiem import pulse_locations

    tp, f0, vuv, _ = _synthesis_inputs(jax_out)
    y_length = int(np.floor((tp.shape[0] - 1) * FP / 1000 * FS)) + 1
    time_axis = np.arange(y_length) / FS + tp[0]
    want = jax_pulses(jnp.asarray(tp), jnp.asarray(f0), jnp.asarray(vuv),
                      float(FS), jnp.asarray(time_axis), 256, FP / 1000.0)
    got = pulse_locations(torch.tensor(tp), torch.tensor(f0), torch.tensor(vuv),
                          float(FS), torch.tensor(time_axis), 256, FP / 1000.0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1]) and int(got[3]) == int(want[3])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_requiem_with_explicit_seed_and_offsets(jax_out):
    """Requiem synthesis from the JAX analysis with seed bank 3 and nonzero
    velvet-noise offsets: the port's excitation and waveform against
    world_tpu.synth.requiem.synthesis_requiem."""
    import jax.numpy as jnp

    from world_tpu.synth.requiem import synthesis_requiem
    from world_tpu.synth.seeds import get_seeds_signals as jax_seeds
    from world_tpu_torch.synth.classic import default_max_pulses
    from world_tpu_torch.synth.requiem import excitation_core, waveform_core
    from world_tpu_torch.synth.seeds import get_seeds_signals

    tp, f0, vuv, band_ap = _synthesis_inputs(jax_out)
    offsets = np.array([5, 1234, 777])
    spec = jax_out["spectrogram"].T
    dat = {"f0": f0, "vuv": vuv, "temporal_positions": tp,
           "aperiodicity": band_ap, "spectrogram": spec, "fs": FS}
    want = np.asarray(synthesis_requiem(dat, dat, jax_seeds(FS, seed=3),
                                        noise_offsets=jnp.asarray(offsets)))
    s = get_seeds_signals(FS, seed=3)
    y_length = len(np.arange(tp[0], tp[-1] + 1 / FS, 1.0 / FS))
    exc, overflow = excitation_core(
        torch.tensor(tp), torch.tensor(f0), torch.tensor(vuv),
        torch.tensor(band_ap), torch.tensor(s["pulse"]), torch.tensor(s["noise"]),
        torch.tensor(offsets), FS, y_length, default_max_pulses(tp, f0),
        FP / 1000.0)
    got = waveform_core(exc, torch.tensor(spec), FS, (spec.shape[0] - 1) * 2,
                        int(FP / 1000 * FS))
    assert not bool(overflow)
    _assert_close(got.numpy(), want, "y")


def test_interp1_extrap_matches_jax():
    """The interpolation Requiem uses on a non-uniform frame grid, with
    extrapolation past both ends."""
    import jax.numpy as jnp

    from world_tpu.dsp.interp import interp1_extrap as jax_interp
    from world_tpu_torch.dsp.interp import interp1_extrap

    rng = np.random.RandomState(4)
    xp = np.cumsum(rng.rand(40) + 0.01)
    fp = rng.randn(3, 40)
    xq = np.linspace(xp[0] - 1.0, xp[-1] + 1.0, 500)
    want = np.stack([np.asarray(jax_interp(jnp.asarray(xp), jnp.asarray(row),
                                           jnp.asarray(xq))) for row in fp])
    got = interp1_extrap(torch.tensor(xp), torch.tensor(fp), torch.tensor(xq))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_batched_rows_equal_single_stream(seeds):
    from world_tpu_torch import encode_decode_one

    xs = np.stack([_tiny_signal(seed) for seed in range(3)])
    args = (torch.tensor(seeds["pulse"]), torch.tensor(seeds["noise"]), FS, FP)
    batch = encode_decode_one(torch.tensor(xs), *args, **CAPS)
    for i in range(3):
        single = encode_decode_one(torch.tensor(xs[i:i + 1]), *args, **CAPS)
        for key in OUTPUTS:
            assert torch.equal(batch[key][i], single[key][0]), (i, key)


def test_x16_golden_bars_float64():
    """World.encode/decode on harvest_16k.npz's x16 (4.644 s at 16 kHz)
    against its float64 goldens: test_api.py's bars."""
    from world_tpu_torch import World

    g = np.load(GOLDEN / "harvest_16k.npz")
    w = World(device="cpu", dtype=torch.float64)
    dat = w.encode(int(g["fs"]), np.asarray(g["x16"]), f0_method="harvest",
                   is_requiem=True)
    vuv = dat["vuv"] > 0
    gvuv = g["vuv"] > 0
    both = vuv & gvuv
    assert np.mean(vuv == gvuv) > 0.99
    assert np.sqrt(np.mean((dat["f0"][both] - g["f0"][both]) ** 2)) < 1.0
    spec = dat["spectrogram"]
    assert spec.shape == g["spectrogram"].shape
    lsd = np.sqrt(np.mean((10 * np.log10(spec[:, both] + 1e-12)
                           - 10 * np.log10(g["spectrogram"][:, both] + 1e-12)) ** 2))
    assert lsd < 1.0, lsd
    assert dat["aperiodicity"].shape == g["band_aperiodicity"].shape
    assert np.max(np.abs(dat["aperiodicity"][:, both]
                         - g["band_aperiodicity"][:, both])) < 1.0
    y = w.decode(dat, seed=0, noise_offsets=[0, 0, 0])["out"]
    assert np.all(np.isfinite(y)) and 0 < np.abs(y).max() <= 1.0


def test_unported_paths_name_their_roadmap_item():
    """No path of world_tpu is left unported: the batch functions take a
    list of devices, and nothing in the package raises NotImplementedError
    but the facade's set_pitch (which raises bare, as the reference's and
    world_tpu's do)."""
    import inspect

    import world_tpu_torch
    from world_tpu_torch import (World, batch_encode_decode,
                                 batch_encode_decode_ragged)

    rng = np.random.RandomState(0)
    x = 0.1 * rng.randn(2, 1600)
    caps = dict(max_pulses=256, max_candidates=8, max_sections=16)
    out = batch_encode_decode(x, 16000, devices=["cpu", "cpu"], **caps)
    assert out["y"].shape[0] == 2 and torch.isfinite(out["y"]).all()
    rows = batch_encode_decode_ragged(list(x), 16000,
                                      devices=("cpu", "cpu", "cpu"))
    assert len(rows) == 2 and all(np.isfinite(r["y"]).all() for r in rows)

    # nothing in the package raises NotImplementedError, bar set_pitch
    pkg = Path(world_tpu_torch.__file__).parent
    raising = {p.relative_to(pkg).as_posix(): n
               for p in pkg.rglob("*.py")
               if (n := p.read_text().count("raise NotImplementedError"))}
    assert raising == {"api.py": 1}, raising
    assert "raise NotImplementedError" in inspect.getsource(World.set_pitch)
    with pytest.raises(NotImplementedError):
        World(device="cpu").set_pitch({}, 0.1, 100.0)
