"""The feature codecs and the VAE MLP of the port against the JAX package,
in float64 on the CPU, on seeded inputs.  The codecs are elementwise
operations, one small matrix product and one FFT each: rtol 1e-10.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def spec():
    """A smooth positive magnitude spectrogram (24 frames, 513 bins)."""
    rng = np.random.RandomState(0)
    k = np.arange(513) / 512
    tilt = np.exp(-3.0 * k)[None, :] * (1 + 0.5 * np.cos(2 * np.pi * 6 * k))[None, :]
    return tilt * (0.5 + rng.rand(24, 1)) + 0.01 * rng.rand(24, 513) + 1e-3


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_mel_scale_matches_jax():
    from world_tpu.features import codecs as J
    from world_tpu_torch.features import codecs as T

    hz = np.array([0.0, 71.0, 700.0, 4000.0, 7999.0])
    _close(T.hz2mel(hz, device="cpu").numpy(), J.hz2mel(hz), rtol=1e-14)
    mel = np.asarray(J.hz2mel(hz))
    _close(T.mel2hz(mel, device="cpu").numpy(), J.mel2hz(mel), rtol=1e-14)
    _close(T.mel2hz(T.hz2mel(_t(hz))).numpy(), hz, rtol=1e-12)


@pytest.mark.parametrize("args", [(), (26, 1024, 22050, 100, 9000),
                                  (32, 1024, 16000, 0, None),
                                  (8, 256, 8000, 300, 3400)])
def test_filterbanks_match_jax(args):
    from world_tpu.features import codecs as J
    from world_tpu_torch.features import codecs as T

    want = np.asarray(J.get_filterbanks(*args))
    np.testing.assert_array_equal(T.filterbank_matrix(*args), want)
    got = T.get_filterbanks(*args, device="cpu")
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want.sum(axis=1) > 0).all()


@pytest.mark.parametrize("kw", [{}, {"prefac": 0.9, "fs": 22050, "nfilt": 26,
                                      "lowfreq": 100, "highfreq": 9000},
                                {"prefac": 0.0, "nfilt": 12}])
def test_encode_lfbank_matches_jax(kw, spec):
    from world_tpu.features import codecs as J
    from world_tpu_torch.features import codecs as T

    got = T.encode_lfbank(_t(spec), **kw)
    _close(got.numpy(), J.encode_lfbank(spec, **kw))
    assert torch.isfinite(got).all()


def test_encode_lfbank_guards_empty_filters():
    """A filter with no energy gives log(float64 eps), not -inf."""
    from world_tpu.features import codecs as J
    from world_tpu_torch.features import codecs as T

    spec = np.zeros((3, 257))
    spec[:, 200:] = 1.0
    got = T.encode_lfbank(_t(spec), nfilt=20).numpy()
    _close(got, J.encode_lfbank(spec, nfilt=20))
    assert np.isfinite(got).all() and got.min() == np.log(np.finfo(np.float64).eps)


@pytest.mark.parametrize("n0,fs,lowhz,highhz", [(12, 16000, 0, 8000),
                                                (40, 16000, 0, 8000),
                                                (25, 22050, 50, 11025),
                                                (1, 16000, 0, 8000)])
def test_encode_mcep_matches_jax(n0, fs, lowhz, highhz, spec):
    from world_tpu.features import codecs as J
    from world_tpu_torch.features import codecs as T

    got = T.encode_mcep(_t(spec), n0, fs, lowhz, highhz)
    assert got.shape == (24, n0)
    _close(got.numpy(), J.encode_mcep(spec, n0, fs, lowhz, highhz))


# decode_mcep's mel grid ends at floor(fft_size * mel2hz(hz2mel(highhz)) / fs),
# where mel2hz(hz2mel(8000)) is 8000 to an ulp either way.  XLA evaluates
# log10(x) as log(x) / log(10), numpy rounds log10 correctly, and the two
# fall on different sides: the JAX package's last edge is fft_size/2 - 1, the
# port's (as the NumPy reference's) is fft_size/2.  The spectra then differ
# above the last edge but one; below it they are held to rtol 1e-10.
def _last_shared_bin(fft_size, fs=16000, lowhz=0, highhz=8000):
    from world_tpu.features import codecs as J

    D = fft_size // 2 + 1
    mel = np.linspace(float(J.hz2mel(lowhz)), float(J.hz2mel(highhz)), D)
    return int(np.floor(fft_size * np.asarray(J.mel2hz(mel)) / fs)[-2])


@pytest.mark.parametrize("n0,fft_size", [(12, 1024), (40, 1024), (25, 512), (1, 256)])
def test_decode_mcep_matches_jax(n0, fft_size):
    from world_tpu.features import codecs as J
    from world_tpu_torch.features import codecs as T

    rng = np.random.RandomState(n0)
    cep = rng.randn(9, n0) / (1 + np.arange(n0))
    got = T.decode_mcep(_t(cep), fft_size).numpy()
    want = np.asarray(J.decode_mcep(cep, fft_size))
    assert got.shape == want.shape == (9, fft_size // 2 + 1)
    top = _last_shared_bin(fft_size) + 1
    assert top >= fft_size // 2 - 4
    _close(got[:, :top], want[:, :top])
    assert np.isfinite(got).all() and (got > 0).all()


def test_decode_mcep_top_edge_follows_numpy_log10():
    """The difference from the JAX package stated above, pinned."""
    from world_tpu.features import codecs as J
    from world_tpu_torch.features import codecs as T

    like = torch.zeros(1, dtype=torch.float64)
    assert T._mel_bins(513, 1024, 16000, 0, 8000, like)[-1] == 512.0
    mel = np.linspace(float(J.hz2mel(0)), float(J.hz2mel(8000)), 513)
    assert np.floor(1024 * np.asarray(J.mel2hz(mel)) / 16000)[-1] == 511.0
    # with another fs the edge lies inside a cell, and the whole spectrum agrees
    cep = np.random.RandomState(5).randn(4, 20) / (1 + np.arange(20))
    _close(T.decode_mcep(_t(cep), 1024, fs=22050, highhz=9000).numpy(),
           J.decode_mcep(cep, 1024, fs=22050, highhz=9000))


def test_mcep_roundtrip_lsd():
    """tests/test_api.py::test_mcep_roundtrip_lsd on the port."""
    from world_tpu_torch import World

    def lsd(A, B):
        return np.mean(np.sqrt(np.mean((20 * np.log10(A / B)) ** 2, axis=1)))

    g = np.load(GOLDEN / "cheaptrick.npz")
    spec = np.sqrt(g["spectrogram"].T)
    w = World(device="cpu")
    mc = w.encode_mcep(spec, n0=40, fs=22050, highhz=11025)
    rec = w.decode_mcep(mc, 1024)
    assert mc.shape == (spec.shape[0], 40) and rec.shape == spec.shape
    assert lsd(spec, rec) < 8.0


@pytest.mark.parametrize("w", [0, 1, 5])
def test_get_context_matches_jax(w, spec):
    from world_tpu.features import codecs as J
    from world_tpu_torch.features import codecs as T

    X = spec[:, :13]
    got = T.get_context(_t(X), w)
    assert got.shape == (24, (2 * w + 1) * 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.get_context(X, w)))


def test_interp_rows_matches_jax_and_numpy():
    from world_tpu.features.codecs import _interp_rows
    from world_tpu_torch.dsp.interp import interp_rows

    import jax.numpy as jnp

    rng = np.random.RandomState(2)
    xp = np.floor(np.cumsum(rng.rand(50) * 1.5))        # ascending, with ties
    Y = rng.randn(4, 50)
    xq = np.linspace(xp[0] - 2, xp[-1] + 2, 300)
    got = interp_rows(_t(xq), _t(xp), _t(Y)).numpy()
    _close(got, _interp_rows(jnp.asarray(xq), jnp.asarray(xp), jnp.asarray(Y)),
           rtol=1e-13)
    strict = np.cumsum(rng.rand(50) + 0.1)
    got = interp_rows(_t(xq), _t(strict), _t(Y)).numpy()
    for r in range(4):
        np.testing.assert_allclose(got[r], np.interp(xq, strict, Y[r]),
                                   rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the VAE MLP
# ---------------------------------------------------------------------------

SIZES = (39, 32, 32, 12)


def _weights(sizes, seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    return [((rng.randn(a, b) / np.sqrt(a)).astype(dtype),
             (0.1 * rng.randn(b)).astype(dtype))
            for a, b in zip(sizes[:-1], sizes[1:])]


@pytest.mark.parametrize("acts", [("relu", "relu", "linear"),
                                  ("tanh", "sigmoid", "softplus"),
                                  ("elu", "relu", "tanh")])
def test_mlp_matches_jax_through_from_numpy_state(acts):
    from world_tpu.features.vae import MLP as JaxMLP
    from world_tpu_torch.features.vae import MLP

    jm = JaxMLP(_weights(SIZES, 1), acts)
    state = [(np.asarray(w), np.asarray(b)) for w, b in jm.weights]
    tm = MLP.from_numpy_state(state, jm.activations, device="cpu")
    assert [tuple(layer.weight.shape) for layer in tm.layers] == [
        (b, a) for a, b in zip(SIZES[:-1], SIZES[1:])]
    assert tm.layers[0].weight.dtype == torch.float64
    X = np.random.RandomState(2).randn(17, 39)
    got = tm.predict(X, batch_size=4)
    assert isinstance(got, np.ndarray) and got.shape == (17, 12)
    _close(got, jm.predict(X), rtol=1e-12)


def test_mlp_float32_weights_and_unknown_activation():
    from world_tpu_torch.features.vae import MLP

    tm = MLP(_weights(SIZES, 3, np.float32), ("relu", "relu", "linear"),
             device="cpu")
    assert tm.layers[0].weight.dtype == torch.float32
    X = np.random.RandomState(4).randn(5, 39)
    h = X.astype(np.float32)
    for i, (w, b) in enumerate(_weights(SIZES, 3, np.float32)):
        h = h @ w + b
        if i < 2:
            h = np.maximum(h, 0)
    np.testing.assert_allclose(tm.predict(X), h, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown activation"):
        MLP(_weights(SIZES, 3), ("relu", "swish", "linear"), device="cpu")


def _write_keras_h5(path, weights, acts, nested=True):
    import h5py

    names = [f"dense_{i + 1}" for i in range(len(weights))]
    layers = [{"class_name": "InputLayer", "config": {"name": "input_1"}}]
    layers += [{"class_name": "Dense",
                "config": {"name": n, "activation": a}}
               for n, a in zip(names, acts)]
    config = {"class_name": "Sequential",
              "config": {"layers": layers} if nested else layers}
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(config)
        mw = f.create_group("model_weights")
        for n, (w, b) in zip(names, weights):
            g = mw.create_group(n).create_group(n)
            g.create_dataset("kernel:0", data=w)
            g.create_dataset("bias:0", data=b)


@pytest.mark.parametrize("nested", [True, False])
def test_from_keras_h5_matches_jax(nested, tmp_path):
    pytest.importorskip("h5py")
    from world_tpu.features.vae import MLP as JaxMLP
    from world_tpu_torch.features.vae import MLP, load_manifold_vae

    acts = ("relu", "relu", "linear")
    enc_w, dec_w = _weights(SIZES, 5, np.float32), _weights(SIZES[::-1], 6, np.float32)
    _write_keras_h5(tmp_path / "enc.h5", enc_w, acts, nested)
    _write_keras_h5(tmp_path / "dec.h5", dec_w, acts, nested)
    tm = MLP.from_keras_h5(tmp_path / "enc.h5", device="cpu")
    jm = JaxMLP.from_keras_h5(tmp_path / "enc.h5")
    assert tm.activations == jm.activations == list(acts)
    X = np.random.RandomState(7).randn(6, 39).astype(np.float32)
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=1e-5, atol=1e-6)
    enc, dec = load_manifold_vae(tmp_path / "enc.h5", tmp_path / "dec.h5",
                                 device="cpu")
    assert dec.predict(enc.predict(X)).shape == (6, 39)


def test_encode_vae_through_world_matches_jax():
    """World.encode_vae with MLPs carried across by from_numpy_state, window
    1 and n0 14: (2 * 1 + 1) * 13 = 39 inputs."""
    from world_tpu import World as JaxWorld
    from world_tpu.features.vae import MLP as JaxMLP
    from world_tpu_torch import World
    from world_tpu_torch.features.vae import MLP

    acts = ("relu", "relu", "linear")
    jenc, jdec = JaxMLP(_weights(SIZES, 8), acts), JaxMLP(_weights(SIZES[::-1], 9), acts)
    carry = lambda m: MLP.from_numpy_state(                     # noqa: E731
        [(np.asarray(w), np.asarray(b)) for w, b in m.weights], m.activations,
        device="cpu")
    rng = np.random.RandomState(1)
    Xc, energy = rng.randn(50, 13), rng.randn(50)
    wz, wy = JaxWorld().encode_vae(Xc.copy(), energy, jenc, jdec, 1, 14, 16, 0.25)
    gz, gy = World(device="cpu").encode_vae(Xc.copy(), energy, carry(jenc),
                                            carry(jdec), 1, 14, 16, 0.25)
    assert gz.shape == (50, 12) and gy.shape == (50, 14)
    _close(gz, wz, rtol=1e-12)
    _close(gy, wy, rtol=1e-12)
    np.testing.assert_array_equal(gy[:, 0], energy)


def test_world_codec_methods_return_numpy(spec):
    from world_tpu import World as JaxWorld
    from world_tpu_torch import World

    w, jw = World(device="cpu"), JaxWorld()
    for name, args in (("hz2mel", (np.array([100.0, 4000.0]),)),
                       ("mel2hz", (np.array([150.0, 2000.0]),)),
                       ("get_filterbanks", (20, 512, 16000, 0, None)),
                       ("encode_lfbank", (spec,)),
                       ("encode_mcep", (spec, 20)),
                       ("get_context", (spec[:, :5], 2))):
        got = getattr(w, name)(*args)
        assert isinstance(got, np.ndarray), name
        _close(got, getattr(jw, name)(*args))
