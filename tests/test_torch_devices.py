"""A list of devices in the port: batches sharded over utterances
(batch_encode_decode, batch_encode_decode_ragged) and CheapTrick sharded
over frames (frame_sharded_cheaptrick), one worker thread per device.

On this machine every device is the CPU, named several times: that runs the
split, the padding, the threads and the gather.  Each device's shard is
compared bitwise with the one-device call on the same rows (the same
program on the same shapes).  frame_sharded_cheaptrick is held to
world_tpu.parallel.batch.frame_sharded_cheaptrick on a 4-device CPU mesh in
float64: the envelope within 1e-7 relative (measured 1.3e-8; the cepstral
lifter spreads the last bits of the noise-floor bins over every bin, and the
JAX package's own sharded and unsharded paths differ by 1.4e-9) and
total_energy within 1e-9 relative, and to the 0.2 dB bar on a 1e-7 floor of
tests/test_aux.py against cheaptrick.  The signal is test_aux.py's 200 Hz
tone with seeded noise of 0.01: a pure tone's empty bins make the envelope
ill-conditioned (the JAX package's two paths then differ by 3e-5).
"""
import threading
import warnings

import numpy as np
import pytest
import torch

FS, FP, N = 12000, 10, 3072
CAPS = dict(frame_period=FP, max_pulses=256, max_candidates=8, max_sections=16)
KEYS = ("f0", "vuv", "spectrogram", "band_aperiodicity", "y", "_overflow")


def _tones(n_rows, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(N) / FS
    return np.stack([
        0.6 * (np.sin(2 * np.pi * f * t) + 0.3 * np.sin(2 * np.pi * 2 * f * t))
        + 0.01 * rng.randn(N) for f in np.linspace(120.0, 210.0, n_rows)])


@pytest.fixture(scope="module")
def xs():
    return _tones(4)


@pytest.fixture(scope="module")
def one_device(xs):
    from world_tpu_torch import batch_encode_decode

    return batch_encode_decode(xs, FS, devices="cpu", dtype=torch.float64, **CAPS)


def _batch(x, devices, **kw):
    from world_tpu_torch import batch_encode_decode

    return batch_encode_decode(x, FS, devices=devices, dtype=torch.float64,
                               **dict(CAPS, **kw))


def test_make_devices():
    from world_tpu_torch import make_devices

    assert make_devices("cpu") == [torch.device("cpu")]
    assert make_devices(["cpu", torch.device("cpu")]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="empty"):
        make_devices([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_devices()


@pytest.mark.parametrize("n_dev,n_rows", [(3, 4), (4, 1)])
def test_each_shard_is_bitwise_its_one_device_call(n_dev, n_rows, xs):
    """Rows are padded with zero rows to a multiple of the devices, each
    device takes a contiguous block, and the padding is stripped: 4 rows on
    3 devices are blocks of 2, 2 and (padding only) 0 real rows."""
    x = xs[:n_rows]
    out = _batch(x, ["cpu"] * n_dev)
    per_dev = -(-n_rows // n_dev)
    padded = np.concatenate([x, np.zeros((per_dev * n_dev - n_rows, N))])
    for k in range(n_dev):
        lo, hi = k * per_dev, min((k + 1) * per_dev, n_rows)
        if lo >= hi:
            continue
        own = _batch(padded[lo:lo + per_dev], "cpu")
        for key in KEYS:
            assert out[key].shape[0] == n_rows, key
            assert torch.equal(out[key][lo:hi], own[key][:hi - lo]), (k, key)
    assert bool(out["vuv"].any()) and torch.isfinite(out["y"]).all()


def test_sharded_batch_equals_one_device_batch_in_float64(xs, one_device):
    """Batched rows are independent (test_torch_pipeline.py holds each row
    bitwise to its single stream), so in float64 on the CPU the sharded
    batch is the one-device batch, row for row; a tensor batch is taken
    too, and the result lies on the first device."""
    out = _batch(torch.tensor(xs), ["cpu", "cpu"])
    for key in KEYS:
        assert torch.equal(out[key], one_device[key]), key
    assert out["y"].device == torch.device("cpu")


def test_workers_run_on_their_own_threads(xs, monkeypatch):
    from world_tpu_torch.parallel import batch as PB

    seen = []
    real = PB.encode_decode_one
    monkeypatch.setattr(PB, "encode_decode_one", lambda x, *a, **k: (
        seen.append((threading.current_thread().name, x.shape[0])),
        real(x, *a, **k))[1])
    _batch(xs[:2], ["cpu", "cpu"])
    assert sorted(n for _, n in seen) == [1, 1]
    assert len({name for name, _ in seen}) == 2
    assert threading.current_thread().name not in {name for name, _ in seen}
    seen.clear()
    _batch(xs[:1], "cpu")
    assert seen == [(threading.current_thread().name, 1)]


def test_a_workers_exception_reaches_the_caller(xs, monkeypatch):
    from world_tpu_torch.parallel import batch as PB

    def boom(x, *a, **k):
        raise FloatingPointError("from a worker")

    monkeypatch.setattr(PB, "encode_decode_one", boom)
    with pytest.raises(FloatingPointError, match="from a worker"):
        _batch(xs, ["cpu", "cpu"])


def test_capacity_warning_of_a_worker_reaches_the_caller():
    """Three tone bursts against max_sections=2 saturate the section table
    of both rows, each on its own worker: the caller gets one warning that
    names both rows, read from the gathered flags after the join."""
    rng = np.random.RandomState(0)
    t = np.arange(N) / FS
    x = np.sin(2 * np.pi * 150 * t) + 0.01 * rng.randn(N)
    gate = np.zeros(N)
    for s in (0.0, 0.09, 0.18):
        gate[int(s * FS):int((s + 0.06) * FS)] = 1.0
    x2 = np.stack([x * gate, x * gate * 0.5])
    with pytest.warns(RuntimeWarning, match=r"saturated for utterance\(s\) \[0, 1\]"):
        out = _batch(x2, ["cpu", "cpu"], max_sections=2)
    assert out["_overflow"].tolist() == [True, True]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _batch(x2, ["cpu", "cpu"], max_sections=2, check_capacity=False)


def test_tables_are_given_or_built_once_per_device(xs, monkeypatch):
    from world_tpu_torch import batch_encode_decode_ragged
    from world_tpu_torch.parallel import batch as PB

    built = []
    real = PB.harvest_requiem_tables
    monkeypatch.setattr(PB, "harvest_requiem_tables",
                        lambda *a, **k: built.append(a[-1]) or real(*a, **k))
    rows = batch_encode_decode_ragged(
        [xs[0, :2500], xs[1], xs[2, :2900], xs[3, :1000]], FS,
        devices=["cpu", "cpu", "cpu"], frame_period=FP, bucket_quantum_s=N / FS / 2)
    assert len(rows) == 4 and len(built) == 3          # three buckets, one build
    tables = real(FS, 0, torch.float64, "cpu")
    with pytest.raises(ValueError, match="1 table dicts for 2 devices"):
        _batch(xs, ["cpu", "cpu"], tables=tables)
    out = _batch(xs, ["cpu", "cpu"], tables=[tables, tables])
    assert len(built) == 3 and out["y"].shape[0] == 4


def test_ragged_over_two_devices_matches_one_row_for_row(xs):
    """Float32, as a server runs it: each row of the two-device call against
    the one-device call at tests/test_aux.py's row bars (vuv equal, f0
    within 1e-3 Hz, waveform relative L2 < 1e-2, envelope < 0.05 dB)."""
    from world_tpu_torch import batch_encode_decode_ragged

    utts = [xs[0, :2500].astype(np.float32), xs[1].astype(np.float32),
            xs[2, :2900].astype(np.float32)]
    kw = dict(frame_period=FP, bucket_quantum_s=N / FS)
    one = batch_encode_decode_ragged(utts, FS, devices="cpu", **kw)
    two = batch_encode_decode_ragged(utts, FS, devices=["cpu", "cpu"], **kw)
    for a, b, u in zip(two, one, utts):
        assert a["f0"].shape == b["f0"].shape == (int(1000 * len(u) / FS / FP + 1),)
        np.testing.assert_array_equal(a["vuv"], b["vuv"])
        assert np.abs(a["f0"] - b["f0"]).max() < 1e-3
        assert (np.linalg.norm(a["y"] - b["y"])
                / max(np.linalg.norm(b["y"]), 1e-30)) < 1e-2
        assert np.abs(10 * np.log10(a["spectrogram"] + 1e-12)
                      - 10 * np.log10(b["spectrogram"] + 1e-12)).max() < 0.05
        assert (a["f0"] > 0).mean() > 0.3


@pytest.fixture(scope="module")
def tone():
    fs, n = 22050, 8192
    x = (np.sin(2 * np.pi * 200 * np.arange(n) / fs)
         + 0.01 * np.random.RandomState(0).randn(n))
    n_frames = int(1000 * n / fs / 5 + 1)
    f0 = np.full(n_frames, 200.0)
    f0[:6] = 0.0
    vuv = (f0 > 0).astype(np.float64)
    return fs, x, f0, vuv, np.arange(n_frames) * 5 / 1000


def test_frame_sharded_cheaptrick_matches_jax_on_a_mesh_of_four(tone):
    import jax
    import jax.numpy as jnp

    from world_tpu.parallel.batch import frame_sharded_cheaptrick as jax_sharded
    from world_tpu.parallel.batch import make_mesh
    from world_tpu_torch import frame_sharded_cheaptrick

    fs, x, f0, vuv, tp = tone
    assert len(jax.devices()) >= 4 and f0.shape[0] % 4 == 3     # one padding frame
    want_env, want_tot = jax_sharded(jnp.asarray(x), jnp.asarray(f0),
                                     jnp.asarray(vuv), jnp.asarray(tp), fs,
                                     make_mesh(jax.devices()[:4]))
    env, tot = frame_sharded_cheaptrick(x, f0, vuv, tp, fs, ["cpu"] * 4)
    assert env.dtype == torch.float64 and env.shape == (f0.shape[0], 513)
    np.testing.assert_allclose(env.numpy(), np.asarray(want_env), rtol=1e-7)
    np.testing.assert_allclose(float(tot), float(want_tot), rtol=1e-9)
    # the padding frame's envelope is in the total
    assert float(tot) > float(env.sum()) * (1 + 1e-6)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 5])
def test_frame_sharded_cheaptrick_matches_cheaptrick(n_dev, tone):
    from world_tpu_torch import frame_sharded_cheaptrick
    from world_tpu_torch.spectral.cheaptrick import cheaptrick

    fs, x, f0, vuv, tp = tone
    xt = torch.tensor(x)
    ref = cheaptrick(xt, fs, dict(f0=f0, vuv=vuv, temporal_positions=tp))
    env, tot = frame_sharded_cheaptrick(xt, f0, vuv, tp, fs, ["cpu"] * n_dev)
    a = 10 * np.log10(env.numpy() + 1e-7)
    b = 10 * np.log10(ref["spectrogram"].T.numpy() + 1e-7)
    assert np.abs(a - b).max() < 0.2
    pad = (-f0.shape[0]) % n_dev
    padded = dict(f0=np.r_[np.where(vuv == 0, 500.0, f0), np.full(pad, 500.0)],
                  vuv=np.ones(f0.shape[0] + pad),
                  temporal_positions=np.r_[tp, np.zeros(pad)])
    want = float(cheaptrick(xt, fs, padded)["spectrogram"].sum())
    np.testing.assert_allclose(float(tot), want, rtol=1e-12)
    # float32 in, float32 out, an explicit fft_size
    env32, _ = frame_sharded_cheaptrick(xt.float(), f0, vuv, tp, fs,
                                        ["cpu"] * n_dev, fft_size=2048)
    assert env32.dtype == torch.float32 and env32.shape == (f0.shape[0], 1025)


def test_launch_counter_counts_from_many_threads():
    from world_tpu_torch._backend import LaunchCounter

    counter = LaunchCounter()

    def work():
        for _ in range(2000):
            counter.add()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counter.launches == 16000
