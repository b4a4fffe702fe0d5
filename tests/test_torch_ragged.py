"""Ragged batch serving in the port: batch_encode_decode_ragged groups
utterances into length buckets and runs each bucket as one rectangular
Harvest -> CheapTrick -> D4C-Requiem -> Requiem call.

The contract is tests/test_aux.py::test_ragged_batch_rows_match_single_runs':
each row equals a one-utterance call at the same padded length (vuv equal,
f0 within 1e-3 Hz, waveform relative L2 < 1e-2, envelope drift < 0.05 dB).
One bucket is also held to the JAX package's batch_encode_decode_ragged, in
float32 on both sides.
"""
import warnings

import numpy as np
import pytest
import torch

FS, FP = 12000, 10
QUANTUM = 3072 / FS
KEYS = ("f0", "vuv", "spectrogram", "band_aperiodicity", "y")


def _chirps():
    rng = np.random.RandomState(0)

    def chirp(n, f_lo, scale):
        t = np.arange(n) / FS
        f0_true = f_lo + 40.0 * t / t[-1]
        ph = 2 * np.pi * np.cumsum(f0_true) / FS
        base = sum((0.6 ** k) * np.sin((k + 1) * ph) for k in range(4))
        return (base * scale * (0.4 + 0.25 * np.sin(2 * np.pi * 1.7 * t) ** 2)
                + 0.01 * rng.randn(n)).astype(np.float32)

    return [chirp(2500, 130.0, 0.8), chirp(4000, 150.0, 0.7),
            chirp(2900, 170.0, 0.9)]


def _ragged(xs, devices="cpu", **kw):
    from world_tpu_torch import batch_encode_decode_ragged

    return batch_encode_decode_ragged(xs, FS, devices=devices, frame_period=FP,
                                      bucket_quantum_s=QUANTUM, **kw)


@pytest.fixture(scope="module")
def xs():
    return _chirps()


@pytest.fixture(scope="module")
def mixed(xs):
    return _ragged(xs)


def test_bucket_lengths():
    from world_tpu_torch.parallel.batch import bucket_lengths

    assert bucket_lengths([2500, 4000, 2900], FS, QUANTUM) == {
        3072: [0, 2], 6144: [1]}
    # ascending length; an exact multiple stays; nothing is shorter than one
    # quantum
    assert list(bucket_lengths([16000, 1, 16001, 40000], 16000, 1.0).items()) == [
        (16000, [0, 1]), (32000, [2]), (48000, [3])]


@pytest.mark.parametrize("i", [0, 1, 2])
def test_ragged_rows_match_single_runs(i, xs, mixed):
    single = _ragged([xs[i]])[0]
    nf = int(1000 * len(xs[i]) / FS / FP + 1)
    y_len = int(np.floor((nf - 1) * FP / 1000 * FS)) + 1
    row = mixed[i]
    assert set(row) == set(KEYS)
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
               for v in row.values())
    assert row["f0"].shape == row["vuv"].shape == (nf,)
    assert row["spectrogram"].shape == (nf, 257)
    assert row["band_aperiodicity"].shape == (nf, 3)
    assert row["y"].shape == (y_len,)
    np.testing.assert_array_equal(row["vuv"], single["vuv"])
    assert np.abs(row["f0"] - single["f0"]).max() < 1e-3
    rel = (np.linalg.norm(row["y"] - single["y"])
           / max(np.linalg.norm(single["y"]), 1e-30))
    assert rel < 1e-2
    ddb = np.abs(10 * np.log10(row["spectrogram"] + 1e-12)
                 - 10 * np.log10(single["spectrogram"] + 1e-12)).max()
    assert ddb < 0.05
    # each row's own voiced share and glide
    f_lo = (130.0, 150.0, 170.0)[i]
    assert (row["f0"] > 0).mean() > 0.3
    voiced = row["f0"][row["f0"] > 0]
    assert f_lo - 10 < np.median(voiced) < f_lo + 50


def test_one_bucket_matches_jax_float32(xs):
    """The bucket of one row (4000 samples padded to 6144) against the JAX
    package, float32 on both sides: the decisions are equal and f0 within
    1e-3 Hz.  The float32 envelopes are held to the repo's 1 dB
    log-spectral bar only: the JAX package's float32 CheapTrick guards its
    smoothing with float32's eps, the port with float64's (ROADMAP.md,
    Queue 3), and noise-floor bins differ by up to 1 dB."""
    from world_tpu.parallel.batch import batch_encode_decode_ragged as jax_ragged

    want = jax_ragged([xs[1]], FS, frame_period=FP, bucket_quantum_s=QUANTUM)[0]
    got = _ragged([xs[1]])[0]
    for k in KEYS:
        assert got[k].shape == np.asarray(want[k]).shape, k
    np.testing.assert_array_equal(got["vuv"], np.asarray(want["vuv"]))
    assert np.abs(got["f0"] - np.asarray(want["f0"])).max() < 1e-3
    voiced = got["vuv"] > 0
    assert voiced.mean() > 0.3
    lsd = np.sqrt(np.mean((10 * np.log10(got["spectrogram"][voiced] + 1e-12)
                           - 10 * np.log10(np.asarray(want["spectrogram"])[voiced]
                                           + 1e-12)) ** 2))
    assert lsd < 1.0, lsd


def test_padded_tail_is_unvoiced_and_float64_runs(xs):
    from world_tpu_torch import batch_encode_decode

    xb = np.zeros((2, 6144))
    xb[0, :2500] = xs[0]
    xb[1, :2900] = xs[2]
    out = batch_encode_decode(xb, FS, devices=["cpu"], frame_period=FP,
                              dtype=torch.float64)
    assert out["f0"].dtype == torch.float64 and out["f0"].shape == (2, 52)
    tail = int(1000 * 2900 / FS / FP + 1) + 3
    assert not out["vuv"][:, tail:].any()
    assert not out["f0"][:, tail:].any()
    assert torch.isfinite(out["y"]).all() and not out["_overflow"].any()


def test_tables_are_built_once_per_call(xs, monkeypatch):
    from world_tpu_torch.parallel import batch as PB

    calls = []
    real = PB.harvest_requiem_tables
    monkeypatch.setattr(PB, "harvest_requiem_tables",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    out = _ragged(xs)
    assert len(calls) == 1 and len(out) == 3


def test_batch_tensor_input_and_seed(xs):
    """A tensor batch stays a tensor batch; another seed bank changes the
    waveform and nothing of the analysis."""
    from world_tpu_torch import batch_encode_decode

    xb = torch.zeros((1, 3072))
    xb[0, :2500] = torch.tensor(xs[0])
    a = batch_encode_decode(xb, FS, devices=torch.device("cpu"), frame_period=FP)
    b = batch_encode_decode(xb, FS, devices="cpu", frame_period=FP, seed=3)
    assert a["y"].dtype == torch.float32 and a["y"].shape == (1, 3001)
    assert torch.equal(a["f0"], b["f0"]) and torch.equal(a["spectrogram"],
                                                         b["spectrogram"])
    assert not torch.equal(a["y"], b["y"])


def test_warn_batch_capacity_plumbing():
    from world_tpu_torch.parallel.batch import _warn_batch_capacity

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _warn_batch_capacity(np.array([False, False]), 256, 512)
    assert not rec
    with pytest.warns(RuntimeWarning, match=r"utterance\(s\) \[1, 3\]"):
        _warn_batch_capacity(np.array([False, True, False, True]), 4, 256)


def test_batch_overflow_warns_end_to_end():
    """Three tone bursts against max_sections=2: the batch call raises the
    saturation warning, and check_capacity=False keeps it quiet."""
    from world_tpu_torch import batch_encode_decode

    n = 3072
    rng = np.random.RandomState(0)
    t = np.arange(n) / FS
    x = np.sin(2 * np.pi * 150 * t) + 0.01 * rng.randn(n)
    gate = np.zeros(n)
    for s in (0.0, 0.09, 0.18):
        gate[int(s * FS):int((s + 0.06) * FS)] = 1.0
    xs = np.stack([x * gate, x * gate * 0.5]).astype(np.float32)
    caps = dict(frame_period=FP, max_pulses=256, max_candidates=8, max_sections=2)
    with pytest.warns(RuntimeWarning, match="saturated for utterance"):
        out = batch_encode_decode(xs, FS, devices="cpu", **caps)
    assert torch.isfinite(out["y"]).all()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        batch_encode_decode(xs, FS, devices="cpu", check_capacity=False, **caps)


def test_two_devices_give_the_one_device_rows(xs, mixed):
    """The ragged batch over two devices gives each row within the row bars
    above of the one-device batch (a bucket's rows now run in two calls of
    one row each, and float32 sums depend on the batch's shape), and each
    device's shard of a rectangular batch is bitwise the one-device call on
    the same rows."""
    from world_tpu_torch import batch_encode_decode

    rows = _ragged(xs, devices=["cpu", "cpu"])
    for row, one in zip(rows, mixed):
        np.testing.assert_array_equal(row["vuv"], one["vuv"])
        assert np.abs(row["f0"] - one["f0"]).max() < 1e-3
        assert (np.linalg.norm(row["y"] - one["y"])
                / max(np.linalg.norm(one["y"]), 1e-30)) < 1e-2
        assert np.abs(10 * np.log10(row["spectrogram"] + 1e-12)
                      - 10 * np.log10(one["spectrogram"] + 1e-12)).max() < 0.05
    xb = np.zeros((2, 3072), np.float32)
    xb[0, :2500], xb[1, :2900] = xs[0], xs[2]
    two = batch_encode_decode(xb, FS, devices=["cpu", "cpu"], frame_period=FP)
    for r in range(2):
        one = batch_encode_decode(xb[r:r + 1], FS, devices="cpu", frame_period=FP)
        for k in KEYS + ("_overflow",):
            assert torch.equal(two[k][r:r + 1], one[k]), (r, k)


def test_batch_without_cuda_needs_the_cpu_by_name(xs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from world_tpu_torch import batch_encode_decode_ragged

    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_encode_decode_ragged(xs, FS)
