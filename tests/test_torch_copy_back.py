"""The copy back of the round trips' outputs to the host
(world_tpu_torch/parallel/graphs.py::copy_back): ``DioClassic`` and
``HarvestClassic`` return their outputs on the host, and
``batch_encode_decode_ragged`` its arrays, copied on the card into pinned
host tensors that are the caller's to keep.

On the CPU, at test_torch_classic.py's tiny geometry (fs 12000, 3072
samples, 10 ms; ~3 s, most of it Harvest's first call): the classic
modules' outputs are the round trip's own host tensors, bitwise
``encode_decode_classic_one`` on the module's tables, with nothing copied;
the ragged entry's arrays are bitwise those of its path before the copy
back (``batch_encode_decode``, each output read with ``frames.host``, then
stripped); ``copy_back`` hands host tensors back as they are and counts
them.

Marked ``gpu`` (``python -m pytest --noconftest tests/test_torch_copy_back.py
-m gpu -q`` on the card): both classic modules' outputs, eager, captured
and replayed, are pinned host tensors bitwise the round trip's tensors on
the card copied with ``.cpu()``; the outputs a caller holds are never
written by later calls of the same signature on other inputs; the ragged
entry's arrays are bitwise its path before the copy back; the copy back's
span has device time, and its counters count every byte and, once the
outputs held use up the allocator's free pinned blocks, fresh ones, and
none once they are let go.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from world_tpu_torch.utils.profiling import TRACER, tracing

ROOT = Path(__file__).resolve().parent.parent
TINY_FS, TINY_N, TINY_FP = 12000, 3072, 10
MODULES = ("DioClassic", "HarvestClassic")
# each module's card case: rate, samples a row, audio, the rows' offsets
# and another call's
CARD_CASES = {"DioClassic": (16000, 16000, "x16", (0, 30000), (10000, 50000)),
              "HarvestClassic": (48000, 48000, "x48", (30000, 100000),
                                 (60000, 150000))}


def _tiny_signal(seed=0):
    t = np.arange(TINY_N) / TINY_FS
    rng = np.random.RandomState(seed)
    return (0.6 * (np.sin(2 * np.pi * 150 * t) + 0.3 * np.sin(2 * np.pi * 300 * t))
            + 0.01 * rng.randn(TINY_N)).astype(np.float32)


def _module(name, fs, n, frame_period, device):
    import world_tpu_torch

    return getattr(world_tpu_torch, name)(fs, n, frame_period,
                                          dtype=torch.float32, device=device)


def _noise(module, rows, seed, device):
    _, mp, mn = module.caps()
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((rows, mp, mn), generator=g, device=device)


def _ragged_before(xs, fs, devices, frame_period, quantum_s):
    """``batch_encode_decode_ragged``'s arrays by its path before the copy
    back: each bucket through ``batch_encode_decode``, each output read
    with ``frames.host``, then stripped."""
    from world_tpu_torch.frames import host
    from world_tpu_torch.parallel.batch import (batch_encode_decode,
                                                bucket_lengths, graph_rows,
                                                output_length)

    lens = [x.shape[0] for x in xs]
    on_card = torch.device(devices).type == "cuda"
    results = [None] * len(xs)
    for L, idxs in bucket_lengths(lens, fs, quantum_s).items():
        xb = np.zeros((graph_rows(len(idxs)) if on_card else len(idxs), L),
                      np.float32)
        for r, i in enumerate(idxs):
            xb[r, :lens[i]] = xs[i]
        out = batch_encode_decode(xb, fs, devices=devices,
                                  frame_period=frame_period)
        out = {k: host(out[k]) for k in ("f0", "vuv", "spectrogram",
                                         "band_aperiodicity", "y")}
        for r, i in enumerate(idxs):
            nf = int(1000 * lens[i] / fs / frame_period + 1)
            y_len = output_length(lens[i], fs, frame_period)
            results[i] = {k: (v[r][:y_len] if k == "y" else v[r][:nf])
                          for k, v in out.items()}
    return results


def _assert_same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------------------
# the CPU path, which stays as it was
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODULES)
def test_classic_module_returns_its_own_host_tensors_on_the_cpu(name):
    from world_tpu_torch.parallel.batch import encode_decode_classic_one

    module = _module(name, TINY_FS, TINY_N, TINY_FP, "cpu")
    xb = torch.tensor(np.stack([_tiny_signal(0), _tiny_signal(1)]))
    noise = _noise(module, 2, 3, "cpu")
    TRACER.clear()
    got = module(xb, noise=noise)
    counts = TRACER.counters()
    want = encode_decode_classic_one(xb, TINY_FS, TINY_FP, noise=noise,
                                     tables=dict(module.named_buffers()),
                                     f0_method=module.F0_METHOD)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].device.type == "cpu" and not got[k].is_pinned(), k
        assert got[k].stride() == v.stride() and torch.equal(got[k], v), k
    assert counts["copy_back.bytes"] == counts["host.syncs"] == 0


def test_ragged_arrays_on_the_cpu_are_the_path_before_the_copy_back():
    from world_tpu_torch import batch_encode_decode_ragged

    xs = [_tiny_signal(0)[:2500], _tiny_signal(1)[:2000], _tiny_signal(2)]
    quantum = TINY_N / TINY_FS
    TRACER.clear()
    got = batch_encode_decode_ragged(xs, TINY_FS, devices="cpu",
                                     frame_period=TINY_FP,
                                     bucket_quantum_s=quantum)
    counts = TRACER.counters()
    _assert_same_arrays(got, _ragged_before(xs, TINY_FS, "cpu", TINY_FP,
                                            quantum))
    # one bucket of three rows, five outputs copied back at once
    assert counts["copy_back.bytes"] > 0 and counts["copy_back.fresh_bytes"] == 0


def test_copy_back_hands_host_tensors_back_as_they_are():
    from world_tpu_torch.parallel.graphs import copy_back

    a = torch.arange(12.0).reshape(3, 4).T
    b = torch.zeros(5, dtype=torch.int8)
    TRACER.clear()
    with tracing():
        out = copy_back({"a": a, "b": b})
    spans = TRACER.spans()
    counts = TRACER.counters()
    TRACER.clear()
    assert list(out) == ["a", "b"] and out["a"] is a and out["b"] is b
    assert [s.name for s in spans] == ["world.batch.copy_back"]
    assert spans[0].device_ms is None
    assert counts["copy_back.bytes"] == counts["bytes.d2h"] == 4 * 12 + 5
    assert counts["copy_back.fresh_bytes"] == 0 and counts["host.syncs"] == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned copies and the graphs")
    return torch.device("cuda", 0)


def _audio(stem):
    if stem == "x16":
        return np.load(ROOT / "tests" / "golden" / "harvest_16k.npz")["x16"]
    return np.load(ROOT / "benchmark" / "data" / f"{stem}.npy")


def _card_case(name, cuda):
    """The module, and two calls' rows and noise draws of one signature."""
    fs, n, stem, first, second = CARD_CASES[name]
    x = _audio(stem).astype(np.float32)
    module = _module(name, fs, n, 5, cuda)
    calls = [(torch.tensor(np.stack([x[o:o + n] for o in offsets]), device=cuda),
              _noise(module, 2, seed, cuda))
             for seed, offsets in enumerate((first, second))]
    return module, calls


def _assert_pinned(out, want):
    assert set(out) == set(want)
    for k, v in want.items():
        got = out[k]
        assert got.device.type == "cpu" and got.is_pinned(), k
        assert (got.shape, got.dtype) == (v.shape, v.dtype), k
        assert torch.equal(got, v), k


@pytest.mark.gpu
@pytest.mark.parametrize("name", MODULES)
def test_classic_outputs_are_pinned_and_the_card_bits(cuda, name):
    """Eager, capture and replay: pinned host tensors, bitwise the round
    trip's own tensors on the card copied with ``.cpu()``."""
    module, ((xb, noise), _) = _card_case(name, cuda)
    want = {k: v.cpu() for k, v in module._round_trip(xb, noise).items()}
    for _ in range(3):
        _assert_pinned(module(xb, noise=noise), want)
    assert module.graphs.calls == {"eager": 1, "captured": 1, "replayed": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("name", MODULES)
def test_held_outputs_are_never_written_again(cuda, name):
    """A caller's outputs of the first (eager) call and of a replay stay as
    they were while later calls of the signature run on other inputs."""
    module, ((xb, noise), (xb2, noise2)) = _card_case(name, cuda)
    first = module(xb, noise=noise)                     # eager
    kept = {k: v.clone() for k, v in first.items()}
    other = [module(xb2, noise=noise2) for _ in range(2)]   # capture, replay
    replay = module(xb, noise=noise)
    kept_replay = {k: v.clone() for k, v in replay.items()}
    other += [module(xb2, noise=noise2) for _ in range(2)]
    torch.cuda.synchronize()
    assert not torch.equal(other[0]["y"], kept["y"])
    for held, copy in ((first, kept), (replay, kept_replay)):
        for k, v in copy.items():
            assert torch.equal(held[k], v), k
    ptrs = [v.data_ptr() for out in [first, replay] + other
            for v in out.values() if v.numel()]
    assert len(set(ptrs)) == len(ptrs)
    for out in other:
        for k, v in out.items():
            assert torch.equal(v, other[0][k]), k


@pytest.mark.gpu
def test_ragged_arrays_are_the_path_before_the_copy_back(cuda):
    from world_tpu_torch import batch_encode_decode_ragged

    x = _audio("x16").astype(np.float32)
    xs = [x[:16000], x[20000:34400], x[40000:47000]]
    want = _ragged_before(xs, 16000, cuda, 5, 1.0)
    for _ in range(3):                                  # eager, capture, replay
        _assert_same_arrays(batch_encode_decode_ragged(xs, 16000, devices=cuda),
                            want)


@pytest.mark.gpu
def test_copy_back_traced_and_counted_on_the_card(cuda):
    module, ((xb, noise), _) = _card_case("DioClassic", cuda)
    for _ in range(2):                                  # eager, capture
        module(xb, noise=noise)
    TRACER.clear()
    with tracing():
        out = module(xb, noise=noise)
    spans = TRACER.spans()
    TRACER.clear()
    (root,) = [s for s in spans if s.parent is None]
    (copy,) = [s for s in spans if s.name == "world.batch.copy_back"]
    assert root.name == "world.batch.dio_classic" and copy.device_ms > 0
    n_bytes = sum(v.nbytes for v in out.values())
    assert root.counts["copy_back.bytes"] == root.counts["bytes.d2h"] == n_bytes
    assert root.counts["host.syncs"] == 1
    # outputs held use up the free pinned blocks of the largest outputs' size
    # class: a call then pins them afresh; once they are let go, a call pins
    # nothing new (the fresh bytes are read while the tracer records)
    largest = sum(sorted(v.nbytes for v in out.values())[-2:])
    held, fresh = [out], []
    with tracing():
        for _ in range(16):
            before = TRACER.counters()["copy_back.fresh_bytes"]
            held.append(module(xb, noise=noise))
            fresh.append(TRACER.counters()["copy_back.fresh_bytes"] - before)
            if fresh[-1] >= largest:
                break
        assert largest <= fresh[-1] <= n_bytes, fresh
        del held, out
        before = TRACER.counters()["copy_back.fresh_bytes"]
        module(xb, noise=noise)
        assert TRACER.counters()["copy_back.fresh_bytes"] == before
    # with the tracer off the allocator is not asked
    held = [module(xb, noise=noise) for _ in range(4)]
    assert TRACER.counters()["copy_back.fresh_bytes"] == before
    TRACER.clear()
