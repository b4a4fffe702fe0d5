"""The Harvest -> Requiem round trip on the JAX package's static shapes.

The port's counterpart of ``jax.jit(jax.vmap(_encode_decode_one))`` is one
CUDA graph per shape, and a graph captures only code whose shapes depend on
the caps alone and which reads nothing back to the host.  These tests hold
that code, in float64 on the CPU:

  * the static section tables against world_tpu.f0.harvest._sections;
  * FixStep3 and the smoothing over a batch against ``jax.vmap`` of the JAX
    functions, and each row bitwise the port's single-row call;
  * the overlap-add's static core against slotted_ola and bitwise against
    the checked scatter_ola, with the rank bound derived from the caps;
  * the round trip's rows bitwise their single calls;
  * the stages on ``meta`` tensors, which have shapes and no data: a
    data-dependent shape (nonzero) or a host read (item, bool, int, tolist)
    raises there.
"""
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

GOLDEN = Path(__file__).parent / "golden"


def _contour(n, spans, seed):
    """f0 (n,) voiced over ``spans`` [(a, b)], near 150-250 Hz."""
    rng = np.random.RandomState(seed)
    f0 = np.zeros(n)
    for k, (a, b) in enumerate(spans):
        f0[a:b] = 150 + 10 * (k % 10) + np.linspace(0, 8, b - a) + rng.rand()
    return f0


def _rows(n, max_sections):
    """Three contours: a few sections, none, and more than max_sections."""
    few = _contour(n, [(40, 120), (170, 260), (330, 420)], 1)
    many = _contour(n, [(20 + 40 * k, 32 + 40 * k)
                        for k in range((n - 40) // 40)], 2)
    assert (n - 40) // 40 > max_sections
    return np.stack([few, np.zeros(n), many])


def _candidates(f0, C, seed):
    """(C, n) candidates and scores around f0, some of them empty."""
    rng = np.random.RandomState(seed)
    n = f0.shape[0]
    voiced = np.flatnonzero(f0)
    base = (np.interp(np.arange(n), voiced, f0[voiced]) if voiced.size
            else np.full(n, 180.0))
    base = np.where(f0 > 0, f0, base)
    cands = np.where(rng.rand(C, n) < 0.5, base * (1 + 0.04 * rng.randn(C, n)),
                     150 + rng.rand(C, n) * 100)
    cands[rng.rand(C, n) < 0.25] = 0.0
    scores = np.where(cands > 0, rng.rand(C, n) * 10 + 2.5, 0.0)
    return cands, scores


def test_sections_match_jax():
    import jax.numpy as jnp

    from world_tpu.f0.harvest import _sections
    from world_tpu_torch.f0.harvest import sections

    S = 8
    rows = _rows(480, S)
    starts, ends, valid = sections(torch.tensor(rows), S)
    assert starts.shape == ends.shape == valid.shape == (3, S)
    for b, row in enumerate(rows):
        w_st, w_ed, w_count = (np.asarray(a) for a in _sections(jnp.asarray(row), S))
        np.testing.assert_array_equal(starts[b].numpy(), w_st)
        np.testing.assert_array_equal(ends[b].numpy(), w_ed)
        np.testing.assert_array_equal(valid[b].numpy(), np.arange(S) < w_count)
    assert valid.sum(-1).tolist() == [3, 0, S]


def test_fix_step3_batch_matches_jax_vmap():
    import jax
    import jax.numpy as jnp

    from world_tpu.f0.harvest import fix_step3 as jax_fix_step3
    from world_tpu_torch.f0.harvest import fix_step3

    S, C, n = 8, 6, 600
    f0 = _rows(n, S)
    cs = [_candidates(row, C, 10 + b) for b, row in enumerate(f0)]
    cands = np.stack([c for c, _ in cs])
    scores = np.stack([s for _, s in cs])
    want = np.asarray(jax.vmap(partial(jax_fix_step3, allowed_range=0.18,
                                       max_sections=S))(
        jnp.asarray(f0), jnp.asarray(cands), jnp.asarray(scores)))
    args = (torch.tensor(f0), torch.tensor(cands), torch.tensor(scores))
    got = fix_step3(*args, 0.18, S)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    assert np.array_equal(want[1], f0[1])              # no voiced frame
    assert not np.array_equal(want[0], f0[0])          # extended and merged
    for b in range(3):
        single = fix_step3(*(a[b] for a in args), 0.18, S)
        assert torch.equal(single, got[b]), b
    for chunk in (1, 3):
        assert torch.equal(fix_step3(*args, 0.18, S, section_chunk=chunk), got)


def test_smooth_f0_batch_matches_jax_vmap():
    import jax
    import jax.numpy as jnp

    from world_tpu.f0.harvest import smooth_f0 as jax_smooth
    from world_tpu_torch.f0.harvest import smooth_f0

    S, n = 8, 900
    f0 = _rows(n, S)
    want = np.asarray(jax.vmap(partial(jax_smooth, max_sections=S,
                                       section_chunk=2))(jnp.asarray(f0)))
    got = smooth_f0(torch.tensor(f0), S)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    assert not want[1].any() and want[0].any()
    for b in range(3):
        assert torch.equal(smooth_f0(torch.tensor(f0[b]), S), got[b]), b
    assert torch.equal(smooth_f0(torch.tensor(f0), S, section_chunk=3), got)


def _slot_case(rng, counts, W):
    """Starts with ``counts[k]`` rows in slot k (two empty slots between),
    nondecreasing, and parked rows past the end."""
    from world_tpu_torch.dsp.ola import SLOT

    starts = np.concatenate([
        (3 * k + 2) * SLOT + np.sort(rng.choice(SLOT, c, replace=False))
        for k, c in enumerate(counts)]) - W // 2
    y_length = int(starts[-1]) + W // 2
    return np.concatenate([starts, np.full(3, y_length + W + 2)]), y_length


def test_slot_ola_matches_slotted_ola_and_scatter_ola():
    import jax.numpy as jnp

    from world_tpu.dsp.ola import slotted_ola
    from world_tpu_torch.dsp.ola import scatter_ola, slot_ola
    from world_tpu_torch.parallel.batch import round_trip_rank_bound

    bound = round_trip_rank_bound(16000)
    assert bound == 3
    rng = np.random.RandomState(3)
    W = 128
    starts, y_length = _slot_case(rng, list(range(1, bound + 1)) * 3, W)
    resp = rng.randn(2, starts.shape[0], W)
    st = torch.tensor(np.stack([starts, starts]))
    y, crowded = slot_ola(torch.tensor(resp), st, y_length, bound)
    assert y.shape == (2, y_length) and not crowded.any()
    for b in range(2):
        want = np.asarray(slotted_ola(jnp.asarray(resp[b]),
                                      jnp.asarray(starts, jnp.int32), y_length))
        assert np.abs(y[b].numpy() - want).max() <= 1e-12 * np.abs(want).max()
        assert torch.equal(y[b], scatter_ola(torch.tensor(resp[b]), st[b], y_length))
    assert torch.equal(slot_ola(torch.tensor(resp), st, y_length, 32)[0], y)

    # one slot holding one row more than the bound: that row is dropped and
    # flagged, and only in its batch row (row 1 has it parked at the end)
    over, y_len2 = _slot_case(rng, [1, bound + 1, 2], W)
    drop = 1 + bound                               # the last row of slot 1
    parked = np.r_[over[:drop], over[drop + 1:], over[-1]]
    resp2 = torch.tensor(rng.randn(2, over.shape[0], W))
    st2 = torch.tensor(np.stack([over, parked]))
    y2, crowded2 = slot_ola(resp2, st2, y_len2, bound)
    assert crowded2.tolist() == [True, False]
    keep = torch.arange(over.shape[0]) != drop
    assert torch.equal(y2[0], scatter_ola(resp2[0][keep], st2[0][keep], y_len2))
    assert torch.equal(y2[1], scatter_ola(resp2[1], st2[1], y_len2))


@pytest.mark.parametrize("fs", [8000, 16000, 22050, 48000])
def test_rank_bound_holds_for_pulse_trains(fs):
    """The pulses of a constant f0 at the bound's f_max, and of a glide up
    to it, never put more starts in one slot than rank_bound says."""
    from world_tpu_torch.dsp.ola import SLOT, rank_bound
    from world_tpu_torch.synth.classic import sample_times
    from world_tpu_torch.synth.requiem import pulse_locations

    fp = 0.005
    for f_max in (500.0, 913.3, 1700.0):
        n_frames = 201
        tp = torch.arange(n_frames, dtype=torch.float64) * fp
        y_length = int((n_frames - 1) * fp * fs) + 1
        axis = sample_times(y_length, fs, tp[0])
        for f0 in (torch.full((n_frames,), f_max, dtype=torch.float64),
                   torch.linspace(100.0, f_max, n_frames, dtype=torch.float64)):
            pli, count, _, _ = pulse_locations(tp, f0, torch.ones_like(f0),
                                               float(fs), axis, 4096, fp)
            sid = torch.div(pli[:int(count)], SLOT, rounding_mode="floor")
            most = int(torch.unique(sid, return_counts=True)[1].max())
            assert most <= rank_bound(f_max, fs), (fs, f_max, most)


def test_encode_decode_rows_equal_single_calls():
    """Three rows of 0.4 s at 16 kHz, one of them silent: every output of
    each row is bitwise its one-row call."""
    from world_tpu_torch import encode_decode_one
    from world_tpu_torch.parallel.batch import (HARVEST_TABLE_KEYS,
                                                harvest_requiem_tables)

    x = np.asarray(np.load(GOLDEN / "harvest_16k.npz")["x16"])[8000:14400]
    rng = np.random.RandomState(0)
    xs = torch.tensor(np.stack([x, x + 1e-3 * rng.randn(x.shape[0]),
                                np.zeros_like(x)]))
    t = harvest_requiem_tables(16000, 0, torch.float64, "cpu")
    args = (t["pulse_seed"], t["noise_seed"], 16000, 5, 512, 8, 16)
    tabs = {k: t[k] for k in HARVEST_TABLE_KEYS}
    batch = encode_decode_one(xs, *args, tables=tabs)
    assert (batch["vuv"][0] > 0).any() and not (batch["vuv"][2] > 0).any()
    for b in range(3):
        one = encode_decode_one(xs[b:b + 1], *args, tables=tabs)
        for key, v in batch.items():
            assert torch.equal(v[b], one[key][0]), (b, key)


def test_tables_are_built_once():
    from world_tpu_torch import tables
    from world_tpu_torch.f0.harvest import harvest_tables
    from world_tpu_torch.parallel.batch import harvest_requiem_tables

    a = harvest_requiem_tables(16000, 0, torch.float64, "cpu")
    b = harvest_requiem_tables(16000, 0, torch.float64, "cpu")
    assert a is not b and all(a[k] is b[k] for k in a)
    h = harvest_tables(16000, 71.0, 800.0, torch.float64, "cpu")
    assert h["band_bank"] is a["band_bank"]
    with tables.retained() as kept:
        g = tables.frame_grid(929, 5, "cpu")
    assert list(kept.values()) == [g] and g is tables.frame_grid(929, 5.0, "cpu")
    np.testing.assert_array_equal(g.numpy(), np.arange(929) * 5 / 1000)


# ---------------------------------------------------------------------------
# static shapes: the round trip's stages on meta tensors
# ---------------------------------------------------------------------------

META = torch.device("meta")


def _meta(*shape, dtype=torch.float64):
    return torch.empty(shape, dtype=dtype, device=META)


def test_meta_tensors_refuse_host_reads():
    t = _meta(4)
    for read in (lambda: t.nonzero(), lambda: t.sum().item(),
                 lambda: bool(t.sum() > 0), lambda: int(t.sum()),
                 lambda: t.tolist()):
        with pytest.raises((RuntimeError, NotImplementedError)):
            read()


def test_contour_stages_have_static_shapes():
    """harvest_decimated's contour stages, search_f0_base to smooth_f0, over
    a batch of 2 on meta tensors."""
    from world_tpu_torch.f0 import harvest as H

    B, C, n, S = 2, 48, 1200, 32
    cands, scores = _meta(B, C, n), _meta(B, C, n)
    f0_base = H.search_f0_base(cands, scores)
    f0_step2 = H.fix_step2(H.fix_step1(f0_base, 0.008), 6)
    f0_step3 = H.fix_step3(f0_step2, cands, scores, 0.18, S)
    f0_step3c = H.fix_step3(f0_step2, cands, scores, 0.18, S, section_chunk=5)
    f0_step4 = H.fix_step4(f0_step3, 9)
    smoothed = H.smooth_f0(f0_step4, S, _meta(601))
    smoothed_c = H.smooth_f0(f0_step4, S, _meta(601), section_chunk=7)
    overflow = H._n_sections(f0_step4) > S
    for t in (f0_step3, f0_step3c, f0_step4, smoothed, smoothed_c):
        assert t.shape == (B, n) and t.device == META
    assert overflow.shape == (B,)


def test_synthesis_has_static_shapes():
    """pulse_locations, the overlap-add's static core, excitation_core and
    waveform_core over a batch of 2 on meta tensors."""
    from world_tpu_torch.dsp.ola import slot_ola
    from world_tpu_torch.synth.classic import sample_times
    from world_tpu_torch.synth.requiem import (excitation_core,
                                               pulse_locations, waveform_core)

    B, F, fs, P, fft = 2, 101, 16000, 512, 1024
    y_length = 8001
    tp = _meta(F)
    f0, vuv = _meta(B, F), _meta(B, F)
    axis = sample_times(y_length, fs, tp[0])
    pli, count, vuv_i, raw = pulse_locations(tp, f0, vuv, float(fs), axis, P,
                                             0.005)
    assert pli.shape == (B, P) and count.shape == raw.shape == (B,)
    y, crowded = slot_ola(_meta(B, P, fft), pli, y_length, 3)
    assert y.shape == (B, y_length) and crowded.shape == (B,)
    exc, over = excitation_core(tp, f0, vuv, _meta(B, 3, F), _meta(fft, 3),
                                _meta(20000, 3),
                                torch.zeros(3, dtype=torch.int64, device=META),
                                fs, y_length, P, 0.005, 3)
    assert exc.shape == (B, y_length) and over.shape == (B,)
    out = waveform_core(exc, _meta(B, fft // 2 + 1, F), fs, fft, 80)
    assert out.shape == (B, y_length)


def _stub_step3(monkeypatch):
    """K4 and K5 stand in as shapes: K4 returns empty outputs of its own
    shapes, K5 the state it was given."""
    from world_tpu_torch.ops import fix_step3 as K45

    def k4(f0, origin, last_point, shift, cands, allowed_range, n_steps):
        steps = origin.shape + (n_steps,)
        return (torch.empty(steps, dtype=torch.int64, device=f0.device),
                torch.empty(steps, dtype=f0.dtype, device=f0.device),
                torch.empty(steps, dtype=torch.bool, device=f0.device),
                torch.empty_like(origin))

    monkeypatch.setattr(K45, "extend_chains", k4)
    monkeypatch.setattr(K45, "merge_sections", lambda *args: args[11:])


def test_round_trip_has_static_shapes(monkeypatch):
    """encode_decode_one from the decimator to the waveform on meta
    tensors, with the four kernels of the path (K1, K2, and FixStep3's K4
    and K5) standing in as shapes (each returns empty outputs of its own
    shape): nothing else on the round trip reads the data."""
    from world_tpu_torch import encode_decode_one
    from world_tpu_torch.f0 import harvest as H
    from world_tpu_torch.ops import edge_interp
    from world_tpu_torch.parallel.batch import harvest_requiem_tables

    def k1(signals, fs, t_frames, stride):
        return (torch.empty((signals.shape[0], t_frames.shape[0]),
                            dtype=signals.dtype, device=signals.device),
                torch.empty(signals.shape[0], dtype=torch.int32,
                            device=signals.device))

    def k2(seg, phase, f0, *args):
        return torch.empty_like(f0), torch.empty_like(f0)

    monkeypatch.setattr(edge_interp, "interval_interp", k1)
    monkeypatch.setattr(H, "refine_full", k2)
    _stub_step3(monkeypatch)
    t = harvest_requiem_tables(16000, 0, torch.float32, META)
    x = _meta(2, 8000, dtype=torch.float32)
    out = encode_decode_one(x, t["pulse_seed"], t["noise_seed"], 16000, 5,
                            512, 15, 16,
                            tables={k: v for k, v in t.items()
                                    if not k.endswith("_seed")})
    assert out["y"].shape == (2, 8001) and out["_overflow"].shape == (2,)
    assert out["f0"].shape == out["vuv"].shape == (2, 101)
    assert out["spectrogram"].shape == (2, 101, 513)


class _FakeGraph:
    """A captured call for the cache's bookkeeping: replays fn eagerly."""

    def __init__(self, fn, pool):
        self.fn, self.pool = fn, pool

    def replay(self, inputs):
        return self.fn(*inputs)


def _fake_pool_capture(log, needs):
    """A stub of ``graphs._capture`` that grows the shared pool as the
    allocator does: to the largest call's need, each capture adding only
    what the pool lacks (``needs``: bytes by the call's first input's
    length); ``log`` gets (length, pool, kept) of each capture."""

    def fake_capture(fn, inputs, pool, kept):
        need = needs[inputs[0].shape[0]]
        log.append((inputs[0].shape[0], pool, kept))
        pool.bytes += max(0, need - pool.bytes)
        return _FakeGraph(fn, pool)

    return fake_capture


def test_graph_cache_captures_on_the_second_call(monkeypatch):
    """A key's first call runs eagerly, its second captures and replays,
    later calls replay; the graphs share one pool, which the budget counts
    once; past the budget the pool is dropped with its graphs before the
    next capture (the newest kept until then), and a dropped key starts
    again at its first call.  The capture itself is stubbed: the CPU has no
    graphs."""
    from world_tpu_torch.parallel import graphs

    log = []
    monkeypatch.setattr(graphs, "_capture", _fake_pool_capture(
        log, {1: 3, 2: 2, 3: 6, 4: 1}))
    cache = graphs.GraphCache(budget=5)
    double = lambda t: {"y": 2 * t}                            # noqa: E731
    xa, xb, xc, xd = (torch.ones(n) for n in (1, 2, 3, 4))
    for _ in range(3):
        assert torch.equal(cache.run("a", double, (xa,), "cpu")["y"], 2 * xa)
    assert [n for n, _, _ in log] == [1] and cache.calls == {
        "eager": 1, "captured": 1, "replayed": 2}
    cache.run("b", double, (xb,), "cpu")
    cache.run("b", double, (xb,), "cpu")
    # one pool of 3 bytes holds both (two pools of their own, 3 + 2, would
    # have passed the budget of 5)
    assert [n for n, _, _ in log] == [1, 2] and len(cache.graphs()) == 2
    assert cache.pool_bytes() == 3 and cache.dropped == 0
    cache.run("c", double, (xc,), "cpu")
    cache.run("c", double, (xc,), "cpu")
    # the pool grew to c's 6, past the budget: held until the next capture
    assert cache.pool_bytes() == 6 and len(cache.graphs()) == 3
    cache.run("d", double, (xd,), "cpu")
    cache.run("d", double, (xd,), "cpu")
    # d's capture dropped the pool and its three graphs first
    assert cache.dropped == 3 and cache.pool_bytes() == 1
    assert [g.pool for g in cache.graphs()] == [log[-1][1]]
    assert log[-1][1] is not log[0][1]
    cache.run("a", double, (xa,), "cpu")
    assert [n for n, _, _ in log] == [1, 2, 3, 4] and cache.calls["eager"] == 5
    cache.run("a", double, (xa,), "cpu")
    assert [n for n, _, _ in log] == [1, 2, 3, 4, 1] and cache.recaptured == 1
    assert cache.pool_bytes() == 3 and len(cache.graphs()) == 2
    cache.clear()
    assert cache.graphs() == [] and cache.pool_bytes() == 0
    cache.run("a", double, (xa,), "cpu")
    assert len(log) == 5 and cache.calls["eager"] == 6


def test_graph_cache_shares_one_pool_per_device(monkeypatch):
    """Every capture of a cache on one device gets the same pool (and so
    one pool handle), two devices two pools, and two caches their own."""
    from world_tpu_torch.parallel import graphs

    log = []
    monkeypatch.setattr(graphs, "_capture", _fake_pool_capture(
        log, {1: 1, 2: 1, 3: 1}))
    cache, other = graphs.GraphCache(), graphs.GraphCache()
    double = lambda t: {"y": 2 * t}                            # noqa: E731
    for key, n, device, c in (("a", 1, "cpu", cache), ("b", 2, "cpu", cache),
                              ("c", 3, "meta", cache), ("a", 1, "cpu", other)):
        for _ in range(2):
            c.run(key, double, (torch.ones(n),), device)
    a, b, c, d = (pool for _, pool, _ in log)
    assert a is b and a is not c and d not in (a, b, c)
    assert (a.device, c.device) == (torch.device("cpu"), torch.device("meta"))
    assert {id(g.pool) for g in cache.graphs()} == {id(a), id(c)}
    assert cache.pool_bytes() == 2 and other.pool_bytes() == 1


def test_graph_cache_capture_after_eager_call_skips_the_warm_up(monkeypatch):
    """Through ``run`` the capture follows the key's eager first call and
    does not call the function again before it; ``capture`` called directly
    calls it once, eagerly, first.  A capture that fails raises, is not
    retried, and leaves the other graphs in place."""
    from world_tpu_torch.parallel import graphs

    calls = []

    def fn(t):
        calls.append(t.shape[0])
        return {"y": 2 * t}

    log = []
    fake = _fake_pool_capture(log, {1: 1, 2: 1, 3: 1})
    monkeypatch.setattr(graphs, "_capture", fake)
    cache = graphs.GraphCache()
    cache.run("a", fn, (torch.ones(1),), "cpu")
    assert calls == [1]
    cache.run("a", fn, (torch.ones(1),), "cpu")
    # the capture (stubbed) called nothing; the stub's replay called fn once
    assert calls == [1, 1] and len(log) == 1 and log[0][2] == {}
    cache.capture("b", fn, (torch.ones(2),), "cpu")
    assert calls == [1, 1, 2] and len(log) == 2

    def failing(fn, inputs, pool, kept):
        raise graphs.GraphCaptureError("stubbed failure")

    monkeypatch.setattr(graphs, "_capture", failing)
    cache.run("c", fn, (torch.ones(3),), "cpu")
    with pytest.raises(graphs.GraphCaptureError):
        cache.run("c", fn, (torch.ones(3),), "cpu")
    assert calls == [1, 1, 2, 3] and len(cache.graphs()) == 2
    # the failed pool takes no more captures; its graphs stay and replay
    monkeypatch.setattr(graphs, "_capture", fake)
    assert torch.equal(cache.run("a", fn, (torch.ones(1),), "cpu")["y"],
                       2 * torch.ones(1))
    cache.run("c", fn, (torch.ones(3),), "cpu")
    cache.run("c", fn, (torch.ones(3),), "cpu")
    assert log[-1][1] is not log[0][1] and cache.pool_bytes() == 2


def test_graph_cache_keeps_the_eager_call_tables_until_the_capture(monkeypatch):
    """The tables a key's eager call read reach its capture, which finds
    them by key even after the table cache has dropped them (a capture
    cannot upload a table again)."""
    from world_tpu_torch import tables
    from world_tpu_torch.parallel import graphs

    monkeypatch.setattr(tables, "MAX_ENTRIES", 2)
    built = []

    def build():
        built.append(1)
        return torch.arange(3.0)

    def fn(t):
        return {"y": t * tables.cached(("capture-test", 1), build)}

    seen = []

    def fake_capture(fn_, inputs, pool, kept):
        with tables.retained(kept) as held:
            out = fn_(*inputs)
        seen.append((kept, held, out, len(built)))
        return _FakeGraph(fn_, pool)

    monkeypatch.setattr(graphs, "_capture", fake_capture)
    cache = graphs.GraphCache()
    cache.run("a", fn, (torch.ones(3),), "cpu")
    table = tables.cached(("capture-test", 1), build)
    # other tables push it out of the cache
    for i in range(3):
        tables.cached(("capture-test-other", i), lambda: torch.zeros(1))
    assert len(built) == 1
    cache.run("a", fn, (torch.ones(3),), "cpu")
    (kept, held, out, n_built), = seen
    assert n_built == 1 and kept[("capture-test", 1)] is table
    assert held[("capture-test", 1)] is table
    assert torch.equal(out["y"], torch.arange(3.0))


def test_graph_rows_are_powers_of_two():
    from world_tpu_torch.parallel.batch import graph_rows

    assert [graph_rows(n) for n in (1, 2, 3, 4, 5, 8, 9, 110)] == [
        1, 2, 4, 4, 8, 8, 16, 128]


def test_float32_round_trip_repeats_with_four_threads():
    """The float32 Harvest round trip on the CPU with 4 threads, twice in
    one process: every output bitwise equal (the thread count changes the
    float32 digits, a fixed count repeats them; ROADMAP, "Fixed, or kept on
    purpose")."""
    from world_tpu_torch import HarvestRequiem

    x = np.asarray(np.load(GOLDEN / "harvest_small.npz")["x"])
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        module = HarvestRequiem(16000, x.shape[0], dtype=torch.float32,
                                device="cpu")
        xt = torch.tensor(x, dtype=torch.float32)
        first, second = module(xt), module(xt)
    finally:
        torch.set_num_threads(threads)
    assert set(first) == set(second) and len(first) > 3
    for key, value in first.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, second[key]), key
