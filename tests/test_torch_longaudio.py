"""The long-audio bounds of the port: the blocked FIR bank, band chunks,
frame chunks, section chunks and the split of K1's rows.

Every stage runs on tests/golden/harvest_small.npz's x (1 s at 16 kHz) in
float64 on the CPU, with its blocking forced through the stage's argument at
a small size, against its unblocked self and, where the JAX package has the
stage, against world_tpu's stage with the same argument.

Tolerances.  A blocked stage computes each output from the same operands as
the whole one.  From the refinement on, the arithmetic per (candidate,
frame) or per section does not change and the results are compared bitwise.
The FIR bank's blocks hand the matrix product other shapes, so its sums may
associate differently: 1e-12 of the signal's scale against the unblocked
bank (measured 0 on this CPU), and the raw candidates to 1e-9 Hz.  Against
the JAX package the bars are those of test_torch_harvest.py: 1e-9 relative,
1e-9 absolute (summation order only).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

GOLDEN = Path(__file__).parent / "golden"
F0_FLOOR, F0_CEIL = 71.0, 800.0


@pytest.fixture(scope="module")
def small():
    """harvest_small's signal decimated by the port, with Harvest's tables
    and the port's own stage outputs at the small static tables of
    test_harvest_small.py (8 candidates, 64 sections)."""
    from world_tpu_torch.f0 import harvest as H

    g = np.load(GOLDEN / "harvest_small.npz")
    x, fs = torch.tensor(np.asarray(g["x"])), int(g["fs"])
    tables = H.harvest_tables(fs, F0_FLOOR, F0_CEIL, torch.float64, "cpu")
    y, afs = H.downsample(x[None], fs, 8000, h=tables["decimator_ir"])
    tq = torch.as_tensor(np.arange(int(1000 * x.shape[0] / fs + 1)) / 1000)
    stages = H.harvest(x, fs, max_candidates=8, max_sections=64,
                       debug_outputs=True, blocking={})
    return {"x": x, "fs": fs, "y": y, "afs": afs, "tq": tq, "tables": tables,
            "bfl": H.boundary_f0_list(F0_FLOOR, F0_CEIL), "stages": stages}


def _glide(fs, seconds):
    """tools/check_long_audio.py's probe: an octave glide from 110 Hz with
    four harmonics, 200 ms of silence every 2 s, seeded noise of 1e-4."""
    n = int(fs * seconds)
    t = np.arange(n) / fs
    f0 = 110.0 * 2 ** (t / t[-1])
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = sum(a * np.sin(h * phase) for h, a in [(1, 1.0), (2, 0.5), (3, 0.3), (4, 0.2)])
    x = x * np.where(np.floor(t / 2.0) != np.floor((t + 0.2) / 2.0), 0.0, 1.0)
    x = x + 1e-4 * np.random.RandomState(0).randn(n)
    return 0.5 * x / np.abs(x).max()


# ---------------------------------------------------------------------------
# the FIR bank
# ---------------------------------------------------------------------------

def test_fir_bank_full_blocked_matches_whole_and_jax(small):
    import jax.numpy as jnp

    from world_tpu.dsp.fir import fir_bank_full as jax_fir
    from world_tpu_torch.dsp.fir import fir_bank_full

    y, bank = small["y"], small["tables"]["band_bank"][::19]      # 8 bands
    whole = fir_bank_full(y, bank)
    scale = float(whole.abs().max())
    for block in (1024, 1000, 8460, 100000):
        got = fir_bank_full(y, bank, block=block)
        assert got.shape == whole.shape == (1, 8, y.shape[1] + bank.shape[1] - 1)
        assert float((got - whole).abs().max()) <= 1e-12 * scale, block
    want = np.asarray(jax_fir(jnp.asarray(y[0].numpy()), bank.numpy(), block=1024))
    np.testing.assert_allclose(fir_bank_full(y, bank, block=1024)[0].numpy(), want,
                               rtol=1e-9, atol=1e-9 * scale)


@pytest.mark.parametrize("block", [1024, 777, 7999, 8000])
def test_band_filtered_blocked_takes_each_bands_slice(block, small):
    """The blocked bank never builds the full convolution: each block reads
    each band's own offset.  Float32 too, to 2e-6 of the scale (a float32
    dot product of 461 terms in two orders)."""
    from world_tpu_torch.dsp.fir import band_filtered

    t = small["tables"]
    y = torch.cat([small["y"], small["y"].flip(1)])               # two rows
    whole = band_filtered(y, t["band_bank"], t["band_bias"])
    got = band_filtered(y, t["band_bank"], t["band_bias"], block)
    scale = float(whole.abs().max())
    assert got.shape == whole.shape == (2, 152, y.shape[1])
    assert float((got - whole).abs().max()) <= 1e-12 * scale
    y32, bank32 = y.float(), t["band_bank"].float()
    got32 = band_filtered(y32, bank32, t["band_bias"], block)
    assert float((got32 - band_filtered(y32, bank32, t["band_bias"])).abs().max()
                 ) <= 2e-6 * scale


def test_band_blocking_sizes_follow_the_budget():
    """The switch is by bytes alive, batch included: nothing at the 4.6 s
    utterance's size with up to 4 rows in float32, both on at 60 s, and a
    chunk that keeps K1 under its row limit at 110 short rows."""
    from world_tpu_torch._backend import STAGE_BYTES_BUDGET
    from world_tpu_torch.dsp.fir import BAND_STAGE_COPIES, band_blocking
    from world_tpu_torch.f0.harvest import stage_blocking

    assert band_blocking(4, 152, 37152, 461, 4) == (None, None)
    assert band_blocking(1, 216, 37152, 1521, 8) == (None, None)
    chunk, block = band_blocking(1, 152, 441000, 461, 4)
    assert chunk == 38 and 4096 <= block < 441000
    assert BAND_STAGE_COPIES * chunk * 441000 * 4 <= STAGE_BYTES_BUDGET // 2
    assert band_blocking(1, 7, 240000, 273, 4) == (None, None)      # DIO, 60 s
    chunk, _ = band_blocking(110, 152, 4000, 461, 4)
    assert chunk == 38
    none = stage_blocking(4, 37152, 4645, 152, 461, 170, 48, 256, 4)
    assert set(none.values()) == {None}
    long = stage_blocking(1, 4800000, 600001, 152, 461, 170, 48, 18814, 4)
    assert all(v is not None for v in long.values()), long


# ---------------------------------------------------------------------------
# Harvest's stages
# ---------------------------------------------------------------------------

def _raw(small, **kw):
    from world_tpu_torch.f0.harvest import raw_band_candidates

    t = small["tables"]
    return raw_band_candidates(small["y"], small["afs"], t["band_bank"],
                               t["band_bias"], small["bfl"], small["tq"],
                               F0_FLOOR, F0_CEIL, **kw)


@pytest.mark.parametrize("kw", [dict(band_chunk=8), dict(band_chunk=151),
                                dict(band_chunk=8, block=1024), dict(block=3000)],
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_raw_band_candidates_chunked_matches_whole(kw, small):
    """152 bands in chunks of 8 (a ragged last chunk: the JAX package pads
    the bank with zero filters instead) and of 151 (a last chunk of one)."""
    whole = small["stages"]["_raw_candidates"]
    got = _raw(small, **kw)[0]
    assert got.shape == whole.shape
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=1e-9)
    assert torch.equal(got > 0, whole > 0)


def test_raw_band_candidates_band_chunk_matches_jax(small):
    import jax.numpy as jnp

    from world_tpu.f0.harvest import raw_band_candidates as jax_raw

    want = np.asarray(jax_raw(jnp.asarray(small["y"][0].numpy()), small["afs"],
                              small["bfl"], jnp.asarray(small["tq"].numpy()),
                              F0_FLOOR, F0_CEIL, 0, 0, band_chunk=8))
    got = _raw(small, band_chunk=8)[0].numpy()
    assert got.shape == want.shape == (152, 1001)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_band_chunks_launch_k1_once_each(small, monkeypatch):
    from world_tpu_torch.f0 import events

    calls = []
    real = events.batched_interval_interp
    monkeypatch.setattr("world_tpu_torch.ops.edge_interp.batched_interval_interp",
                        lambda s, *a: calls.append(s.shape[0]) or real(s, *a))
    _raw(small, band_chunk=40)
    assert calls == [160, 160, 160, 128]


def _compact(small):
    """The compacted (1, 48, F) candidates harvest_core refines."""
    from world_tpu_torch.f0 import harvest as H

    c1 = small["stages"]["_cands_overlap"][None]
    compactT, _ = H.compact_rows(c1.transpose(-1, -2), c1.transpose(-1, -2) != 0,
                                 H.C2_SLOTS)
    return compactT.transpose(-1, -2).contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_refine_candidates_frame_chunk_is_bitwise(dtype, small):
    from world_tpu_torch.f0 import harvest as H

    max_half, _ = H.refinement_geometry(small["afs"], F0_FLOOR)
    args = (small["y"].to(dtype), small["afs"], small["tq"].to(dtype),
            _compact(small).to(dtype), F0_FLOOR, F0_CEIL, max_half)
    whole = H.refine_candidates(*args)
    assert bool((whole[0] > 0).any())
    for chunk in (64, 1000, 1001):
        got = H.refine_candidates(*args, frame_chunk=chunk)
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1]), chunk


def test_refine_candidates_frame_chunk_matches_jax(small):
    import jax.numpy as jnp

    from world_tpu.f0.harvest import refine_candidates as jax_refine
    from world_tpu_torch.f0 import harvest as H

    max_half, _ = H.refinement_geometry(small["afs"], F0_FLOOR)
    compact = _compact(small)
    want = jax_refine(jnp.asarray(small["y"][0].numpy()), small["afs"],
                      jnp.asarray(small["tq"].numpy()), jnp.asarray(compact[0].numpy()),
                      F0_FLOOR, F0_CEIL, max_half,
                      stride_samples=small["afs"] * 0.001, frame_chunk=64)
    got = H.refine_candidates(small["y"], small["afs"], small["tq"], compact,
                              F0_FLOOR, F0_CEIL, max_half, frame_chunk=64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_remove_unreliable_frame_chunk_is_bitwise_and_matches_jax(dtype, small):
    import jax.numpy as jnp

    from world_tpu.f0.harvest import remove_unreliable as jax_remove
    from world_tpu_torch.f0.harvest import remove_unreliable

    st = small["stages"]
    cands = torch.stack([st["_cands_refined"], st["_cands_refined"].flip(-1)]).to(dtype)
    scores = torch.stack([st["_scores_refined"], st["_scores_refined"].flip(-1)]).to(dtype)
    whole = remove_unreliable(cands, scores)
    assert bool((whole[0] != cands).any())
    for chunk in (1, 64, 1000):
        got = remove_unreliable(cands, scores, frame_chunk=chunk)
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1]), chunk
    if dtype == torch.float64:
        want = jax_remove(jnp.asarray(cands[0].numpy()), jnp.asarray(scores[0].numpy()))
        for g, w in zip(remove_unreliable(cands, scores, frame_chunk=64), want):
            np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=1e-9,
                                       atol=1e-9)


def _sectioned_contour(n=2400, n_sec=9, seed=7):
    """A contour of n_sec voiced sections with candidates and scores around
    it, so that FixStep3 extends, keeps, drops and merges sections."""
    rng = np.random.RandomState(seed)
    f0 = np.zeros(n)
    edges = np.sort(rng.choice(np.arange(40, n - 40, 20), 2 * n_sec, replace=False))
    for k, (a, b) in enumerate(zip(edges[::2], edges[1::2])):
        f0[a:b] = 150 + 10 * k + np.linspace(0, 8, b - a)
    C = 6
    cands = 150 + rng.rand(C, n) * 100
    near = rng.rand(C, n) < 0.4
    base = np.where(f0 > 0, f0, np.interp(np.arange(n), np.flatnonzero(f0),
                                          f0[f0 > 0]))
    cands = np.where(near, base * (1 + 0.05 * rng.randn(C, n)), cands)
    cands[rng.rand(C, n) < 0.25] = 0.0
    scores = np.where(cands > 0, rng.rand(C, n) * 10 + 2.5, 0.0)
    return f0, cands, scores


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fix_step3_section_chunk_is_bitwise(dtype, small):
    from world_tpu_torch.f0.harvest import fix_step3

    st = small["stages"]
    cases = [(st["_f0_step2"], st["_cands_clean"], st["_scores_clean"])]
    cases.append(tuple(torch.tensor(a) for a in _sectioned_contour()))
    for f0, cands, scores in cases:
        args = (f0.to(dtype), cands.to(dtype), scores.to(dtype), 0.18, 64)
        whole = fix_step3(*args)
        assert bool((whole != args[0]).any())
        for chunk in (1, 2, 5, 64):
            assert torch.equal(fix_step3(*args, section_chunk=chunk), whole), chunk


def test_fix_step3_section_chunk_matches_jax():
    import jax.numpy as jnp

    from world_tpu.f0.harvest import fix_step3 as jax_fix_step3
    from world_tpu_torch.f0.harvest import fix_step3

    f0, cands, scores = _sectioned_contour()
    want = np.asarray(jax_fix_step3(jnp.asarray(f0), jnp.asarray(cands),
                                    jnp.asarray(scores), 0.18, max_sections=16))
    got = fix_step3(torch.tensor(f0), torch.tensor(cands), torch.tensor(scores),
                    0.18, max_sections=16, section_chunk=2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_smooth_f0_section_chunk_is_bitwise(dtype, small):
    from world_tpu_torch.f0.harvest import smooth_f0

    kernel = small["tables"]["smooth_kernel"]
    for f0 in (small["stages"]["_f0_step4"], torch.tensor(_sectioned_contour()[0])):
        whole = smooth_f0(f0.to(dtype), 64, kernel)
        assert bool((whole > 0).any())
        for chunk in (1, 2, 7, 64):
            assert torch.equal(smooth_f0(f0.to(dtype), 64, kernel, chunk), whole), chunk


def test_smooth_f0_section_chunk_matches_jax():
    import jax.numpy as jnp

    from world_tpu.f0.harvest import smooth_f0 as jax_smooth
    from world_tpu_torch.f0.harvest import smooth_f0

    f0 = _sectioned_contour(n=900, n_sec=5)[0]
    want = np.asarray(jax_smooth(jnp.asarray(f0), max_sections=8, section_chunk=2))
    got = smooth_f0(torch.tensor(f0), 8, section_chunk=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------------
# DIO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(block=500), dict(band_chunk=3),
                                dict(band_chunk=2, block=1024)],
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_dio_blocked_bank_matches_whole(kw, small):
    """DIO's band stage with its bank blocked and its 7 bands chunked: raw
    candidates to 1e-9 Hz, their stability to 1e-12, the contour equal."""
    from world_tpu_torch.dsp.iir import decimate_world
    from world_tpu_torch.f0 import dio as D

    tables = D.dio_tables(small["fs"], F0_FLOOR, F0_CEIL, 2, 4000, torch.float64,
                          "cpu")
    y = decimate_world(small["x"][None], small["fs"] // 4000,
                       h=tables["dio_decimator_ir"])
    n_frames = D.frame_positions(small["x"].shape[0], small["fs"], 5.0).shape[0]
    args = (y, 4000.0, F0_FLOOR, F0_CEIL, 2, 5.0, 0.1, n_frames,
            tables["dio_bank"], tables["dio_offsets"])
    whole = D.dio_stages(*args)
    got = D.dio_stages(*args, **kw)
    np.testing.assert_allclose(got["raw_f0_candidates"].numpy(),
                               whole["raw_f0_candidates"].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["_raw_stability"].numpy(),
                               whole["_raw_stability"].numpy(), rtol=0, atol=1e-12)
    assert torch.equal(got["vuv"], whole["vuv"])
    np.testing.assert_allclose(got["f0"].numpy(), whole["f0"].numpy(), rtol=0,
                               atol=1e-9)
    assert bool(whole["vuv"].any())


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

def test_more_rows_than_one_k1_launch_are_split(small, monkeypatch):
    """110 short utterances are 110 x 152 x 4 = 66,880 event rows, more than
    the 65,535 of one K1 launch.  The plain K1 has no limit, so this holds
    the split's bookkeeping: every launch is within the limit, together they
    cover every row once, and each row's candidates are those of the same
    utterance analysed on its own."""
    from world_tpu_torch.f0 import events, harvest as H

    rng = np.random.RandomState(3)
    n = 400                                                   # 50 ms at 8 kHz
    t = np.arange(n) / 8000.0
    tones = rng.uniform(90.0, 400.0, 110)
    y = torch.tensor(np.sin(2 * np.pi * tones[:, None] * t[None, :]
                            + rng.rand(110, 1) * 6) + 0.01 * rng.randn(110, n))
    tq = torch.as_tensor(np.arange(51) / 1000)
    tabs = small["tables"]
    args = (8000.0, tabs["band_bank"], tabs["band_bias"], small["bfl"], tq,
            F0_FLOOR, F0_CEIL)
    launched = []
    real = events.batched_interval_interp
    monkeypatch.setattr("world_tpu_torch.ops.edge_interp.batched_interval_interp",
                        lambda s, *a: launched.append(s.shape[0]) or real(s, *a))
    got = H.raw_band_candidates(y, *args)
    # every band asked for in one chunk: 148 bands of 110 rows fit a launch
    assert launched == [110 * 148 * 4, 110 * 4 * 4]
    assert max(launched) <= events.MAX_EVENT_ROWS
    assert got.shape == (110, 152, 51) and bool((got > 0).any())
    launched.clear()
    chunked = H.raw_band_candidates(y, *args, band_chunk=100)
    assert launched == [44000, 22880] and torch.equal(chunked, got)
    for b in (0, 57, 109):
        assert torch.equal(H.raw_band_candidates(y[b:b + 1], *args)[0], got[b]), b


@pytest.mark.parametrize("n_rows, n_bands, band_chunk, want", [
    (1, 152, None, (1, 152)), (4, 152, 38, (4, 38)), (110, 152, None, (110, 148)),
    (110, 152, 38, (110, 38)), (110, 216, 200, (110, 148)), (16383, 7, None, (16383, 1)),
    (20000, 152, 38, (16383, 1)), (0, 7, None, (1, 7))])
def test_launch_pieces_keep_k1_under_its_row_limit(n_rows, n_bands, band_chunk, want):
    from world_tpu_torch.f0.events import MAX_EVENT_ROWS, launch_pieces

    row_piece, chunk = launch_pieces(n_rows, n_bands, band_chunk)
    assert (row_piece, chunk) == want
    assert 4 * row_piece * chunk <= MAX_EVENT_ROWS


def test_more_rows_than_one_band_fits_are_split_by_rows(small, monkeypatch):
    """Where one band of every row is already more than a launch takes, the
    band stages of Harvest and DIO run a piece of the rows at a time.  The
    limit is lowered to 43 event rows here: 25 rows go in pieces of 10, 10
    and 5 (one band at a time, two for the last piece), and give what the
    stage gives unsplit."""
    from world_tpu_torch.f0 import dio as D, events, harvest as H

    rng = np.random.RandomState(5)
    n = 400
    t = np.arange(n) / 8000.0
    tones = rng.uniform(71.0, 80.0, 25)
    y = torch.tensor(np.sin(2 * np.pi * tones[:, None] * t[None, :]
                            + rng.rand(25, 1) * 6) + 0.01 * rng.randn(25, n))
    tq = torch.as_tensor(np.arange(51) / 1000)
    tabs = small["tables"]
    args = (8000.0, tabs["band_bank"][:6], tabs["band_bias"][:6], small["bfl"][:6],
            tq, F0_FLOOR, F0_CEIL)
    dtabs = D.dio_tables(16000, F0_FLOOR, F0_CEIL, 2, 4000, torch.float64, "cpu")
    bfl_d = D.boundary_f0_list(F0_FLOOR, F0_CEIL, 2)
    tq_d = torch.as_tensor(np.arange(11) * 0.005)
    dargs = (y[:, ::2].contiguous(), 4000.0, F0_FLOOR, F0_CEIL, bfl_d, tq_d, 5.0,
             dtabs["dio_bank"], dtabs["dio_offsets"])
    whole = H.raw_band_candidates(y, *args)
    whole_d = D.candidates_and_stability(*dargs)
    assert bool((whole > 0).any()) and bool((whole_d[0] > 0).any())
    launched = []
    real = events.batched_interval_interp
    monkeypatch.setattr("world_tpu_torch.ops.edge_interp.batched_interval_interp",
                        lambda s, *a: launched.append(s.shape[0]) or real(s, *a))
    monkeypatch.setattr(events, "MAX_EVENT_ROWS", 43)
    got = H.raw_band_candidates(y, *args, band_chunk=4)
    assert launched == [40] * 6 + [40] * 6 + [40] * 3
    # chunks give the bank's matrix products other shapes: 1e-9 Hz, as for
    # chunks of bands above
    assert got.shape == (25, 6, 51) and torch.equal(got > 0, whole > 0)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=1e-9)
    launched.clear()
    got_d = D.candidates_and_stability(*dargs)
    n_d = dtabs["dio_bank"].shape[0]
    assert n_d == 7 and launched == [40] * 7 + [40] * 7 + [40, 40, 40, 20]
    assert got_d[0].shape == (25, n_d, 11)
    np.testing.assert_allclose(got_d[0].numpy(), whole_d[0].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got_d[1].numpy(), whole_d[1].numpy(), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the whole of Harvest
# ---------------------------------------------------------------------------

def test_harvest_core_every_bound_forced_on_matches_off():
    """A 6 s glide at 16 kHz through harvest_core with every bound forced on
    (several chunks of each kind) against every bound off: vuv and f0
    equal.  The default blocking at this size is none."""
    from world_tpu_torch.f0 import harvest as H

    fs = 16000
    x = torch.tensor(_glide(fs, 6.0))[None]
    caps = (F0_FLOOR, F0_CEIL, 5.0, H.default_max_candidates(),
            H.default_max_sections(x.shape[1], fs))
    off = H.harvest_core(x, fs, *caps, blocking={})
    on = H.harvest_core(x, fs, *caps, blocking=dict(
        band_chunk=60, block=10000, refine_chunk=2500, unreliable_chunk=1700,
        step3_chunk=2, smooth_chunk=2))
    default = H.harvest_core(x, fs, *caps)
    voiced = off["f0"][off["f0"] > 0]
    assert off["f0"].shape == (1, 1201) and voiced.numel() > 600
    assert 100.0 < float(voiced.median()) < 240.0
    for other in (on, default):
        assert torch.equal(other["vuv"], off["vuv"])
        assert torch.equal(other["f0"], off["f0"])
        assert not bool(other["_section_overflow"].any())
