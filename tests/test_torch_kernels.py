"""The port's two kernels against the JAX package's.

K1 (event engine) and K2 (Harvest refinement): each plain PyTorch version is
held, in float64, to the JAX package's XLA twin and to its Pallas kernel run
in interpret mode, at test_ops.py's shapes.  The CUDA kernels are held to the
plain versions on the card (``gpu`` marker; skipped without CUDA).  JAX is
imported only by the tests that use it, so that the ``gpu`` tests also run
where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu -q
"""
from fractions import Fraction

import numpy as np
import pytest
import torch
from smoke_loader import chip_smoke as _chip_smoke

# K1 geometries as (actual_fs, stride in samples per frame): Harvest's 8 kHz
# analysis at 1 ms frames (stride 8/1), the 22.05 kHz input's 7350 Hz
# analysis (stride 147/20) and DIO's 4 kHz analysis at 5 ms frames
# (stride 20/1)
GEOMETRIES = ((8000.0, 8.0), (7350.0, 7.35), (4000.0, 20.0))
GEOMETRY_IDS = ("8000.0", "7350.0", "4000.0")


def _event_rows(fs, seed=1, n=3000):
    """test_ops.py's rows: noisy tones, an edgeless row, a near-noise row."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / fs
    rows = []
    for f in (80.0, 125.0, 333.0, 707.0):
        rows.extend([np.sin(2 * np.pi * f * t + rng.rand() * 6)
                     + 0.05 * rng.randn(n) for _ in range(3)])
    rows.append(np.zeros(n))
    rows.append(rng.randn(n) * 1e-6)
    return np.stack(rows)


def _assert_f0_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    both_nan = np.isnan(got) & np.isnan(want)
    np.testing.assert_allclose(np.where(both_nan, 0.0, got),
                               np.where(both_nan, 0.0, want),
                               rtol=rtol, atol=rtol)


@pytest.mark.parametrize("fs,stride", GEOMETRIES, ids=GEOMETRY_IDS)
def test_k1_plain_matches_xla_twin(fs, stride):
    import jax.numpy as jnp

    from world_tpu.f0.events import batched_interval_interp as jax_k1
    from world_tpu_torch.f0.events import batched_interval_interp

    x = _event_rows(fs)
    tq = np.arange(int(x.shape[1] / stride) + 25) * (stride / fs)   # past the end
    want_f0, want_m = jax_k1(jnp.asarray(x), fs, jnp.asarray(tq), stride)
    got_f0, got_m = batched_interval_interp(torch.tensor(x), fs,
                                            torch.tensor(tq), stride)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    _assert_f0_close(got_f0.numpy(), want_f0, rtol=1e-10)


@pytest.mark.parametrize("fs,stride", GEOMETRIES, ids=GEOMETRY_IDS)
def test_k1_plain_matches_pallas_interpret(fs, stride):
    import jax.numpy as jnp

    from world_tpu.ops.edge_interp import _interval_interp_pallas
    from world_tpu_torch.ops.edge_interp import interval_interp

    x = _event_rows(fs, seed=2)
    Q = int(x.shape[1] / stride) + 25
    tq = np.arange(Q) * (stride / fs)
    frac = Fraction(stride).limit_denominator(1000)
    want_f0, want_m = _interval_interp_pallas(
        jnp.asarray(x), jnp.asarray(tq), fs, frac.numerator, frac.denominator,
        Q, blk=8, interpret=True)
    got_f0, got_m = interval_interp(torch.tensor(x), fs, torch.tensor(tq),
                                    stride)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    _assert_f0_close(got_f0.numpy(), want_f0, rtol=1e-10)


def _refine_operands(seed, C=5, B=200, W=45, actual_fs=7350.0):
    """test_ops.py's refinement operands, with empty slots."""
    rng = np.random.RandomState(seed)
    seg = rng.randn(B, W)
    phase = rng.randn(B, W) * 1e-3
    f0 = rng.rand(C, B) * 700 + 80
    f0[0, :7] = 1e-12                       # empty slots
    return seg, phase, f0, actual_fs, (W - 1) // 2


def test_k2_plain_matches_xla_twin():
    import jax.numpy as jnp

    from world_tpu.ops.refine_dft import dft_basis, refine_full_xla
    from world_tpu_torch.ops.refine_dft import refine_plain

    seg, phase, f0, afs, mh = _refine_operands(0)
    W = seg.shape[1]
    nb = 33                                  # S = 64
    want = refine_full_xla(jnp.asarray(seg), jnp.asarray(phase), jnp.asarray(f0),
                           dft_basis(W, nb, jnp.float64), afs, mh, nb, 71.0,
                           800.0)
    got = refine_plain(torch.tensor(seg), torch.tensor(phase), torch.tensor(f0),
                       afs, mh, 2 * (nb - 1), 71.0, 800.0)
    assert int((np.asarray(want[0]) > 0).sum()) > 100   # the gate passes many
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("W", [45, 341])
def test_k2_plain_matches_pallas_interpret(W):
    """At test_ops.py's shape and at the main path's window width (8 kHz
    analysis, max_half 170, S = 1024)."""
    import jax.numpy as jnp

    from world_tpu.ops.refine_dft import _refine_pallas, dft_basis
    from world_tpu_torch.ops.refine_dft import refine_full

    afs = 7350.0 if W == 45 else 8000.0
    seg, phase, f0, afs, mh = _refine_operands(1, C=4, B=150, W=W,
                                               actual_fs=afs)
    S = int(2 ** np.ceil(np.log2(W) + 1))
    nb = S // 2 + 1
    want = _refine_pallas(jnp.asarray(seg), jnp.asarray(phase), jnp.asarray(f0),
                          dft_basis(W, nb, jnp.float64), afs, mh, nb, 71.0,
                          800.0, interpret=True)
    got = refine_full(torch.tensor(seg), torch.tensor(phase), torch.tensor(f0),
                      afs, mh, S, 71.0, 800.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-12)


def test_wrappers_take_plain_path_on_cpu_without_counting():
    from world_tpu_torch.ops import edge_interp, refine_dft

    before = (edge_interp.counter.launches, refine_dft.counter.launches)
    x = torch.tensor(_event_rows(8000.0, n=400))
    edge_interp.interval_interp(x, 8000.0, torch.arange(40) / 1000.0, 8.0)
    seg, phase, f0, afs, mh = _refine_operands(2, C=2, B=20)
    refine_dft.refine_full(torch.tensor(seg), torch.tensor(phase),
                           torch.tensor(f0), afs, mh, 64, 71.0, 800.0)
    assert (edge_interp.counter.launches, refine_dft.counter.launches) == before


@pytest.mark.parametrize("n", [2, 3, 4, 5, 4095, 4096, 4097, 8193, 12288, 37152])
def test_crossing_capacity_holds_alternating_rows(n):
    """An alternating-sign row crosses at every other sample, the most a row
    can: the plain count reaches ceil((n-1)/2) and never exceeds the
    kernel's per-row capacity, and each tile's crossings fit its segment."""
    from world_tpu_torch.f0.events import crossings, edge_table
    from world_tpu_torch.ops.edge_interp import EVENT_TILE, crossing_capacity

    rng = np.random.RandomState(n)
    alt = (-1.0) ** np.arange(n) * (1 + rng.rand(n))
    x = torch.tensor(np.stack([alt, -alt, rng.randn(n)]))
    _, cnt = edge_table(x, 4, 8.0)
    assert int(cnt[0]) == -(-(n - 1) // 2)
    assert int(cnt.max()) <= crossing_capacity(n)
    mask, _ = crossings(x)
    for t0 in range(0, n, EVENT_TILE):
        per_tile = mask[:, t0:t0 + EVENT_TILE].sum(dim=1)
        assert int(per_tile.max()) <= EVENT_TILE // 2
        assert t0 // 2 + int(per_tile.max()) <= crossing_capacity(n)


@pytest.mark.parametrize("rows,n,Q,itemsize", [(608, 37152, 4645, 4),
                                               (28, 18579, 929, 8),
                                               (1, 2, 1, 4)])
def test_event_scratch_layout_is_disjoint_and_aligned(rows, n, Q, itemsize):
    from world_tpu_torch.ops.edge_interp import (EVENT_TILE, crossing_capacity,
                                                 event_scratch_layout)

    lay = event_scratch_layout(rows, n, Q, itemsize)
    assert lay["n_tiles"] == -(-n // EVENT_TILE)
    spans = [(lay["pos"], rows * crossing_capacity(n) * itemsize),
             (lay["rank"], rows * Q * 4),
             (lay["tile_count"], rows * lay["n_tiles"] * 4)]
    for (a, size), (b, _) in zip(spans, spans[1:] + [(lay["bytes"], 0)]):
        assert a % 256 == 0 and a + size <= b


# ---------------------------------------------------------------------------
# the CUDA kernels (need the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fs,stride", GEOMETRIES, ids=GEOMETRY_IDS)
def test_k1_cuda_matches_plain(cuda, fs, stride, dtype):
    """Same operations in the same order: bitwise equal."""
    from world_tpu_torch.f0.events import batched_interval_interp
    from world_tpu_torch.ops.edge_interp import counter, event_engine_cuda

    x = torch.tensor(_event_rows(fs, n=20000), dtype=dtype, device=cuda)
    tq = torch.as_tensor(np.arange(int(20000 / stride)) * (stride / fs),
                         dtype=dtype, device=cuda)
    before = counter.launches
    got_f0, got_m = event_engine_cuda(x, fs, tq, stride)
    assert counter.launches == before + 1
    want_f0, want_m = batched_interval_interp(x, fs, tq, stride)
    assert torch.equal(got_m, want_m)
    assert torch.equal(torch.nan_to_num(got_f0), torch.nan_to_num(want_f0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_cuda_matches_plain(cuda, dtype):
    """float64: rtol 1e-9; float32: the 24 dot products are summed in
    another order, so refined f0 agrees to 1e-4 relative where both gates
    pass and the gate flips on at most 0.1% of the slots."""
    from world_tpu_torch.ops.refine_dft import refine_cuda, refine_plain

    seg, phase, f0, afs, mh = _refine_operands(3, C=8, B=600, W=341,
                                               actual_fs=8000.0)
    args = [torch.tensor(a, dtype=dtype, device=cuda) for a in (seg, phase, f0)]
    got = refine_cuda(*args, afs, mh, 1024, 71.0, 800.0)
    want = refine_plain(*args, afs, mh, 1024, 71.0, 800.0)
    if dtype == torch.float64:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-12)
        return
    both = (got[0] > 0) & (want[0] > 0)
    rel = ((got[0] - want[0]).abs() / want[0].clamp(min=1e-30))[both]
    assert float(rel.max()) <= 1e-4
    flips = int(((got[0] > 0) != (want[0] > 0)).sum())
    assert flips <= 1e-3 * got[0].numel()


@pytest.mark.gpu
def test_kernels_refuse_bad_input(cuda):
    from world_tpu_torch.ops.edge_interp import event_engine_cuda
    from world_tpu_torch.ops.refine_dft import refine_cuda

    x = torch.zeros((4, 100), device=cuda)
    with pytest.raises(TypeError):
        event_engine_cuda(x, 8000.0, torch.zeros(10, dtype=torch.float64,
                                                 device=cuda), 8.0)
    with pytest.raises(ValueError):
        event_engine_cuda(x.t(), 8000.0, torch.zeros(10, device=cuda), 8.0)
    seg = torch.zeros((10, 45), device=cuda)
    with pytest.raises(ValueError):
        refine_cuda(seg, seg, torch.zeros((2, 10), device=cuda), 8000.0, 21,
                    64, 71.0, 800.0)


def _k1_edge_rows(n, seed=4):
    """Rows at K1's edges: alternating signs (a crossing at every other
    sample), one crossing deep in the row, no crossing, a noise row."""
    rng = np.random.RandomState(seed)
    alt = (-1.0) ** np.arange(n) * (1 + rng.rand(n))
    one = np.ones(n)
    one[(3 * n) // 4:] = -1.0
    return np.stack([alt, -alt, one, np.ones(n), rng.randn(n)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("length", ["one_tile_plus_one", "three_tiles_odd"])
def test_k1_cuda_matches_plain_at_edges(cuda, length, dtype):
    """Alternating rows (n/2 crossings), one crossing, none; a row one tile
    plus one sample long; frames past the row's end.  Bitwise equal."""
    from world_tpu_torch.f0.events import batched_interval_interp
    from world_tpu_torch.ops.edge_interp import EVENT_TILE, event_engine_cuda

    n = {"one_tile_plus_one": EVENT_TILE + 1,
         "three_tiles_odd": 3 * EVENT_TILE - 1001}[length]
    x = torch.tensor(_k1_edge_rows(n), dtype=dtype, device=cuda)
    tq = torch.as_tensor(np.arange(n // 8 + 30) / 1000, dtype=dtype, device=cuda)
    got_f0, got_m = event_engine_cuda(x, 8000.0, tq, 8.0)
    want_f0, want_m = batched_interval_interp(x, 8000.0, tq, 8.0)
    assert int(want_m[0]) == -(-(n - 1) // 2) - 1
    assert torch.equal(got_m, want_m)
    assert torch.equal(torch.nan_to_num(got_f0), torch.nan_to_num(want_f0))


def _harvest_small_operands(device, dtype, f0_floor=71.0, pad_to=None):
    """Both kernels' real Harvest operands on harvest_small.npz (1 s at
    16 kHz, zero-padded to ``pad_to`` samples), built through the port's
    front end: K1's (rows, actual_fs, tq, stride) and K2's (seg, phase, f0,
    actual_fs, max_half, S)."""
    from pathlib import Path

    from world_tpu_torch.dsp.scanops import compact_rows
    from world_tpu_torch.f0 import harvest as H
    from world_tpu_torch.f0.events import event_rows

    g = np.load(Path(__file__).parent / "golden" / "harvest_small.npz")
    fs = int(g["fs"])
    x = torch.tensor(np.asarray(g["x"]), dtype=dtype, device=device)[None]
    if pad_to is not None:
        x = torch.nn.functional.pad(x, (0, pad_to - x.shape[1]))
    tables = H.harvest_tables(fs, f0_floor, 800.0, dtype, device)
    y, afs = H.downsample(x, fs, 8000, h=tables["decimator_ir"])
    n_frames = int(1000 * x.shape[1] / fs + 1)
    tq = torch.as_tensor(np.arange(n_frames) / 1000, dtype=dtype, device=device)
    filtered = H.band_filtered(y, tables["band_bank"], tables["band_bias"])
    rows = event_rows(filtered.reshape(-1, filtered.shape[-1]))
    raw = H.raw_band_candidates(y, afs, tables["band_bank"], tables["band_bias"],
                                H.boundary_f0_list(f0_floor, 800.0), tq,
                                f0_floor, 800.0)
    cands, _ = H.detect_candidates(raw, H.default_max_candidates(f0_floor, 800.0))
    cands = H.overlap_candidates(cands).transpose(-1, -2)
    compact, _ = compact_rows(cands, cands != 0, H.C2_SLOTS)
    max_half, S = H.refinement_geometry(afs, f0_floor)
    seg, phase, f0 = H.refinement_inputs(y, afs, tq, compact.transpose(-1, -2),
                                         max_half)
    return (rows, afs, tq, afs * 0.001), (seg, phase, f0, afs, max_half, S)


def _harvest_small_refine_operands(device, dtype):
    return _harvest_small_operands(device, dtype)[1]


# the geometries the facade and the ragged batch add: a 2 s bucket holding
# the 1 s utterance and its zero tail, and fft_size 2048 at 16 kHz, whose
# f0 floor of 23.4 Hz gives 864 event rows, W = 1025 and S = 4096
NEW_GEOMETRIES = {"short_bucket": dict(pad_to=32000),
                  "fft_size_2048": dict(f0_floor=3.0 * 16000 / 2048)}


def test_new_geometries_have_the_stated_shapes():
    for name, (rows, W, S) in (("short_bucket", (608, 341, 1024)),
                               ("fft_size_2048", (864, 1025, 4096))):
        k1, k2 = _harvest_small_operands("cpu", torch.float64, **NEW_GEOMETRIES[name])
        assert k1[0].shape[0] == rows and k2[0].shape[1] == W and k2[5] == S
        assert k2[2].shape[0] == 48 and int((k2[2] > 1e-6).sum()) > 100


def test_shared_memory_sizes_follow_the_geometry(monkeypatch):
    """Shared memory and the grid are sized from the shapes by the launchers
    alone; where one refuses the shapes, its wrapper raises ValueError naming
    them and counts no launch (the launch itself is stood in for here: there
    is no card)."""
    from world_tpu_torch import _backend
    from world_tpu_torch.ops import edge_interp, refine_dft

    def refuse(name, dtype, *args):
        raise _backend.KernelGeometryError(f"world_{name}: cudaError 1")

    for mod in (edge_interp, refine_dft):
        monkeypatch.setattr(mod, "launch", refuse)
        monkeypatch.setattr(mod, "check_kernel_input", lambda *a: None)
    before = (edge_interp.counter.launches, refine_dft.counter.launches)
    seg = torch.zeros((4, 8193), dtype=torch.float64)
    with pytest.raises(ValueError, match=r"\(2, 4, 8193, 32768\).*shared memory"):
        refine_dft.refine_cuda(seg, seg, torch.full((2, 4), 100.0,
                                                    dtype=torch.float64),
                               8000.0, 4096, 32768, 1.0, 800.0)
    with pytest.raises(ValueError, match=r"rows 7 x samples 64, Q 8 frames"):
        edge_interp.event_engine_cuda(torch.zeros((7, 64)), 8000.0,
                                      torch.zeros(8), 8.0)
    assert (edge_interp.counter.launches, refine_dft.counter.launches) == before
    assert issubclass(_backend.KernelGeometryError, ValueError)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("geometry", sorted(NEW_GEOMETRIES))
def test_kernels_cuda_at_new_geometries(cuda, geometry, dtype):
    """K1 bitwise and K2 within its bars at the short bucket's and the
    fft_size=2048 geometry."""
    from world_tpu_torch.f0.events import batched_interval_interp
    from world_tpu_torch.ops.edge_interp import event_engine_cuda
    from world_tpu_torch.ops.refine_dft import refine_cuda, refine_plain

    k1, k2 = _harvest_small_operands(cuda, dtype, **NEW_GEOMETRIES[geometry])
    got_f0, got_m = event_engine_cuda(*k1)
    want_f0, want_m = batched_interval_interp(*k1)
    assert torch.equal(got_m, want_m)
    assert torch.equal(torch.nan_to_num(got_f0), torch.nan_to_num(want_f0))
    floor = NEW_GEOMETRIES[geometry].get("f0_floor", 71.0)
    got = refine_cuda(*k2, floor, 800.0)
    want = refine_plain(*k2, floor, 800.0)
    if dtype == torch.float64:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-12)
        return
    both = (got[0] > 0) & (want[0] > 0)
    assert int(both.sum()) > 100
    rel = ((got[0] - want[0]).abs() / want[0].clamp(min=1e-30))[both]
    assert float(rel.max()) <= 1e-4
    flips = int(((got[0] > 0) != (want[0] > 0)).sum())
    assert flips <= 1e-3 * int((k2[2] > 1e-6).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_cuda_at_the_dio_fft_size_2048_geometry(cuda, dtype):
    """DIO's floor of 23.4 Hz (fft_size 2048 at 16 kHz) gives 11 bands, 44
    event rows at 4 kHz on the 5 ms grid.  Bitwise equal."""
    from pathlib import Path

    from world_tpu_torch.dsp.fir import band_filtered
    from world_tpu_torch.dsp.iir import decimate_world
    from world_tpu_torch.f0.dio import dio_tables
    from world_tpu_torch.f0.events import batched_interval_interp, event_rows
    from world_tpu_torch.ops.edge_interp import event_engine_cuda

    g = np.load(Path(__file__).parent / "golden" / "harvest_small.npz")
    fs = int(g["fs"])
    x = torch.tensor(np.asarray(g["x"]), dtype=dtype, device=cuda)[None]
    tables = dio_tables(fs, 3.0 * fs / 2048, 800.0, 2, 4000, dtype, cuda)
    y = decimate_world(x, fs // 4000, h=tables["dio_decimator_ir"])
    rows = event_rows(band_filtered(y, tables["dio_bank"],
                                    tables["dio_offsets"])[0])
    assert rows.shape[0] == 44
    n_frames = int(1000 * x.shape[1] / fs / 5 + 1)
    tq = torch.as_tensor(np.arange(n_frames) * 5.0 / 1000, dtype=dtype,
                         device=cuda)
    got_f0, got_m = event_engine_cuda(rows, 4000.0, tq, 20.0)
    want_f0, want_m = batched_interval_interp(rows, 4000.0, tq, 20.0)
    assert torch.equal(got_m, want_m)
    assert torch.equal(torch.nan_to_num(got_f0), torch.nan_to_num(want_f0))


@pytest.mark.gpu
def test_kernels_refuse_a_geometry_they_cannot_hold(cuda):
    """Too large a DFT table or too many rows raises with the shapes; the
    plain version is not fallen back to."""
    from world_tpu_torch.ops.edge_interp import counter as k1_counter
    from world_tpu_torch.ops.edge_interp import event_engine_cuda
    from world_tpu_torch.ops.refine_dft import counter as k2_counter
    from world_tpu_torch.ops.refine_dft import refine_cuda

    mh = 4096
    seg = torch.zeros((4, 2 * mh + 1), dtype=torch.float64, device=cuda)
    before = (k1_counter.launches, k2_counter.launches)
    with pytest.raises(ValueError, match=r"\(2, 4, 8193, 32768\).*shared memory"):
        refine_cuda(seg, seg, torch.full((2, 4), 100.0, dtype=torch.float64,
                                         device=cuda), 8000.0, mh, 32768, 1.0, 800.0)
    x = torch.zeros((70000, 64), device=cuda)
    with pytest.raises(ValueError, match=r"rows 70000 x samples 64"):
        event_engine_cuda(x, 8000.0, torch.zeros(8, device=cuda), 8.0)
    assert (k1_counter.launches, k2_counter.launches) == before


# K2's slot layouts: each frame of the case takes the layout
K2_LAYOUTS = ("main_path", "all_48_at_71Hz", "only_last_slot", "all_empty",
              "all_at_800Hz", "distinct_long_windows")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", K2_LAYOUTS)
def test_k2_cuda_slot_layouts(cuda, layout, dtype):
    """K2 on harvest_small's real frames: the main path's own candidates,
    and frames whose 48 slots are all live at 71 Hz (the full 341-sample
    window), hold only the last slot, hold none, are all at 800 Hz, or hold
    48 distinct long windows (more than one pool).  Bars as above."""
    from world_tpu_torch.ops.refine_dft import refine_cuda, refine_plain

    seg, phase, f0, afs, mh, S = _harvest_small_refine_operands(cuda, dtype)
    assert f0.shape[0] == 48 and seg.shape[1] == 341
    C, F = f0.shape
    if layout != "main_path":
        rng = np.random.RandomState(5)
        fill = {"all_48_at_71Hz": lambda: np.full(C, 71.0),
                "only_last_slot": lambda: np.r_[np.full(C - 1, 1e-12), 180.0],
                "all_empty": lambda: np.full(C, 1e-12),
                "all_at_800Hz": lambda: np.full(C, 800.0),
                "distinct_long_windows": lambda: rng.permutation(
                    np.linspace(71.0, 90.0, C))}[layout]
        f0 = torch.tensor(np.stack([fill() for _ in range(F)], axis=1),
                          dtype=dtype, device=cuda)
    got = refine_cuda(seg, phase, f0, afs, mh, S, 71.0, 800.0)
    want = refine_plain(seg, phase, f0, afs, mh, S, 71.0, 800.0)
    if layout == "all_empty":
        assert not got[0].any() and not got[1].any()
    if dtype == torch.float64:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-12)
        return
    both = (got[0] > 0) & (want[0] > 0)
    if both.any():
        rel = ((got[0] - want[0]).abs() / want[0].clamp(min=1e-30))[both]
        assert float(rel.max()) <= 1e-4
    flips = int(((got[0] > 0) != (want[0] > 0)).sum())
    assert flips <= 1e-3 * max(int((f0 > 1e-6).sum()), 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_cuda_more_candidates_than_a_block(cuda, dtype):
    """300 candidate slots a frame: the kernel takes them in groups of one
    block's threads.  Bars as above."""
    from world_tpu_torch.ops.refine_dft import refine_cuda, refine_plain

    seg, phase, f0, afs, mh = _refine_operands(6, C=300, B=40, W=341,
                                               actual_fs=8000.0)
    f0[np.random.RandomState(7).rand(*f0.shape) < 0.3] = 1e-12
    args = [torch.tensor(a, dtype=dtype, device=cuda) for a in (seg, phase, f0)]
    got = refine_cuda(*args, afs, mh, 1024, 71.0, 800.0)
    want = refine_plain(*args, afs, mh, 1024, 71.0, 800.0)
    if dtype == torch.float64:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-12)
        return
    both = (got[0] > 0) & (want[0] > 0)
    rel = ((got[0] - want[0]).abs() / want[0].clamp(min=1e-30))[both]
    assert float(rel.max()) <= 1e-4
    assert int(((got[0] > 0) != (want[0] > 0)).sum()) <= 1e-3 * got[0].numel()


@pytest.mark.gpu
def test_no_fallback_when_the_kernels_cannot_be_built(cuda, tmp_path, monkeypatch):
    """With an empty build directory and no nvcc, the ragged batch on the
    card raises: it never gives way to the plain versions."""
    from world_tpu_torch import _backend, batch_encode_decode_ragged

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_backend, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_backend, "_nvcc", no_nvcc)
    _backend.kernel_library.cache_clear()
    try:
        x = np.random.RandomState(0).randn(8000).astype(np.float32)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            batch_encode_decode_ragged([x], 16000, devices=cuda)
    finally:
        _backend.kernel_library.cache_clear()


def _harvest22_operands(device, dtype):
    """K1's event rows (608 x 34,134, Q 4,644) and K2's operands
    (48, 4,644, 313, 1,024) on 22.05 kHz speech: the stages of
    ``harvest_decimated`` from tests/golden/harvest.npz's decimated signal."""
    from pathlib import Path

    from world_tpu_torch.dsp.scanops import compact_rows
    from world_tpu_torch.f0 import harvest as H
    from world_tpu_torch.f0.events import event_rows

    g = np.load(Path(__file__).parent / "golden" / "harvest.npz")
    fs = int(g["fs"])
    afs = H.decimation(fs)[1]
    tables = H.harvest_tables(fs, 71.0, 800.0, dtype, device)
    y = torch.tensor(np.asarray(g["y_decimated"]), dtype=dtype, device=device)[None]
    tq = torch.as_tensor(np.arange(4644) / 1000, dtype=dtype, device=device)
    filtered = H.band_filtered(y, tables["band_bank"], tables["band_bias"])
    k1 = (event_rows(filtered.reshape(-1, y.shape[1])), afs, tq, afs * 0.001)
    raw = H.raw_band_candidates(y, afs, tables["band_bank"], tables["band_bias"],
                                H.boundary_f0_list(71.0, 800.0), tq, 71.0, 800.0)
    cands = H.overlap_candidates(H.detect_candidates(raw, H.default_max_candidates())[0])
    compact, _ = compact_rows(cands.transpose(-1, -2), cands.transpose(-1, -2) != 0,
                              H.C2_SLOTS)
    max_half, S = H.refinement_geometry(afs, 71.0)
    seg, phase, f0 = H.refinement_inputs(y, afs, tq, compact.transpose(-1, -2),
                                         max_half)
    return k1, (seg, phase, f0, afs, max_half, S)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_cuda_on_22khz_speech(cuda, dtype):
    """K1 bitwise and K2 within its bars on harvest.npz's 22.05 kHz speech."""
    from world_tpu_torch.f0.events import batched_interval_interp
    from world_tpu_torch.ops.edge_interp import event_engine_cuda
    from world_tpu_torch.ops.refine_dft import refine_cuda, refine_plain

    k1, k2 = _harvest22_operands(cuda, dtype)
    assert tuple(k1[0].shape) == (608, 34134)
    assert (k2[2].shape[0], *k2[0].shape, k2[5]) == (48, 4644, 313, 1024)
    got_f0, got_m = event_engine_cuda(*k1)
    want_f0, want_m = batched_interval_interp(*k1)
    assert torch.equal(got_m, want_m)
    assert torch.equal(torch.nan_to_num(got_f0), torch.nan_to_num(want_f0))
    got = refine_cuda(*k2, 71.0, 800.0)
    want = refine_plain(*k2, 71.0, 800.0)
    if dtype == torch.float64:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-12)
        return
    both = (got[0] > 0) & (want[0] > 0)
    rel = ((got[0] - want[0]).abs() / want[0].clamp(min=1e-30))[both]
    assert float(rel.max()) <= 1e-4
    flips = int(((got[0] > 0) != (want[0] > 0)).sum())
    assert flips <= 1e-3 * int((k2[2] > 1e-6).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_cuda_matches_plain(cuda, dtype):
    """DIO's two scans on dio.npz's step-2 contour and mutated candidates,
    three rows (the contour, none voiced, sections of 1-3 frames): the
    kernel is bitwise its plain version, one launch a scan.  Then every
    layout of chip_smoke.k3_adversarial_operands, both scans (adjacent
    flags, flags at frames 0 and n - 1, every frame flagged, limits before
    their flag and past n, one group spanning every flag, C = 1 and 12,
    rows with no flag, rows of 1, 33 and 16,500 frames), against the plain
    version run on the CPU."""
    from pathlib import Path

    from world_tpu_torch.f0.dio import fix_step3, fix_step4
    from world_tpu_torch.ops import extension_scan as K3

    g = np.load(Path(__file__).parent / "golden" / "dio.npz")
    n = g["f0_step2"].shape[0]
    short = np.zeros(n)
    for s0, length in ((10, 1), (13, 2), (17, 3), (22, 1), (40, 5), (47, 1)):
        short[s0:s0 + length] = 190.0 + s0 / 100
    f0 = torch.tensor(np.stack([g["f0_step2"], np.zeros(n), short]), dtype=dtype,
                      device=cuda)
    cands = torch.tensor(np.stack([g["f0_candidates_mutated"]] * 3), dtype=dtype,
                         device=cuda)
    before = K3.counter.launches
    step3 = fix_step3(f0, cands, 0.1)
    step4 = fix_step4(step3, f0, cands, 0.1)
    assert K3.counter.launches == before + 2
    plain3 = fix_step3(f0.cpu(), cands.cpu(), 0.1)
    assert torch.equal(step3.cpu(), plain3)
    assert torch.equal(step4.cpu(), fix_step4(plain3, f0.cpu(), cands.cpu(), 0.1))
    if dtype == torch.float64:
        np.testing.assert_array_equal(step4[0].cpu().numpy(), g["f0_step4"])
    for name, scans in _chip_smoke().k3_adversarial_operands(dtype, cuda).items():
        for args in scans:
            before = K3.counter.launches
            got = K3.extension_scan_cuda(*args)
            assert K3.counter.launches == before + 1
            host = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
            assert torch.equal(got.cpu(), K3.extension_scan_plain(*host)), \
                (name, args[5])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_k5_cuda_match_plain(cuda, dtype):
    """Harvest's FixStep3 kernels on the adversarial section layouts
    (chip_smoke.fix_step3_layouts; the keeps' means in chunks of 1, 3 and
    all 16 rows, K5 also in ranges of 1 and 3 steps a launch) and on x16's
    Harvest: K4 and K5 bitwise their plain versions, each once a call."""
    from pathlib import Path

    from world_tpu_torch.ops import fix_step3 as K45

    cs = _chip_smoke()
    before = (K45.extend_counter.launches, K45.merge_counter.launches)
    ext, mer = cs.step3_layout_operands(dtype)
    assert (K45.extend_counter.launches - before[0],
            K45.merge_counter.launches - before[1]) == (3, 3)
    g = np.load(Path(__file__).parent / "golden" / "harvest_16k.npz")
    e16, m16 = cs.step3_operands(np.asarray(g["x16"]), int(g["fs"]), dtype)
    assert len(e16) == len(m16) == 1 and e16[0][1].shape == (1, 512)
    for args in ext + e16:
        cs.check_k4(args, f"{dtype} test")
    for args in mer:
        for chunk in (None, 1, 3):
            cs.check_k5(args, f"{dtype} test", chunk)
    cs.check_k5(m16[0], f"{dtype} test")
