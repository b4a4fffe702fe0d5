"""Harvest's FixStep3 through the plain versions of K4 and K5
(world_tpu_torch/ops/fix_step3.py), in float64 and float32 on the CPU:

  * the chains (``extend_chains_plain``) against ``jax.vmap`` of
    world_tpu.f0.harvest._extend_chain, forward and backward: positions,
    values, write masks and shifted origins, bitwise;
  * ``fix_step3`` over a batch of adversarial section layouts
    (chip_smoke.fix_step3_layouts: no voiced frame, none kept, one section,
    disjoint, overlaps with s1 > s2, s1 < s2 and s1 == s2, a row contained
    in the last, sections at frames 1 and n - 2, more sections than rows),
    in section chunks of 1, 3 and all, against the JAX ``fix_step3`` of each
    row, bitwise; each layout takes the branch it is named for;
  * the merge (``merge_plain``, which rebuilds each row from the chains and
    scores the overlaps itself) against the formulation it replaced, kept
    here as the yardstick: every section row in merge order scattered from
    the chains, SerachScore of every row taken before the merge and the
    contour's carried beside it; bitwise on the layouts and on the Harvest
    operands of harvest_small's 1 s and of x16 (4.644 s; float64, and cast
    to float32), in both types;
  * the merge in ranges of steps: the state it carries between ranges
    gives the one-range merge's bits;
  * the dispatchers send CPU and ``meta`` tensors to the plain versions and
    count no launch.
The kernels themselves are held to these plain versions on the card
(tests/test_torch_kernels.py, ``gpu``; chip_smoke.py phase 20).
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from smoke_loader import chip_smoke as _chip_smoke

ROOT = Path(__file__).resolve().parent.parent
TYPES = [torch.float64, torch.float32]


CS = _chip_smoke()
LAYOUTS = CS.fix_step3_layouts()


def _batch(dtype):
    return tuple(torch.tensor(np.stack([v[k] for v in LAYOUTS.values()]),
                              dtype=dtype) for k in range(3))


def _np_type(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


@pytest.mark.parametrize("dtype", TYPES)
def test_extend_chains_plain_matches_jax_vmap(dtype):
    """Every section's forward and backward chain of every layout, and of
    a contour of twelve sections on random candidates, one vmapped JAX
    scan per direction against one plain call for all of them."""
    import jax
    import jax.numpy as jnp

    from world_tpu.f0.harvest import _extend_chain
    from world_tpu_torch.f0.harvest import sections
    from world_tpu_torch.ops.fix_step3 import extend_chains_plain

    rng = np.random.RandomState(3)
    n, C, S = CS.STEP3_N, CS.STEP3_C, CS.STEP3_SECTIONS
    f0s = [v[0] for v in LAYOUTS.values()]
    cds = [v[1] for v in LAYOUTS.values()]
    f0 = np.zeros(n)
    for k in range(12):
        f0[30 + 45 * k:50 + 45 * k] = 150 + 40 * rng.rand()
    f0s.append(f0)
    cands = 140 + 80 * rng.rand(C, n)
    cands[rng.rand(C, n) < 0.3] = 0.0
    cds.append(cands)
    t = np.dtype(_np_type(dtype))
    f0b = torch.tensor(np.stack(f0s), dtype=dtype)
    cdb = torch.tensor(np.stack(cds), dtype=dtype)
    starts, ends, _ = sections(f0b, S)
    shift = torch.cat([torch.ones(S, dtype=torch.int64),
                       torch.full((S,), -1, dtype=torch.int64)])
    origin = torch.cat([ends, starts], -1)
    last = torch.cat([torch.clamp(ends + 100, max=n - 2),
                      torch.clamp(starts - 100, min=1)], -1)
    pos, val, act, shifted = extend_chains_plain(f0b, origin, last, shift, cdb,
                                                 0.18, 101)
    for b in range(f0b.shape[0]):
        for half, sh in ((slice(0, S), 1), (slice(S, 2 * S), -1)):
            chain = jax.vmap(
                lambda f, o, lp, c, sh=sh: _extend_chain(f, o, lp, sh, c, 0.18, 101),
                in_axes=(None, 0, 0, None))
            w_pos, w_val, w_mask, w_sh = (np.asarray(a) for a in chain(
                jnp.asarray(f0b[b].numpy().astype(t)),
                jnp.asarray(origin[b, half].numpy().astype(np.int32)),
                jnp.asarray(last[b, half].numpy().astype(np.int32)),
                jnp.asarray(cdb[b].numpy().astype(t))))
            np.testing.assert_array_equal(pos[b, half].numpy(), w_pos)
            np.testing.assert_array_equal(val[b, half].numpy(), w_val)
            np.testing.assert_array_equal(act[b, half].numpy(), w_mask)
            np.testing.assert_array_equal(shifted[b, half].numpy(), w_sh)
    assert int(act.sum()) > 1000 and bool((val != 0).any())


@pytest.mark.parametrize("chunk", [1, 3, None])
@pytest.mark.parametrize("dtype", TYPES)
def test_fix_step3_layouts_match_jax(dtype, chunk):
    import jax.numpy as jnp

    from world_tpu.f0.harvest import fix_step3 as jax_fix_step3
    from world_tpu_torch.f0.harvest import fix_step3

    S = CS.STEP3_SECTIONS
    f0, cands, scores = _batch(dtype)
    got = fix_step3(f0, cands, scores, 0.18, S, section_chunk=chunk)
    whole = fix_step3(f0, cands, scores, 0.18, S, section_chunk=S)
    assert torch.equal(got, whole)
    t = _np_type(dtype)
    for b, name in enumerate(LAYOUTS):
        want = np.asarray(jax_fix_step3(
            *(jnp.asarray(a[b].numpy().astype(t)) for a in (f0, cands, scores)),
            0.18, max_sections=S))
        np.testing.assert_array_equal(got[b].numpy(), want, err_msg=name)


def _merge_traces(dtype):
    """merge_trace of each layout's one K5 chunk, by layout name."""
    from world_tpu_torch.f0.harvest import fix_step3
    from world_tpu_torch.ops import fix_step3 as K45

    f0, cands, scores = _batch(dtype)
    ext, mer = CS.capture_step3(lambda: fix_step3(f0, cands, scores, 0.18,
                                                  CS.STEP3_SECTIONS))
    assert len(ext) == 1 and len(mer) == 1
    trace = CS.merge_trace(mer[0])
    assert K45.extend_counter.launches == K45.merge_counter.launches == 0
    return {name: [t[2] for t in trace if t[0] == b]
            for b, name in enumerate(LAYOUTS)}


@pytest.mark.parametrize("dtype", TYPES)
def test_layouts_take_their_branches(dtype):
    kinds = _merge_traces(dtype)
    assert kinds["no_voiced_frame"] == kinds["none_kept"] == []
    assert kinds["one_section"] == ["start"]
    assert kinds["disjoint"] == ["start", "disjoint"]
    assert kinds["overlap_s1_above_s2"] == ["start", "s1>s2"]
    assert kinds["overlap_s1_below_s2"] == ["start", "s1<s2"]
    assert kinds["overlap_s1_equal_s2"] == ["start", "s1=s2"]
    assert kinds["contained"] == ["start", "contained"]
    assert kinds["edges"] == ["start", "disjoint"]
    assert kinds["more_sections_than_rows"][0] == "start"
    assert len(kinds["more_sections_than_rows"]) == CS.STEP3_SECTIONS


def test_layouts_keep_their_edges_and_caps():
    from world_tpu_torch.f0.harvest import fix_step3, sections

    S, n = CS.STEP3_SECTIONS, CS.STEP3_N
    f0, cands, scores = _batch(torch.float64)
    b = list(LAYOUTS).index("edges")
    starts, ends, valid = sections(f0, S)
    assert (int(starts[b, 0]), int(ends[b, 1])) == (1, n - 2)
    out = fix_step3(f0, cands, scores, 0.18, S)
    assert out[b, 0] != 0 and out[b, n - 1] != 0     # the chains reached them
    many = list(LAYOUTS).index("more_sections_than_rows")
    assert int(valid[many].sum()) == S
    assert torch.equal(out[list(LAYOUTS).index("none_kept")],
                       f0[list(LAYOUTS).index("none_kept")])


@pytest.mark.parametrize("dtype", TYPES)
def test_merge_state_carries_between_chunks(dtype):
    """merge_plain over the steps in ranges of 1, 3 and 7, each range taking
    the state the last one left, gives the one-range merge's bits."""
    from world_tpu_torch.f0.harvest import fix_step3
    from world_tpu_torch.ops.fix_step3 import merge_plain

    f0, cands, scores = _batch(dtype)
    _, mer = CS.capture_step3(lambda: fix_step3(f0, cands, scores, 0.18,
                                                CS.STEP3_SECTIONS))
    args = mer[0]
    whole = merge_plain(*args)
    S = args[7].shape[1]
    assert S == CS.STEP3_SECTIONS
    for chunk in (1, 3, 7):
        state = args[11:]
        for lo in range(0, S, chunk):
            part = slice(lo, lo + chunk)
            state = merge_plain(*args[:7],
                                *(a[:, part].contiguous() for a in args[7:11]),
                                *state)
        for got, want in zip(state, whole):
            assert torch.equal(got, want), chunk


def _merge_by_row_scores(f0_step2, cands, scores, starts, ends, val, act,
                         order, st_o, ed_o, keep_o, f0_m, cur_st, cur_ed,
                         started):
    """The merge as it was formulated before it scored its own overlaps,
    kept as the yardstick: the section rows in merge order, each chain one
    scatter at its positions (a trash column at n for the inactive steps);
    SerachScore of every row taken before the merge (one row at a time);
    the merged contour's scores ss_m carried beside it and copied with its
    values."""
    n = f0_step2.shape[1]
    S, n_steps = starts.shape[1], val.shape[2]
    i = torch.arange(n)
    zero = torch.zeros((), dtype=f0_step2.dtype)
    pick = lambda t: torch.gather(t, 1, order)                   # noqa: E731
    rows = torch.zeros(order.shape + (n + 1,), dtype=f0_step2.dtype)
    rows[..., :n] = torch.where(
        (i >= pick(starts)[..., None]) & (i <= pick(ends)[..., None]),
        f0_step2[:, None, :], zero)
    steps = order[..., None].expand(-1, -1, n_steps)
    k = torch.arange(n_steps)
    for first, origin, sign in ((0, ends, 1), (S, starts, -1)):
        half = slice(first, first + S)
        pos = pick(origin)[..., None] + sign * (k + 1)
        at = torch.where(torch.gather(act[:, half], 1, steps), pos, n)
        rows.scatter_(-1, at, torch.gather(val[:, half], 1, steps))
    rows = rows[..., :n]

    def row_scores(r):
        eq = cands[:, None] == r[:, :, None, :]
        return torch.where(eq, scores[:, None], zero).amax(dim=-2)

    ss_o = torch.cat([row_scores(rows[:, s:s + 1])
                      for s in range(rows.shape[1])], dim=1)
    ss_m = row_scores(f0_m[:, None])[:, 0]
    for s in range(rows.shape[1]):
        row, ss_row = rows[:, s], ss_o[:, s]
        st2, ed2, keep = st_o[:, s], ed_o[:, s], keep_o[:, s]
        disjoint = st2 > cur_ed
        contained = (cur_st <= st2) & (cur_ed >= ed2)
        ov = (i >= st2[:, None]) & (i <= cur_ed[:, None])
        s1 = torch.where(ov, ss_m, zero).sum(dim=-1, dtype=torch.float64)
        s2 = torch.where(ov, ss_row, zero).sum(dim=-1, dtype=torch.float64)
        fresh = keep & (~started | disjoint)
        extends = fresh | (keep & ~contained)
        take_lo = torch.where(fresh, st2, torch.where(s1 > s2, cur_ed, st2))
        take_hi = torch.where(extends, ed2, -1)
        take = (i >= take_lo[:, None]) & (i <= take_hi[:, None])
        f0_m = torch.where(take, row, f0_m)
        ss_m = torch.where(take, ss_row, ss_m)
        cur_st = torch.where(fresh, st2, cur_st)
        cur_ed = torch.where(extends, ed2, cur_ed)
        started = started | keep
    return f0_m, cur_st, cur_ed, started


@pytest.fixture(scope="module")
def harvest_merges():
    """K5's operands from the port's float64 Harvest on the CPU, by
    (signal, type): harvest_small's 1 s and x16's 4.644 s at 16 kHz; the
    float32 ones are the float64 operands cast (the chains' values stay
    copies of the candidates)."""
    from world_tpu_torch.f0 import harvest as H

    signals = {"x_small": np.load(ROOT / "tests/golden/harvest_small.npz")["x"],
               "x16": np.load(ROOT / "tests/golden/harvest_16k.npz")["x16"]}
    out = {}
    for name, x in signals.items():
        xt = torch.tensor(np.asarray(x), dtype=torch.float64)[None]
        _, mer = CS.capture_step3(lambda: H.harvest_core(
            xt, 16000, CS.F0_FLOOR, CS.F0_CEIL, 5.0,
            H.default_max_candidates(),
            H.default_max_sections(xt.shape[1], 16000)))
        for dtype in TYPES:
            out[name, dtype] = [tuple(
                a.to(dtype) if a.dtype.is_floating_point else a for a in args)
                for args in mer]
    return out


@pytest.mark.parametrize("geometry", ["layouts", "x_small", "x16"])
@pytest.mark.parametrize("dtype", TYPES)
def test_merge_plain_matches_row_scores_formulation(dtype, geometry,
                                                    harvest_merges):
    """merge_plain, whose rows come from the chains and whose SerachScore is
    taken over each deciding overlap, against the formulation with every
    row's scores taken first and the contour's carried: the same state,
    bitwise, on operands that take MergeF0Sub's comparison."""
    from world_tpu_torch.f0.harvest import fix_step3
    from world_tpu_torch.ops.fix_step3 import merge_plain

    if geometry == "layouts":
        f0, cands, scores = _batch(dtype)
        _, mer = CS.capture_step3(lambda: fix_step3(f0, cands, scores, 0.18,
                                                    CS.STEP3_SECTIONS))
    else:
        mer = harvest_merges[geometry, dtype]
    assert len(mer) == 1
    got = merge_plain(*mer[0])
    want = _merge_by_row_scores(*mer[0])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    kinds = {t[2] for t in CS.merge_trace(mer[0])}
    assert kinds & {"s1>s2", "s1<s2", "s1=s2"} and "start" in kinds


def test_dispatchers_take_the_plain_versions_off_the_card():
    from world_tpu_torch.f0.harvest import fix_step3
    from world_tpu_torch.ops import fix_step3 as K45

    f0, cands, scores = _batch(torch.float64)
    before = (K45.extend_counter.launches, K45.merge_counter.launches)
    ext, mer = CS.capture_step3(lambda: fix_step3(f0, cands, scores, 0.18, 16, 5))
    assert len(ext) == len(mer) == 1    # the keeps' means in chunks of 5 rows
    assert torch.equal(K45.extend_chains(*ext[0])[1],
                       K45.extend_chains_plain(*ext[0])[1])
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in mer[0]]
    out = K45.merge_sections(*meta)
    assert [t.shape for t in out] == [t.shape for t in mer[0][11:]]
    assert all(t.device.type == "meta" for t in out)
    assert (K45.extend_counter.launches, K45.merge_counter.launches) == before
