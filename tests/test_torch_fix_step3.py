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
  * the merge chunk by chunk: the state it carries between chunks gives
    the one-chunk merge's bits;
  * the dispatchers send CPU and ``meta`` tensors to the plain versions and
    count no launch.
The kernels themselves are held to these plain versions on the card
(tests/test_torch_kernels.py, ``gpu``; chip_smoke.py phase 20).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
TYPES = [torch.float64, torch.float32]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    """merge_plain over the rows in chunks of 1, 3 and 7, each chunk taking
    the state the last one left, gives the one-chunk merge's bits."""
    from world_tpu_torch.f0.harvest import fix_step3
    from world_tpu_torch.ops.fix_step3 import merge_plain

    f0, cands, scores = _batch(dtype)
    _, mer = CS.capture_step3(lambda: fix_step3(f0, cands, scores, 0.18,
                                                CS.STEP3_SECTIONS))
    args = mer[0]
    whole = merge_plain(*args)
    S = args[0].shape[1]
    for chunk in (1, 3, 7):
        state = args[5:]
        for lo in range(0, S, chunk):
            part = slice(lo, lo + chunk)
            state = merge_plain(*(a[:, part].contiguous() for a in args[:5]),
                                *state)
        for got, want in zip(state, whole):
            assert torch.equal(got, want), chunk


def test_dispatchers_take_the_plain_versions_off_the_card():
    from world_tpu_torch.f0.harvest import fix_step3
    from world_tpu_torch.ops import fix_step3 as K45

    f0, cands, scores = _batch(torch.float64)
    before = (K45.extend_counter.launches, K45.merge_counter.launches)
    ext, mer = CS.capture_step3(lambda: fix_step3(f0, cands, scores, 0.18, 16, 5))
    assert len(ext) == 1 and len(mer) == 4           # chunks of 5 of 16 rows
    assert torch.equal(K45.extend_chains(*ext[0])[1],
                       K45.extend_chains_plain(*ext[0])[1])
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in mer[0]]
    out = K45.merge_sections(*meta)
    assert [t.shape for t in out] == [t.shape for t in mer[0][5:]]
    assert all(t.device.type == "meta" for t in out)
    assert (K45.extend_counter.launches, K45.merge_counter.launches) == before
