"""K4 and K5, Harvest's FixStep3: wrappers of csrc/fix_step3.cu and their
plain PyTorch versions.

The JAX package runs FixStep3 (world_tpu/f0/harvest.py::fix_step3) as two
``jax.lax.scan``s: ExtendF0's chains (``_extend_chain``, :499-525, vmapped
over the sections at :575) and MergeF0's walk over the sorted section rows
(``merge_body``, :585-631); it has no Pallas kernel for them.  In PyTorch a
scan is a Python loop of small launches (101 chain steps of ~27, and
``max_sections`` merge steps of ~31), so on the card each scan is one kernel:

  * K4, :func:`extend_chains`: every chain of every utterance in one launch;
  * K5, :func:`merge_sections`: the whole merge of every utterance in one
    launch.  It reads no precomputed section rows and no scores: it
    rebuilds a row's value at a frame from f0 and the chains where it needs
    it, and takes SerachScore over each deciding overlap from the
    candidates and their scores (the JAX ``sscore``).  It takes and returns
    the carried state, so a range of steps may be merged a launch.

A CUDA tensor goes to the hand-written kernel; a CPU (or ``meta``) tensor to
the plain version, :func:`extend_chains_plain` or :func:`merge_plain`, the
scan's body one step at a time, vectorised over chains or utterances.  There
is no fallback from a kernel to its plain version.

MergeF0Sub's decision ``s1 > s2`` compares two sums of scores over the
overlap of a row and the merged contour.  Both versions take them in
float64: the kernel's block reduction cannot repeat PyTorch's summation
order, and float32 scores summed in float64 give the same decision in any
order but for ties closer than float64's rounding.  Exact ties stay ties
in any order: where the row and the contour agree, they carry the same
scores, so the kernel sums only the frames where they differ.  Float64
inputs are summed as before.
"""
import torch

from .._backend import (KernelGeometryError, LaunchCounter,
                        check_kernel_input, launch)
from ..utils.profiling import TRACER

extend_counter = LaunchCounter()
merge_counter = LaunchCounter()


def extend_chains_plain(f0, origin, last_point, shift, cands, allowed_range,
                        n_steps: int):
    """ExtendF0 from every section end at once: n_steps SelectBestF0 picks.
    f0 (B, n), origin and last_point (B, R), shift (R,) +1 or -1 (forward
    from a section's end, backward from its start), cands (B, C, n).
    Returns (positions, values, active) each (B, R, n_steps), and the
    shifted origins (B, R).

    A chain is in range while origin + shift (k + 1) has not passed
    last_point + shift, i.e. while k + 1 <= shift (last_point - origin) + 1,
    and runs until it leaves its range or misses 4 picks in a row.  Each
    pick is the candidate of least relative error |ref - cand| / ref, ref
    the last value taken floored at the type's tiny; the last of equal
    errors (``torch.argmin`` takes a NaN for the least, so the last NaN
    where there is one); kept where its error is at most allowed_range.
    The candidates are read at the position clamped to the row, also where
    the chain is no longer active."""
    n = f0.shape[-1]
    B, C = cands.shape[0], cands.shape[1]
    R = origin.shape[-1]
    tiny = torch.finfo(f0.dtype).tiny
    zero = torch.zeros((), dtype=f0.dtype, device=f0.device)
    reach = shift * (last_point - origin) + 1
    tmp = torch.gather(f0, -1, origin)
    misses = torch.zeros_like(origin)
    shifted = origin
    running = torch.ones_like(origin, dtype=torch.bool)
    pos = origin
    out_pos, out_val, out_act = [], [], []
    for k in range(n_steps):
        pos = pos + shift
        active = running & (reach >= k + 1)
        ref = torch.clamp(tmp, min=tiny)[:, None, :]
        cand = torch.gather(cands, -1,
                            pos.clamp(0, n - 1)[:, None, :].expand(B, C, R))
        err = torch.abs(ref - cand) / ref                     # (B, C, R)
        j = (C - 1 - torch.argmin(torch.flip(err, (1,)), dim=1))[:, None, :]
        ok = torch.gather(err, 1, j)[:, 0] <= allowed_range  # last argmin
        val = torch.where(ok & active, torch.gather(cand, 1, j)[:, 0], zero)
        hit = active & (val != 0)
        tmp = torch.where(hit, val, tmp)
        shifted = torch.where(hit, pos, shifted)
        misses = torch.where(hit, 0, misses + active)
        running = active & (misses < 4)
        out_pos.append(pos)
        out_val.append(val)
        out_act.append(active)
    return (torch.stack(out_pos, -1), torch.stack(out_val, -1),
            torch.stack(out_act, -1), shifted)


def section_rows(f0_step2, starts, ends, val, act, sel):
    """The extended contour rows (B, c, n) of the sections sel (B, c) int64
    of each utterance: f0_step2 inside the section [starts, ends], the
    values of its forward chain (chain s of val and act, (B, 2S, n_steps),
    step k at frame ends + k + 1) and of its backward chain (chain S + s,
    step k at frame starts - k - 1) where the step was active, else 0.  The
    chains lie on either side of the section, so no frame has two values.
    Each chain is one scatter into a row with a trash column at n, where
    the inactive steps write."""
    n = f0_step2.shape[-1]
    S, n_steps = starts.shape[1], val.shape[-1]
    dev, dtype = f0_step2.device, f0_step2.dtype
    i = torch.arange(n, device=dev)
    k = torch.arange(1, n_steps + 1, device=dev)
    st = torch.gather(starts, 1, sel)[..., None]
    ed = torch.gather(ends, 1, sel)[..., None]
    rows = torch.zeros(sel.shape + (n + 1,), dtype=dtype, device=dev)
    rows[..., :n] = torch.where((i >= st) & (i <= ed), f0_step2[:, None, :],
                                torch.zeros((), dtype=dtype, device=dev))
    steps = sel[..., None].expand(-1, -1, n_steps)
    for first, at in ((0, ed + k), (S, st - k)):
        active = torch.gather(act[:, first:first + S], 1, steps)
        rows.scatter_(-1, torch.where(active, at, n),
                      torch.gather(val[:, first:first + S], 1, steps))
    return rows[..., :n]


def serach_score(cands, scores, contour):
    """SerachScore of a contour (B, n): at each frame the greatest score of
    the candidates (B, C, n) equal to its value, 0 where none is (a NaN
    score propagates, as ``torch.amax`` does)."""
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    return torch.where(cands == contour[:, None, :], scores, zero).amax(dim=-2)


def merge_plain(f0_step2, cands, scores, starts, ends, val, act, order, st_o,
                ed_o, keep_o, f0_m, cur_st, cur_ed, started):
    """MergeF0 (harvest.py:442-486) over a range of c steps of the merge.

    The utterances' data: f0_step2 (B, n), the candidates and their scores
    (B, C, n), the sections' starts and ends (B, S) int64, and the chains'
    values and flags val, act (B, 2S, n_steps) as :func:`extend_chains`
    lays them out (forward from section s's end at s, backward from its
    start at S + s).  The steps: the section each merges, order (B, c)
    int64, its extended start and end st_o, ed_o (B, c) int64, and keep_o
    (B, c) bool.  The carried state is the merged contour f0_m (B, n), the
    current section's start cur_st and end cur_ed (B,) int64 and started
    (B,) bool; returns it updated, as new tensors.

    A step whose row is not kept changes nothing.  The first kept row
    starts the contour; a later one starts a new section when it is
    disjoint (st2 > cur_ed), else it overlaps the last one (MergeF0Sub),
    which keeps the contour where the row lies inside it, and else takes
    the row from where the SerachScore sum over the overlap [st2, cur_ed]
    is the greater: the row's from its start, the contour's from the
    contour's end.  The row is rebuilt from the chains
    (:func:`section_rows`) and both scores are taken over the overlap at
    each step, as the JAX ``sscore`` does.  The kept steps must come first
    in each range (fix_step3's order puts them there): the kernel stops at
    the first step that is not kept."""
    n = f0_m.shape[-1]
    dev = f0_m.device
    i = torch.arange(n, device=dev)
    zero = torch.zeros((), dtype=f0_m.dtype, device=dev)
    for k in range(order.shape[1]):
        row = section_rows(f0_step2, starts, ends, val, act,
                           order[:, k:k + 1])[:, 0]
        st2, ed2, keep = st_o[:, k], ed_o[:, k], keep_o[:, k]
        disjoint = st2 > cur_ed
        contained = (cur_st <= st2) & (cur_ed >= ed2)
        ov = (i >= st2[:, None]) & (i <= cur_ed[:, None])
        s1 = torch.where(ov, serach_score(cands, scores, f0_m), zero).sum(
            dim=-1, dtype=torch.float64)
        s2 = torch.where(ov, serach_score(cands, scores, row), zero).sum(
            dim=-1, dtype=torch.float64)
        fresh = keep & (~started | disjoint)
        extends = fresh | (keep & ~contained)
        take_lo = torch.where(fresh, st2, torch.where(s1 > s2, cur_ed, st2))
        take_hi = torch.where(extends, ed2, -1)
        take = (i >= take_lo[:, None]) & (i <= take_hi[:, None])
        f0_m = torch.where(take, row, f0_m)
        cur_st = torch.where(fresh, st2, cur_st)
        cur_ed = torch.where(extends, ed2, cur_ed)
        started = started | keep
    return f0_m, cur_st, cur_ed, started


def _check_float(t, what):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: unsupported dtype {t.dtype}")


@TRACER.spanned("world.kernel.K4")
def extend_chains_cuda(f0, origin, last_point, shift, cands, allowed_range,
                       n_steps: int):
    """Launch K4: :func:`extend_chains_plain`'s outputs, one launch."""
    dev = f0.device
    _check_float(f0, "extend_chains")
    check_kernel_input(f0, "f0", f0.dtype, dev, 2)
    check_kernel_input(origin, "origin", torch.int64, dev, 2)
    check_kernel_input(last_point, "last_point", torch.int64, dev, 2)
    check_kernel_input(shift, "shift", torch.int64, dev, 1)
    check_kernel_input(cands, "cands", f0.dtype, dev, 3)
    B, n = f0.shape
    R, C = origin.shape[1], cands.shape[1]
    if (origin.shape != (B, R) or last_point.shape != (B, R)
            or shift.shape != (R,) or cands.shape != (B, C, n)
            or min(B, R, C, n, n_steps) < 1):
        raise ValueError(f"extend_chains: shapes f0 {tuple(f0.shape)}, origin "
                         f"{tuple(origin.shape)}, last_point "
                         f"{tuple(last_point.shape)}, shift {tuple(shift.shape)}"
                         f", cands {tuple(cands.shape)}, {n_steps} steps")
    pos = torch.empty((B, R, n_steps), dtype=torch.int64, device=dev)
    val = torch.empty((B, R, n_steps), dtype=f0.dtype, device=dev)
    act = torch.empty((B, R, n_steps), dtype=torch.bool, device=dev)
    shifted = torch.empty((B, R), dtype=torch.int64, device=dev)
    try:
        launch("extend_chains", f0.dtype, f0.data_ptr(), origin.data_ptr(),
               last_point.data_ptr(), shift.data_ptr(), cands.data_ptr(), B, R,
               C, n, int(n_steps), float(allowed_range), pos.data_ptr(),
               val.data_ptr(), act.data_ptr(), shifted.data_ptr())
    except KernelGeometryError as e:
        raise ValueError(f"extend_chains: {C} candidates of {n_steps} steps do "
                         f"not fit one chain's shared memory ({e})") from e
    extend_counter.add()
    return pos, val, act, shifted


@TRACER.spanned("world.kernel.K5")
def merge_sections_cuda(f0_step2, cands, scores, starts, ends, val, act,
                        order, st_o, ed_o, keep_o, f0_m, cur_st, cur_ed,
                        started):
    """Launch K5 on a range of merge steps: :func:`merge_plain`'s function,
    the state tensors updated in place and returned."""
    dev = f0_step2.device
    dtype = f0_step2.dtype
    _check_float(f0_step2, "merge_sections")
    for t, name in ((f0_step2, "f0_step2"), (f0_m, "f0_m")):
        check_kernel_input(t, name, dtype, dev, 2)
    for t, name in ((cands, "cands"), (scores, "scores"), (val, "val")):
        check_kernel_input(t, name, dtype, dev, 3)
    check_kernel_input(act, "act", torch.bool, dev, 3)
    for t, name in ((starts, "starts"), (ends, "ends"), (order, "order"),
                    (st_o, "st_o"), (ed_o, "ed_o")):
        check_kernel_input(t, name, torch.int64, dev, 2)
    check_kernel_input(keep_o, "keep_o", torch.bool, dev, 2)
    for t, name in ((cur_st, "cur_st"), (cur_ed, "cur_ed")):
        check_kernel_input(t, name, torch.int64, dev, 1)
    check_kernel_input(started, "started", torch.bool, dev, 1)
    B, n = f0_step2.shape
    C, S, c, n_steps = cands.shape[1], starts.shape[1], order.shape[1], val.shape[2]
    if (cands.shape != (B, C, n) or scores.shape != (B, C, n)
            or ends.shape != (B, S) or val.shape != (B, 2 * S, n_steps)
            or act.shape != val.shape or any(t.shape != (B, c) for t in (
                st_o, ed_o, keep_o)) or f0_m.shape != (B, n)
            or any(t.shape != (B,) for t in (cur_st, cur_ed, started))
            or min(B, C, n, S, c, n_steps) < 1):
        raise ValueError(f"merge_sections: shapes f0_step2 {tuple(f0_step2.shape)}"
                         f", cands {tuple(cands.shape)}, starts "
                         f"{tuple(starts.shape)}, val {tuple(val.shape)}, order "
                         f"{tuple(order.shape)}, f0_m {tuple(f0_m.shape)}, "
                         f"started {tuple(started.shape)}")
    launch("merge_sections", dtype, f0_step2.data_ptr(), cands.data_ptr(),
           scores.data_ptr(), starts.data_ptr(), ends.data_ptr(), val.data_ptr(),
           act.data_ptr(), order.data_ptr(), st_o.data_ptr(), ed_o.data_ptr(),
           keep_o.data_ptr(), B, C, n, S, n_steps, c, f0_m.data_ptr(),
           cur_st.data_ptr(), cur_ed.data_ptr(), started.data_ptr())
    merge_counter.add()
    return f0_m, cur_st, cur_ed, started


def extend_chains(f0, origin, last_point, shift, cands, allowed_range,
                  n_steps: int):
    """FixStep3's chains: :func:`extend_chains_plain`'s function, by K4 on
    the card."""
    if f0.is_cuda:
        return extend_chains_cuda(f0, origin, last_point, shift, cands,
                                  allowed_range, n_steps)
    return extend_chains_plain(f0, origin, last_point, shift, cands,
                               allowed_range, n_steps)


def merge_sections(*args):
    """MergeF0 over a range of merge steps: :func:`merge_plain`'s function
    and arguments, by K5 on the card (which updates the state in place)."""
    if args[0].is_cuda:
        return merge_sections_cuda(*args)
    return merge_plain(*args)
