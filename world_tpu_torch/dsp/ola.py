"""Overlap-add (world_tpu/dsp/ola.py).

Both forms sum in a fixed order, so a call gives the same bits every time
it runs, on the card too.  The uniform frame grid keeps the shift-and-fold
form.  The irregularly spaced pulses go into 32-sample slots first, as the
JAX package's ``slotted_ola`` does, but by rank inside the slot in place of
its one-hot matrix product: no atomic adds, whose order changes from run
to run.
"""
import torch
import torch.nn.functional as F

# the pulses' slot width: a slot holds at most this many pulses, since a
# phase wrap fires at most once a sample
SLOT = 32


def uniform_ola(resp: torch.Tensor, start0: int, hop: int,
                y_length: int) -> torch.Tensor:
    """Overlap-add of resp (F, W) at starts start0 + f*hop; parts outside
    [0, y_length) are dropped.  Chunk c of frame f lands in output block
    f + c, added in chunk order."""
    Fr, W = resp.shape
    n_chunks = -(-W // hop)
    r = F.pad(resp, (0, n_chunks * hop - W))
    blocks = torch.zeros((Fr + n_chunks, hop), dtype=resp.dtype,
                         device=resp.device)
    for c in range(n_chunks):
        blocks[c:c + Fr] += r[:, c * hop:(c + 1) * hop]
    flat = blocks.reshape(-1)
    out = torch.zeros(y_length, dtype=resp.dtype, device=resp.device)
    lo = max(0, start0)
    src_lo = lo - start0
    n = min(y_length - lo, flat.shape[0] - src_lo)
    if n > 0:
        out[lo:lo + n] = flat[src_lo:src_lo + n]
    return out


def scatter_ola(resp: torch.Tensor, starts: torch.Tensor,
                y_length: int) -> torch.Tensor:
    """y[starts[p] + j] += resp[p, j] for every in-range sample, for
    nondecreasing integer ``starts`` with at most SLOT rows starting in one
    slot (the syntheses' pulse starts, strictly increasing, give that);
    rows that lie wholly outside [0, y_length) contribute nothing.

    What ``world_tpu.dsp.ola.slotted_ola`` computes: each row is shifted to
    its offset inside its SLOT-sample slot, the rows of a slot are summed in
    their order, and the slot grid folds with :func:`uniform_ola`.  A row's
    rank inside its slot picks the pass that adds it: the rows of one rank
    sit in distinct slots, so each pass is a scatter without collisions.
    Costs one host sync, for the count of rows of each rank."""
    P, W = resp.shape
    dev = resp.device
    width = W + SLOT
    base = SLOT * (-(-W // SLOT) + 1)           # slot 0 starts at -base <= -W
    n_slots = (y_length + base) // SLOT + 2
    s = starts.to(torch.int64) + base
    sid = torch.div(s, SLOT, rounding_mode="floor")
    off = s - sid * SLOT
    # a row past either end of the slot grid lies wholly outside the output
    live = (sid >= 0) & (sid < n_slots)
    p = torch.arange(P, device=dev)
    first = torch.ones(P, dtype=torch.bool, device=dev)
    first[1:] = sid[1:] != sid[:-1]
    rank = p - torch.cummax(torch.where(first, p, torch.zeros_like(p)), 0).values
    # live rows by rank (rank SLOT: more than SLOT rows in a slot), then
    # the rows outside (SLOT + 1), each group in row order
    key = torch.where(live, torch.clamp(rank, max=SLOT),
                      torch.full_like(rank, SLOT + 1))
    order = torch.argsort(key, stable=True)
    # counted by a scatter: bincount on the card syncs once more for its size
    counts = torch.zeros(SLOT + 2, dtype=torch.int64, device=dev).scatter_add_(
        0, key, torch.ones_like(key)).tolist()
    if counts[SLOT]:
        raise ValueError(f"scatter_ola: more than {SLOT} rows start in one "
                         f"{SLOT}-sample slot")
    grid = torch.zeros(n_slots * width, dtype=resp.dtype, device=dev)
    cols = torch.arange(W, device=dev)
    lo = 0
    for n in counts[:SLOT]:
        if n == 0:
            break
        rows = order[lo:lo + n]
        idx = (sid[rows] * width + off[rows])[:, None] + cols
        grid.index_put_((idx,), grid[idx] + resp[rows])
        lo += n
    return uniform_ola(grid.view(n_slots, width), -base, SLOT, y_length)
