"""Overlap-add (world_tpu/dsp/ola.py).

Both forms sum in a fixed order, so a call gives the same bits every time
it runs, on the card too.  The uniform frame grid keeps the shift-and-fold
form.  The irregularly spaced pulses go into 32-sample slots first, as the
JAX package's ``slotted_ola`` does, but by rank inside the slot in place of
its one-hot matrix product: no atomic adds, whose order changes from run
to run.  Every function takes leading batch axes.
"""
import math

import torch
import torch.nn.functional as F

# the pulses' slot width: a slot holds at most this many pulses, since a
# phase wrap fires at most once a sample
SLOT = 32


def uniform_ola(resp: torch.Tensor, start0: int, hop: int,
                y_length: int) -> torch.Tensor:
    """Overlap-add of resp (..., F, W) at starts start0 + f*hop; parts
    outside [0, y_length) are dropped.  Chunk c of frame f lands in output
    block f + c, added in chunk order."""
    *lead, Fr, W = resp.shape
    n_chunks = -(-W // hop)
    r = F.pad(resp, (0, n_chunks * hop - W))
    blocks = torch.zeros((*lead, Fr + n_chunks, hop), dtype=resp.dtype,
                         device=resp.device)
    for c in range(n_chunks):
        blocks[..., c:c + Fr, :] += r[..., c * hop:(c + 1) * hop]
    flat = blocks.reshape(*lead, -1)
    out = torch.zeros((*lead, y_length), dtype=resp.dtype, device=resp.device)
    lo = max(0, start0)
    src_lo = lo - start0
    n = min(y_length - lo, flat.shape[-1] - src_lo)
    if n > 0:
        out[..., lo:lo + n] = flat[..., src_lo:src_lo + n]
    return out


def rank_bound(f_max: float, fs: float) -> int:
    """The most pulse starts a SLOT-sample slot can hold when no pulse
    train is faster than ``f_max`` Hz at ``fs``.

    A pulse fires at sample t where the running phase passes a multiple of
    2 pi between t and t + 1, and the phase gains at most 2 pi f_max / fs a
    sample.  Two pulses at t1 < t2 have a whole turn between t1 and t2 + 1,
    so t2 + 1 - t1 >= fs / f_max: starts lie at least d = fs / f_max - 1
    samples apart, and k of them in one slot span (k - 1) d <= SLOT - 1.
    Hence k <= 1 + (SLOT - 1) / d.  With x = f_max / fs <= 0.177 (so that
    32 x^2 <= 1), (SLOT - 1) x / (1 - x) < SLOT x + 1, and k is at most
    ceil(SLOT x) + 1; the larger of the two counts is returned, never more
    than SLOT (a phase wrap fires at most once a sample)."""
    if 2 * f_max >= fs:
        return SLOT
    x = f_max / fs
    by_spacing = 1 + math.floor((SLOT - 1) / (1 / x - 1))
    return min(SLOT, max(math.ceil(SLOT * x) + 1, by_spacing))


class SlotGrid:
    """The slot grid of :func:`slot_ola` for rows starting at ``starts``
    (R, P), filled a block of rows at a time (:meth:`add`), then folded
    (:meth:`result`).  Each grid row takes its rows in rank order, block
    after block, so any blocking gives :func:`slot_ola`'s bits: a caller
    whose responses are too large to hold at once computes them in blocks."""

    def __init__(self, starts: torch.Tensor, y_length: int, W: int,
                 dtype: torch.dtype):
        R, P = starts.shape
        dev = starts.device
        self.y_length, self.W, self.R = y_length, W, R
        self.width = W + SLOT
        self.base = SLOT * (-(-W // SLOT) + 1)       # slot 0 starts at -base <= -W
        self.n_slots = (y_length + self.base) // SLOT + 2
        s = starts.to(torch.int64) + self.base
        sid = torch.div(s, SLOT, rounding_mode="floor")
        self.off = s - sid * SLOT
        # a row past either end of the slot grid lies wholly outside the output
        self.live = (sid >= 0) & (sid < self.n_slots)
        p = torch.arange(P, device=dev)
        first = torch.ones((R, P), dtype=torch.bool, device=dev)
        first[:, 1:] = sid[:, 1:] != sid[:, :-1]
        self.rank = p - torch.cummax(torch.where(first, p, torch.zeros_like(p)),
                                     -1).values
        # grid row r * (n_slots + 1) + slot; row n_slots of each is the trash
        self.grid = torch.zeros((R * (self.n_slots + 1), self.width), dtype=dtype,
                                device=dev)
        row0 = torch.arange(R, device=dev)[:, None] * (self.n_slots + 1)
        self.at = row0 + torch.where(self.live, sid, self.n_slots)
        self.trash = (row0 + self.n_slots).expand(R, P)

    def add(self, resp: torch.Tensor, p0: int, max_rank: int):
        """Add resp (R, k, W), the responses of rows p0 .. p0 + k - 1."""
        k = resp.shape[1]
        cols = slice(p0, p0 + k)
        # each response at its offset inside a row of the slot's width
        shifted = torch.zeros((self.R, k, self.width), dtype=resp.dtype,
                              device=resp.device)
        shifted.scatter_(-1, self.off[:, cols, None]
                         + torch.arange(self.W, device=resp.device), resp)
        shifted = shifted.reshape(self.R * k, self.width)
        live, rank = self.live[:, cols], self.rank[:, cols]
        at, trash = self.at[:, cols], self.trash[:, cols]
        for r in range(max_rank):
            rows = torch.where(live & (rank == r), at, trash).reshape(-1)
            self.grid.index_put_((rows,), self.grid[rows] + shifted)

    def result(self, max_rank: int):
        """(y (R, y_length), crowded (R,)): the folded grid, and where a live
        row of rank ``max_rank`` or more was left out."""
        crowded = (self.live & (self.rank >= max_rank)).any(dim=-1)
        grid = self.grid.view(self.R, self.n_slots + 1, self.width)[:, :self.n_slots]
        return uniform_ola(grid, -self.base, SLOT, self.y_length), crowded


def slot_ola(resp: torch.Tensor, starts: torch.Tensor, y_length: int,
             max_rank: int):
    """(y (..., y_length), crowded (...)): y[..., starts[p] + j] +=
    resp[..., p, j] for every in-range sample of resp (..., P, W), for
    nondecreasing integer ``starts`` (..., P); rows that lie wholly outside
    [0, y_length) contribute nothing.  Nothing is read back to the host.

    What ``world_tpu.dsp.ola.slotted_ola`` computes: each row is shifted to
    its offset inside its SLOT-sample slot, the rows of a slot are summed in
    their order, and the slot grid folds with :func:`uniform_ola`.  A row's
    rank inside its slot picks the pass that adds it: the rows of one rank
    sit in distinct slots, so each pass is a scatter without collisions.
    ``max_rank`` passes run (:func:`rank_bound`); every row of the pass's
    rank adds its shifted response to its slot's grid row, every other row
    writes a trash row.  A live row of rank ``max_rank`` or more is not
    added and sets ``crowded`` for its batch row: the JAX function has no
    such limit, and the flag says when the bound was passed."""
    *lead, P, W = resp.shape
    R = math.prod(lead)
    grid = SlotGrid(starts.reshape(R, P), y_length, W, resp.dtype)
    grid.add(resp.reshape(R, P, W), 0, max_rank)
    y, crowded = grid.result(max_rank)
    return y.reshape(*lead, y_length), crowded.reshape(lead)


def scatter_ola(resp: torch.Tensor, starts: torch.Tensor,
                y_length: int) -> torch.Tensor:
    """:func:`slot_ola` at ``max_rank = SLOT`` for resp (..., P, W), checked:
    one read of the crowded flag, and ValueError where more than SLOT rows
    start in one slot (the syntheses' pulse starts, strictly increasing,
    never do)."""
    y, crowded = slot_ola(resp, starts, y_length, SLOT)
    if bool(crowded.any()):
        raise ValueError(f"scatter_ola: more than {SLOT} rows start in one "
                         f"{SLOT}-sample slot")
    return y
