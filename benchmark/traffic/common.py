"""What every traffic driver shares: a request, a call of requests, and the
record of a measured window.

A driver module exposes ``plan(params, seed, audio, seconds) -> Plan``
(``audio``: the cell's :class:`.cuts.Audio`, samples and rate) and
``run(system, plan, seconds, record)``.  A plan knows the calls its window
makes (``calls()``, in order, as many as asked for) and the calls that warm
each signature up (``warm_calls()``).  A system (benchmark/entries) takes a
call and returns one dict of numpy outputs per request.
"""
import dataclasses
import time

import numpy as np

from .cuts import rng


@dataclasses.dataclass
class Request:
    id: int
    offset: int                 # first sample of the cut of the cell's audio
    n: int                      # its samples
    bucket: int = 0             # the length it is padded to (0: none)
    due: float = 0.0            # seconds after the window opened (open loop)
    noise_seed: int = 0         # the request's draws, where its system draws
    fs: int = dataclasses.field(kw_only=True)   # the audio's rate

    @property
    def audio_s(self) -> float:
        return self.n / self.fs


@dataclasses.dataclass
class Call:
    index: int
    requests: list
    rows: int                   # rows the call computes (padding included)
    length: int                 # samples a row computes (padding included)
    noise_seed: int = 0

    @property
    def signature(self) -> tuple:
        return (self.rows, self.length)


def draw_seed(seed: int, *stream) -> int:
    """A 63-bit seed for a torch generator, from the run's seed and a
    stream."""
    return int(rng(seed, 99, *stream).integers(0, 1 << 63))


class Record:
    """What a measured window did: for each request completed, its due
    time, start and end on the host clock (seconds after the window
    opened), and for each call its start and end; the outputs of the
    requests the correctness check samples (``keep``: request id -> True)
    and of the longest request completed."""

    def __init__(self, keep=()):
        self.keep = set(keep)
        self.requests = []          # (request, due, start, end, call index)
        self.calls = []             # (call, start, end)
        self.outputs = {}           # request id -> (request, call, row, outputs)
        self.longest = None
        self.t0 = None
        self.t_close = None         # the window's end on the host clock
        self.failed = 0

    def open(self):
        self.t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def done(self, call, start, end, outputs, due=None):
        self.calls.append((call, start, end))
        for row, (req, out) in enumerate(zip(call.requests, outputs)):
            self.requests.append((req, start if due is None else due, start,
                                  end, call.index))
            if req.id in self.keep:
                self.outputs[req.id] = (req, call, row, out)
            if self.longest is None or req.n > self.longest[0].n:
                self.longest = (req, call, row, out)

    def close(self, t_end: float):
        self.t_close = t_end

    def sample(self, seed: int, size: int) -> list:
        """The requests whose outputs the check compares: ``size`` of the
        kept ones drawn from the seed, and the longest completed."""
        kept = sorted(self.outputs)
        g = rng(seed, 7)
        pick = [self.outputs[i] for i in
                sorted(g.choice(kept, min(size, len(kept)), replace=False))]
        if self.longest is not None and self.longest[0].id not in {
                p[0].id for p in pick}:
            pick.append(self.longest)
        return pick

    # the window's numbers
    def window_s(self) -> float:
        return self.t_close

    def audio_s(self) -> float:
        return float(sum(r.audio_s for r, *_ in self.requests))

    def latencies_ms(self) -> np.ndarray:
        return np.array([(end - due) * 1e3 for _, due, _, end, _ in self.requests])


def keep_ids(n_requests: int, seed: int, share: float) -> set:
    """The request ids among the first ``n_requests`` whose outputs a run
    keeps for its check, each with probability ``share``."""
    g = rng(seed, 5)
    return set(np.flatnonzero(g.random(n_requests) < share).tolist())
