"""Independent users: one utterance a request, arriving as a Poisson
process at ``rate`` requests a second, served one at a time in arrival
order by one server thread (an open loop: a request is due at its arrival
whether or not the server is free, and its latency runs from then).

Every seed gets the same arrivals (the quantiles (i + 1/2) / N of the
exponential law of mean 1 / rate as gaps, in one order drawn once for all
seeds) and the same lengths (stratum midpoints of [min_s, max_s]) in an
order and at offsets drawn from the seed: the seeds differ in which
utterance comes when, not in when work arrives or how much.  The window
holds the N = round(rate * seconds) requests due in it, and lasts until the
last of them is served.  Parameters: ``rate``, ``quantum_s``, ``min_s``,
``max_s``, ``keep_share``.
"""
import time

import numpy as np

from . import cuts
from .common import Call, Request, draw_seed

SPIN_S = 0.002      # the last stretch before a due time is spun, not slept


class Plan:
    def __init__(self, params: dict, seed: int, audio, seconds: float):
        self.p, self.seed, self.x, self.fs = params, int(seed), audio.x, audio.fs
        rate = float(params["rate"])
        self.n = max(1, int(round(rate * seconds)))
        gaps = -np.log(1.0 - (np.arange(self.n) + 0.5) / self.n) / rate
        self.due = np.cumsum(cuts.rng(0, 1).permutation(gaps))
        g = cuts.rng(seed, 1)
        self.lengths = cuts.lengths_in(self.n, params["min_s"], params["max_s"],
                                       g, self.x.shape[0], self.fs)
        self.offsets = [cuts.cut(self.x, int(m), g)[0] for m in self.lengths]

    def _call(self, i: int, off: int, n: int, due: float) -> Call:
        L = cuts.bucket_of(n, self.p["quantum_s"], self.fs)
        req = Request(i, off, n, bucket=L, due=float(due), fs=self.fs)
        return Call(i, [req], 1, L, noise_seed=draw_seed(self.seed, 3, i))

    def calls(self):
        for i in range(self.n):
            yield self._call(i, self.offsets[i], int(self.lengths[i]), self.due[i])

    def warm_calls(self) -> list:
        """One request of each bucket the window sends."""
        g = cuts.rng(self.seed, 2)
        out = []
        for i, L in enumerate(sorted({cuts.bucket_of(int(n), self.p["quantum_s"],
                                                     self.fs)
                                      for n in self.lengths})):
            n = int(min(L, self.x.shape[0]))
            out.append(self._call(-1 - i, cuts.cut(self.x, n, g)[0], n, 0.0))
        return out


def plan(params: dict, seed: int, audio, seconds: float) -> Plan:
    return Plan(params, seed, audio, seconds)


def run(system, plan: Plan, seconds: float, record):
    """Serve each request at its due time or as soon as the server is free;
    ``record.lateness`` gets, for each request that found the server idle,
    how late the loop started it (the generator's own lag)."""
    record.lateness = []
    record.open()
    free_at = 0.0
    for call in plan.calls():
        due = call.requests[0].due
        wait = due - record.now()
        if wait > SPIN_S:
            time.sleep(wait - SPIN_S)
        while record.now() < due:
            pass
        start = record.now()
        if free_at <= due:
            record.lateness.append(start - due)
        outputs = system.call(call)
        free_at = record.now()
        record.done(call, start, free_at, outputs, due=due)
    record.close(max(free_at, float(plan.due[-1])))
