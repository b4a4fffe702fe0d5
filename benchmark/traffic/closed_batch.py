"""One caller running a corpus pass through a batch entry point: utterances
grouped into length buckets, ``rows`` utterances of one bucket a call, the
next call sent when the last returned (a closed loop).

A pass holds ``calls_per_pass`` calls, each bucket's share of them its
share of the uniform law of lengths on [min_s, max_s]; the calls of a pass
come in an order drawn from the seed, so that a window that ends inside a
pass takes an unbiased part of it.  A call's cuts are stratified over its
bucket's lengths (:mod:`.cuts`): every seed computes the same signatures and
nearly the same audio.  Parameters (the mix file's ``params``): ``rows``,
``quantum_s``, ``min_s``, ``max_s``, ``calls_per_pass``, ``keep_share``.
"""
import itertools

from . import cuts
from .common import Call, Request, draw_seed


class Plan:
    def __init__(self, params: dict, seed: int, audio):
        self.p, self.seed, self.x, self.fs = params, int(seed), audio.x, audio.fs
        q = params["quantum_s"]
        self.shares = cuts.bucket_shares(q, params["min_s"], params["max_s"],
                                         self.fs)
        self.counts = cuts.calls_per_pass(self.shares, params["calls_per_pass"])
        self.quantum = int(round(q * self.fs))

    def _call(self, index: int, L: int, g, first_id: int) -> Call:
        p = self.p
        lo = max(int(p["min_s"] * self.fs), L - self.quantum + 1)
        hi = min(int(p["max_s"] * self.fs), L, self.x.shape[0])
        n = (lo + cuts.stratified(p["rows"], 0.0, 1.0, g) * (hi - lo + 1)).astype(int)
        reqs = []
        for r, m in enumerate(n.clip(lo, hi)):
            off, m = cuts.cut(self.x, int(m), g)
            reqs.append(Request(first_id + r, off, m, bucket=L, fs=self.fs))
        return Call(index, reqs, p["rows"], L,
                    noise_seed=draw_seed(self.seed, 3, index))

    def calls(self):
        """The window's calls, pass after pass, without end."""
        index = 0
        for k in itertools.count():
            g = cuts.rng(self.seed, 1, k)
            order = g.permutation([L for L, c in sorted(self.counts.items())
                                   for _ in range(c)])
            for L in order:
                yield self._call(index, int(L), g, index * self.p["rows"])
                index += 1

    def warm_calls(self) -> list:
        """One call of each signature, from a stream of its own."""
        g = cuts.rng(self.seed, 2)
        return [self._call(-1 - i, L, g, -(1 + i) * self.p["rows"])
                for i, L in enumerate(sorted(self.counts))]


def plan(params: dict, seed: int, audio, seconds: float) -> Plan:
    return Plan(params, seed, audio)


def run(system, plan: Plan, seconds: float, record):
    """Calls back to back until the clock passes ``seconds``; the window is
    the time to the last call's end."""
    record.open()
    end = 0.0
    for call in plan.calls():
        start = record.now()
        outputs = system.call(call)
        end = record.now()
        record.done(call, start, end, outputs)
        if end >= seconds:
            break
    record.close(end)
