"""One caller sending one utterance at a time at its own length, as a
script that loops over a corpus with a facade does (a closed loop).

A pass is the same ``lengths_per_pass`` lengths, stratified over
[min_s, max_s] once from the seed, in an order and at offsets drawn anew
for each pass: the window meets only the lengths the warm-up ran.
Parameters: ``lengths_per_pass``, ``min_s``, ``max_s``, ``keep_share``.
"""
import itertools

from . import cuts
from .common import Call, Request, draw_seed


class Plan:
    def __init__(self, params: dict, seed: int, audio):
        self.p, self.seed, self.x, self.fs = params, int(seed), audio.x, audio.fs
        self.lengths = cuts.lengths_in(params["lengths_per_pass"],
                                       params["min_s"], params["max_s"],
                                       cuts.rng(seed, 1), self.x.shape[0],
                                       self.fs)

    def _call(self, index: int, n: int, g) -> Call:
        off, n = cuts.cut(self.x, int(n), g)
        return Call(index, [Request(index, off, n, fs=self.fs)], 1, n,
                    noise_seed=draw_seed(self.seed, 3, index))

    def calls(self):
        index = 0
        for k in itertools.count():
            g = cuts.rng(self.seed, 2, k)
            for n in g.permutation(self.lengths):
                yield self._call(index, int(n), g)
                index += 1

    def warm_calls(self) -> list:
        g = cuts.rng(self.seed, 4)
        return [self._call(-1 - i, int(n), g)
                for i, n in enumerate(sorted(set(self.lengths.tolist())))]


def plan(params: dict, seed: int, audio, seconds: float) -> Plan:
    return Plan(params, seed, audio)


def run(system, plan: Plan, seconds: float, record):
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
