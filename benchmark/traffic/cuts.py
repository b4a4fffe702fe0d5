"""Utterances cut from a configuration's audio, and the length buckets the
port groups them into.

A configuration names its audio, ``"audio": "<stem>"``: the samples are
benchmark/data/<stem>.npy, and the manifest beside them, <stem>.json, gives
their rate ``fs``, their ``source``, the transform that ``made`` them from
it (with its seed; null where they are the source's own) and their
``seconds``.  Every conversion between seconds and samples takes the
audio's own rate; nothing is resampled.

The generator is tools/bench_stream_torch.py's: a cut of the audio whose
length is uniform in [min_s, max_s] at a uniform offset.  Here every seed
gets the same multiset of lengths, in another order and at other offsets (the
midpoints of equal strata of the uniform law; a batch call's own cuts are
drawn inside the strata of its bucket), so that the work of a run does not
move with its seed while the audio does.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent.parent / "data"


@dataclasses.dataclass(frozen=True)
class Audio:
    """The speech a cell's cuts are taken from: its samples as the program
    takes them (float32) and their rate."""
    x: np.ndarray
    fs: int


def load(stem: str) -> Audio:
    """The audio ``stem`` in :data:`DATA`, at its manifest's rate."""
    manifest = json.loads((DATA / f"{stem}.json").read_text())
    return Audio(np.load(DATA / f"{stem}.npy").astype(np.float32),
                 int(manifest["fs"]))


def rng(seed: int, *stream) -> np.random.Generator:
    """The generator of one stream of draws of a run's seed: any whole
    number, negative or past 64 bits included."""
    words = [int(v) for v in (seed, *stream)]
    return np.random.default_rng([2 * abs(v) + (v < 0) for v in words])


def stratified(n: int, lo: float, hi: float, g: np.random.Generator) -> np.ndarray:
    """n values, one uniform draw inside each of n equal strata of [lo, hi],
    in a random order."""
    u = (np.arange(n) + g.random(n)) / n
    return g.permutation(lo + (hi - lo) * u)


def lengths_in(n: int, lo_s: float, hi_s: float, g, n_max: int,
               fs: int) -> np.ndarray:
    """n cut lengths in samples at ``fs``, the midpoints of n equal strata of
    [lo_s, hi_s] seconds (at most ``n_max``), in an order drawn from g:
    every seed gets the same lengths."""
    u = lo_s + (hi_s - lo_s) * (np.arange(n) + 0.5) / n
    return g.permutation(np.minimum((u * fs).astype(np.int64), n_max))


def cut(x: np.ndarray, n: int, g: np.random.Generator) -> tuple:
    """(offset, n): a cut of n samples of x at a uniform offset."""
    return int(g.integers(0, x.shape[0] - n + 1)), int(n)


def bucket_of(n: int, quantum_s: float, fs: int) -> int:
    """The padded length of an utterance of n samples at ``fs`` in buckets
    of ``quantum_s`` seconds (world_tpu_torch.parallel.batch.bucket_lengths)."""
    q = max(1, int(round(quantum_s * fs)))
    return max(q, -(-n // q) * q)


def bucket_range(L: int, quantum_s: float, lo_s: float, hi_s: float,
                 fs: int) -> tuple:
    """The lengths in seconds [a, b] of the cuts that bucket L (samples at
    ``fs``) holds."""
    q = quantum_s
    return max(lo_s, L / fs - q), min(hi_s, L / fs)


def bucket_shares(quantum_s: float, lo_s: float, hi_s: float, fs: int) -> dict:
    """{padded length at ``fs``: share of a uniform law on [lo_s, hi_s] it
    holds}."""
    out, L = {}, bucket_of(int(lo_s * fs), quantum_s, fs)
    while L / fs - quantum_s < hi_s:
        a, b = bucket_range(L, quantum_s, lo_s, hi_s, fs)
        if b > a:
            out[L] = (b - a) / (hi_s - lo_s)
        L += int(round(quantum_s * fs))
    return out


def calls_per_pass(shares: dict, calls: int) -> dict:
    """{padded length: calls of it in a pass of ``calls``}: the shares
    rounded by largest remainder, each bucket at least one call."""
    raw = {L: s * calls for L, s in shares.items()}
    out = {L: max(1, int(v)) for L, v in raw.items()}
    for L in sorted(raw, key=lambda k: raw[k] - int(raw[k]), reverse=True):
        if sum(out.values()) >= calls:
            break
        out[L] += 1
    return out
