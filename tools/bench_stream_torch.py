#!/usr/bin/env python3
"""A server's ragged stream and the eager Harvest encode, timed on one GPU.

Run from the repository root:

    PYTHONPATH=. python3 tools/bench_stream_torch.py --out stream.json
    PYTHONPATH=. python3 tools/bench_stream_torch.py --device cpu --seconds 0.5 \\
        --calls 2 --max-utts 2 --min-seconds 0.3 --max-seconds 0.5 --readings 1
    python3 tools/bench_stream_torch.py --compare a.json b.json

It imports whichever ``world_tpu_torch`` comes first on the path, so two
versions of the package can be timed in one machine (``PYTHONPATH`` naming
the other checkout first), and reads nothing but the public API.

Stream: ``--calls`` calls of ``batch_encode_decode_ragged`` (float32,
1 s buckets).  Call i draws k utterances, k uniform in 1..``--max-utts``,
each a cut of tests/golden/harvest_16k.npz's x16 (16 kHz; its first
``--seconds`` when given) whose length is
uniform in [``--min-seconds``, ``--max-seconds``], at a uniform offset
(numpy ``RandomState(0)``).  Every call draws anew, so the buckets'
rows change from call to call, as a server's do.  Each call is timed on the
host clock (it returns numpy arrays, which synchronizes).  Reported: the
stream's xRT (audio seconds over wall seconds) and ms a call (min, median,
90th percentile, max), for the whole stream and for each half; the
distinct (bucket, rows) pairs; where the package keeps CUDA graphs, the
calls ``BATCH_GRAPHS`` ran eagerly, captured and replayed, the captures of
a key captured before (recaptures, counted here by wrapping the cache's
``capture``, so that any version is counted alike), the graphs dropped
(captured but no longer held), the graphs held and the pool bytes they
hold at the end, and the ms of the calls that captured, of those that ran
a bucket eagerly and captured none, and of those that only replayed.

Encode: ``World.encode(fs, x16, "harvest", is_requiem=True)`` with the
default and with ``fft_size=2048`` (path B's Harvest encodes), run eagerly
by every version: ``--readings`` readings each after one warm-up, host
clock around a synchronize.

Prints ONE JSON line last; ``--out`` also writes it, with every contour
(f0 and vuv of the encodes and of each stream utterance).  ``--compare A
B`` reads two such files and prints vuv flips and the largest |f0
difference| over the contours: the same stream must give the same
decisions in both versions.
"""
import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parent.parent / "tests" / "golden" / "harvest_16k.npz"
QUANTUM_S = 1.0


def card_line():
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0]


def spread(values) -> dict:
    v = np.asarray(values, np.float64)
    return {"min": float(v.min()), "median": float(np.median(v)),
            "p90": float(np.percentile(v, 90)), "max": float(v.max())}


def stream_calls(x, fs, args) -> list:
    """[utterances of call i] for the stream's calls."""
    rng = np.random.RandomState(0)
    calls = []
    for _ in range(args.calls):
        utts = []
        for _ in range(rng.randint(1, args.max_utts + 1)):
            n = int(rng.uniform(args.min_seconds, args.max_seconds) * fs)
            n = min(n, x.shape[0])
            at = rng.randint(0, x.shape[0] - n + 1)
            utts.append(x[at:at + n])
        calls.append(utts)
    return calls


def signatures(calls, fs) -> int:
    """The distinct (bucket length, rows) pairs the stream's calls make."""
    quantum = int(round(QUANTUM_S * fs))
    seen = set()
    for utts in calls:
        buckets = {}
        for u in utts:
            L = max(quantum, -(-u.shape[0] // quantum) * quantum)
            buckets[L] = buckets.get(L, 0) + 1
        seen.update(buckets.items())
    return len(seen)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=None,
                    help="cut x16 to its first SECONDS")
    ap.add_argument("--calls", type=int, default=40)
    ap.add_argument("--max-utts", type=int, default=8)
    ap.add_argument("--min-seconds", type=float, default=0.9)
    ap.add_argument("--max-seconds", type=float, default=4.644)
    ap.add_argument("--readings", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--compare", type=Path, nargs=2, default=None)
    args = ap.parse_args(argv)
    if args.calls < 2 or args.max_utts < 1 or args.readings < 1:
        ap.error("--calls must be at least 2, --max-utts and --readings 1")
    return args


def compare(a: dict, b: dict) -> dict:
    """vuv flips and the largest |f0 difference| between two runs' contours
    (the encodes', then the stream's utterances')."""
    flips, df0 = [], []
    for ra, rb in zip(a["contours"], b["contours"], strict=True):
        va, vb = np.asarray(ra["vuv"]), np.asarray(rb["vuv"])
        flips.append(int((va != vb).sum()))
        df0.append(float(np.abs(np.asarray(ra["f0"]) - np.asarray(rb["f0"])).max()))
    out = {"rows": len(flips), "vuv_flips_total": int(sum(flips)),
           "rows_with_flips": int(sum(f > 0 for f in flips)),
           "max_abs_df0_hz": max(df0), "median_max_abs_df0_hz": float(np.median(df0))}
    print(f"compare {a['package']} vs {b['package']}: {out}")
    return out


def main(argv=None) -> dict:
    args = parse(argv)
    if args.compare:
        a, b = (json.loads(p.read_text()) for p in args.compare)
        return compare(a, b)
    import torch

    import world_tpu_torch
    from world_tpu_torch import World, batch_encode_decode_ragged
    from world_tpu_torch.parallel import batch as batch_module

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_stream_torch: no CUDA device; pass --device cpu")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    g = np.load(GOLDEN)
    fs = int(g["fs"])
    x = np.asarray(g["x16"], np.float32)
    if args.seconds is not None:
        x = x[:int(round(args.seconds * fs))]
    card = card_line() if device.type == "cuda" else None
    print(f"package {world_tpu_torch.__file__} on {device} [{card}]", flush=True)

    # the eager encode first: it also builds the kernels before the stream
    w = World(device=device, dtype=torch.float32)
    encode = {}
    for name, kw in (("harvest", {}), ("harvest_fft2048", {"fft_size": 2048})):
        def call():
            dat = w.encode(fs, x, f0_method="harvest", is_requiem=True, **kw)
            sync()
            return dat
        dat = call()
        ms = []
        for _ in range(args.readings):
            t0 = time.perf_counter()
            call()
            ms.append((time.perf_counter() - t0) * 1e3)
        encode[name] = {"ms": spread(ms), "ms_readings": ms,
                        "xrt_median": x.shape[0] / fs / (np.median(ms) / 1e3),
                        "contour": {"f0": np.asarray(dat["f0"]).tolist(),
                                    "vuv": np.asarray(dat["vuv"]).tolist()}}
        print(f"World.encode({name}) {np.median(ms):.2f} ms median "
              f"({min(ms):.2f}-{max(ms):.2f}) = {encode[name]['xrt_median']:.2f} xRT",
              flush=True)

    calls = stream_calls(x, fs, args)
    cache = getattr(batch_module, "BATCH_GRAPHS", None)
    before = dict(cache.calls) if cache is not None else None
    held_before = len(cache.graphs()) if cache is not None else 0
    captured_keys, recaptures = set(), []
    if cache is not None:
        real_capture = cache.capture

        def counted_capture(key, *a, **kw):
            n = cache.calls["captured"]
            graph = real_capture(key, *a, **kw)
            if cache.calls["captured"] > n:
                recaptures.append(key in captured_keys)
                captured_keys.add(key)
            return graph

        cache.capture = counted_capture
    ms, audio, rows, kinds = [], [], [], []
    for utts in calls:
        ran = dict(cache.calls) if cache is not None else None
        t0 = time.perf_counter()
        out = batch_encode_decode_ragged(utts, fs, devices=device,
                                         bucket_quantum_s=QUANTUM_S)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        if cache is not None:
            ran = {k: n - ran[k] for k, n in cache.calls.items()}
            kinds.append("capture" if ran["captured"] else
                         "eager" if ran["eager"] else "replay")
        audio.append(sum(u.shape[0] for u in utts) / fs)
        for r in out:
            if not np.all(np.isfinite(r["y"])):
                raise AssertionError("bench_stream_torch: a non-finite waveform")
            rows.append({"f0": r["f0"].tolist(), "vuv": r["vuv"].tolist()})

    def part(sl):
        return {"calls": len(ms[sl]), "audio_s": float(sum(audio[sl])),
                "wall_s": float(sum(ms[sl]) / 1e3),
                "xrt": float(sum(audio[sl]) / (sum(ms[sl]) / 1e3)),
                "ms_per_call": spread(ms[sl])}

    half = len(ms) // 2
    stream = {"all": part(slice(None)), "first_half": part(slice(None, half)),
              "second_half": part(slice(half, None)),
              "utterances": len(rows), "signatures": signatures(calls, fs),
              "ms_calls": ms}
    if cache is not None:
        del cache.capture                     # the class's method again
        stream["graph_calls"] = {k: n - before[k] for k, n in cache.calls.items()}
        stream["graph_recaptures"] = int(sum(recaptures))
        stream["graph_pool_bytes"] = cache.pool_bytes()
        stream["graphs_held"] = len(cache.graphs())
        stream["graphs_dropped"] = (stream["graph_calls"]["captured"]
                                    - (stream["graphs_held"] - held_before))
        stream["capture_s"] = [g.capture_s for g in cache.graphs()]
        stream["ms_by_kind"] = {
            kind: dict(spread([t for t, k in zip(ms, kinds) if k == kind]),
                       calls=kinds.count(kind))
            for kind in ("capture", "eager", "replay") if kind in kinds}
    for k in ("all", "first_half", "second_half"):
        p = stream[k]
        print(f"stream {k}: {p['calls']} calls, {p['audio_s']:.1f} s of audio in "
              f"{p['wall_s']:.2f} s = {p['xrt']:.2f} xRT; ms a call median "
              f"{p['ms_per_call']['median']:.1f}, p90 {p['ms_per_call']['p90']:.1f}, "
              f"max {p['ms_per_call']['max']:.1f}", flush=True)
    print(f"stream: {len(rows)} utterances, {stream['signatures']} (bucket, rows) "
          f"pairs" + ("" if cache is None else
                      f"; graphs: {stream['graph_calls']}, "
                      f"{stream['graph_recaptures']} recaptures, "
                      f"{stream['graphs_dropped']} dropped, {stream['graphs_held']} "
                      f"held, {stream['graph_pool_bytes'] / 2**20:.1f} MiB of pools"))
    what = {"capture": "captured", "eager": "ran a bucket eagerly, none captured",
            "replay": "only replayed"}
    for kind, p in stream.get("ms_by_kind", {}).items():
        print(f"stream calls that {what[kind]}: {p['calls']}, ms median "
              f"{p['median']:.1f}, p90 {p['p90']:.1f}, min {p['min']:.1f}, max "
              f"{p['max']:.1f}", flush=True)
    doc = {"tool": "tools/bench_stream_torch.py", "package": world_tpu_torch.__file__,
           "device": str(device), "card": card, "torch": torch.__version__,
           "args": {k: (str(v) if isinstance(v, Path) else v)
                    for k, v in vars(args).items()},
           "encode": {k: {m: v for m, v in e.items() if m != "contour"}
                      for k, e in encode.items()},
           "stream": stream}
    if args.out is not None:
        contours = [encode[k]["contour"] for k in sorted(encode)] + rows
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(doc, contours=contours)) + "\n")
    print(json.dumps(doc))
    return doc


if __name__ == "__main__":
    main()
