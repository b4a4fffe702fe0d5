#!/usr/bin/env python3
"""Probe of ``batch_encode_decode`` over two worker threads on one card.

Run from the repository root on a GPU machine:

    PYTHONPATH=. python3 tools/probe_two_threads_torch.py [--sync-replay]

The batch of 4 of chip_smoke.py (x16 and three copies with seeded noise of
1e-3) runs over ``devices=["cuda:0", "cuda:0"]``: two worker threads, one
shard of 2 rows each, both on one graph signature.  Each call's shards are
held bitwise to the same rows run eagerly on one device
(``encode_decode_one``), after each of these states: a cleared graph cache
(the first call runs one shard eagerly while the other thread captures),
back-to-back replays, one-device calls of the batch of 4 (another
signature), Harvest on 60 s of the glide eagerly, a 60 s ``HarvestRequiem``
captured and dropped, and one-device calls of each shard's rows.  For a
shard that differs it prints the outputs that differ, the largest f0
difference, and whether it equals the other shard's rows (a replay that read
the other thread's inputs or outputs).  ``--sync-replay`` synchronizes the
card before and after every graph replay.  The last line is a JSON summary.
"""
import argparse
import json
import threading

import numpy as np

KEYS = ("f0", "vuv", "spectrogram", "band_aperiodicity", "y",
        "_refine_overflow", "_section_overflow", "_pulse_overflow")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sync-replay", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from world_tpu_torch import HarvestRequiem, batch_encode_decode
    from world_tpu_torch.f0 import harvest as H
    from world_tpu_torch.f0.harvest import (default_max_candidates,
                                            default_max_sections)
    from world_tpu_torch.parallel import graphs
    from world_tpu_torch.parallel.batch import (
        BATCH_GRAPHS, HARVEST_TABLE_KEYS, default_batch_max_pulses,
        encode_decode_one, harvest_requiem_tables)

    import bench_torch as BT
    from profile_stages_torch import GLIDE_FS, GLIDE_SECONDS, glide_signal

    if not torch.cuda.is_available():
        raise SystemExit("probe_two_threads_torch: no CUDA device")
    if args.sync_replay:
        real = graphs.Graph.replay

        def synced(self, inputs):
            torch.cuda.synchronize()
            out = real(self, inputs)
            torch.cuda.synchronize()
            return out

        graphs.Graph.replay = synced
    streams = {}
    real_replay = graphs.Graph.replay

    def noting(self, inputs):
        streams[threading.current_thread().name] = torch.cuda.current_stream().cuda_stream
        return real_replay(self, inputs)

    graphs.Graph.replay = noting

    x16, fs, _, _ = BT.fixture()
    rng = np.random.RandomState(0)
    xs = np.stack([x16] + [x16 + 1e-3 * rng.randn(x16.shape[0]) for _ in range(3)])
    two = ["cuda:0", "cuda:0"]
    t = harvest_requiem_tables(fs, 0, torch.float32, "cuda:0")
    caps = (5, default_batch_max_pulses(xs.shape[1], fs), default_max_candidates(),
            default_max_sections(xs.shape[1], fs))
    own = [encode_decode_one(torch.tensor(xs[2 * k:2 * k + 2], dtype=torch.float32,
                                          device="cuda"),
                             t["pulse_seed"], t["noise_seed"], fs, *caps,
                             tables={n: t[n] for n in HARVEST_TABLE_KEYS})
           for k in range(2)]
    results = []

    def check(label):
        before = dict(BATCH_GRAPHS.calls)
        out = batch_encode_decode(xs, fs, devices=two, check_capacity=False)
        torch.cuda.synchronize()
        ran = {k: n - before[k] for k, n in BATCH_GRAPHS.calls.items()}
        shards = []
        for k in range(2):
            got = {key: out[key][2 * k:2 * k + 2] for key in KEYS}
            unequal = [key for key in KEYS if not torch.equal(got[key], own[k][key])]
            other = all(torch.equal(got[key], own[1 - k][key]) for key in KEYS)
            df0 = float((got["f0"] - own[k]["f0"]).abs().max())
            shards.append({"unequal": unequal, "equals_other_shard": other,
                           "max_df0_hz": df0})
        flags = {key: torch.nonzero(out[key]).flatten().tolist()
                 for key in KEYS[5:]}
        bad = any(s["unequal"] for s in shards) or any(flags.values())
        print(f"{label}: ran {ran}; flags {flags}; shards "
              + "; ".join(f"{k}: " + ("bitwise" if not s["unequal"] else
                                      f"differs in {s['unequal']}, max |df0| "
                                      f"{s['max_df0_hz']:.4g} Hz, equals the "
                                      f"other shard's rows {s['equals_other_shard']}")
                          for k, s in enumerate(shards))
              + ("  <-- FAULT" if bad else ""))
        results.append({"label": label, "ran": ran, "flags": flags,
                        "shards": shards, "fault": bad})

    BATCH_GRAPHS.clear()
    check("cleared cache: first call")
    check("second call")
    check("third call")
    for i in range(4):
        check(f"back-to-back {i + 1}")
    for _ in range(4):
        batch_encode_decode(xs, fs, devices="cuda:0", check_capacity=False)
    check("after one-device batch-4 calls")
    check("again")
    x60 = glide_signal(GLIDE_FS, GLIDE_SECONDS)
    x60_t = torch.tensor(x60, dtype=torch.float32, device="cuda")[None]
    for _ in range(2):
        H.harvest_core(x60_t, GLIDE_FS, 71.0, 800.0, 5.0, default_max_candidates(),
                       default_max_sections(x60.shape[0], GLIDE_FS))
    check("after Harvest on 60 s, eagerly")
    check("again")
    m60 = HarvestRequiem(GLIDE_FS, x60.shape[0], dtype=torch.float32, device="cuda")
    for _ in range(3):
        m60(x60_t)
    del m60
    torch.cuda.synchronize()
    check("after a 60 s HarvestRequiem captured and dropped")
    check("again")
    for k in range(2):
        batch_encode_decode(xs[2 * k:2 * k + 2], fs, devices="cuda:0",
                            check_capacity=False)
    check("after one-device calls of each shard's rows")
    check("again")
    torch.cuda.empty_cache()
    check("after empty_cache")
    doc = {"sync_replay": args.sync_replay, "streams": streams,
           "faults": [r["label"] for r in results if r["fault"]],
           **BT.environment(torch.device("cuda"))}
    print(json.dumps(doc))
    return doc


if __name__ == "__main__":
    main()
