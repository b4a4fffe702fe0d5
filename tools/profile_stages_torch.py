#!/usr/bin/env python3
"""Where the Harvest path's time goes on one GPU: its stages and Harvest's
own sub-stages, with device events, device time, idle share, kernel
launches and host syncs of each (the PyTorch port's counterpart of
tools/profile_stages.py and tools/profile_harvest.py).

Run from the repository root:

    PYTHONPATH=. python3 tools/profile_stages_torch.py [--signal x16 glide] [--out f.json]
    PYTHONPATH=. python3 tools/profile_stages_torch.py --device cpu --signal x16 --seconds 0.5

Signals: ``x16``, tests/golden/harvest_16k.npz's 4.644 s at 16 kHz, and
``glide``, 60 s of tools/check_long_audio.py's vowel-like glide at
22.05 kHz (this tool's own copy).  ``--seconds`` cuts either.

One float32 round trip on ``HarvestRequiem``'s tables (resident) runs
eagerly (``bench_torch.eager_round_trip``: a CUDA graph's replay has no
stages to wrap); the stage functions are wrapped in place, in the modules that call
them, so the path and its stage order are the program's own.  After a
warm-up call, three more calls:
  1. unprofiled: each stage's milliseconds by CUDA events around it
     (inclusive of the stages inside it), and the launches of K1, K2,
     FixStep3's K4 and K5 and D4C's K6 and K7 (launched through ctypes,
     these are not among the profiler's device events below);
  2. under ``torch.cuda.set_sync_debug_mode("warn")`` (restored after):
     the host syncs inside each stage, one warning each;
  3. under torch.profiler, each stage inside a ``record_function`` range:
     the device kernels and copies that ops inside the range launched, and
     their device time.  The idle share is 1 - device time / the
     unprofiled milliseconds.
A stage called more than once sums its calls.  On the CPU only the
milliseconds (host clock) are measured.

Prints a table per signal and one JSON line; ``--out`` also writes it.
"""
import argparse
import contextlib
import importlib
import json
import time
import warnings
from pathlib import Path

import numpy as np

import bench_torch as BT

# (label, module, function): the stages, where the caller looks them up
STAGES = (
    ("round trip", None, None),
    ("Harvest", "world_tpu_torch.parallel.batch", "harvest_core"),
    ("  decimator", "world_tpu_torch.f0.harvest", "downsample"),
    ("  band candidates", "world_tpu_torch.f0.harvest", "raw_band_candidates"),
    ("    FIR bank", "world_tpu_torch.f0.harvest", "band_filtered"),
    ("    event rows + K1", "world_tpu_torch.f0.harvest", "four_event_interp"),
    ("  detect_candidates", "world_tpu_torch.f0.harvest", "detect_candidates"),
    ("  overlap_candidates", "world_tpu_torch.f0.harvest", "overlap_candidates"),
    ("  refine_candidates", "world_tpu_torch.f0.harvest", "refine_candidates"),
    ("    K2", "world_tpu_torch.f0.harvest", "refine_full"),
    ("  remove_unreliable", "world_tpu_torch.f0.harvest", "remove_unreliable"),
    ("  search_f0_base", "world_tpu_torch.f0.harvest", "search_f0_base"),
    ("  FixStep1", "world_tpu_torch.f0.harvest", "fix_step1"),
    ("  FixStep2", "world_tpu_torch.f0.harvest", "fix_step2"),
    ("  FixStep3", "world_tpu_torch.f0.harvest", "fix_step3"),
    ("    K4 chains", "world_tpu_torch.ops.fix_step3", "extend_chains"),
    ("    K5 merge", "world_tpu_torch.ops.fix_step3", "merge_sections"),
    ("  FixStep4", "world_tpu_torch.f0.harvest", "fix_step4"),
    ("  smoothing", "world_tpu_torch.f0.harvest", "smooth_f0"),
    ("CheapTrick", "world_tpu_torch.parallel.batch", "spectral_envelope"),
    ("D4C-Requiem", "world_tpu_torch.parallel.batch", "d4c_aperiodicity"),
    ("excitation", "world_tpu_torch.parallel.batch", "excitation_core"),
    ("waveform", "world_tpu_torch.parallel.batch", "waveform_core"),
)
GLIDE_FS, GLIDE_SECONDS = 22050, 60.0
# the kernels whose launches the table counts, by bench_torch.launch_counts'
# names: K1, K2, FixStep3's K4 and K5, and D4C's K6 and K7
KERNELS = {"event_engine": "K1", "refine_dft": "K2", "extend_chains": "K4",
           "merge_sections": "K5", "d4c_centroid": "K6", "d4c_band_ap": "K7"}


def glide_signal(fs: int, seconds: float) -> np.ndarray:
    """tools/check_long_audio.py's probe: an f0 glide over one octave from
    110 Hz with four harmonics, 200 ms of silence every 2 s, and seeded
    noise of 1e-4."""
    n = int(fs * seconds)
    t = np.arange(n) / fs
    f0 = 110.0 * 2 ** (t / max(t[-1], 1e-9))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = np.zeros(n)
    for h, a in [(1, 1.0), (2, 0.5), (3, 0.3), (4, 0.2)]:
        x += a * np.sin(h * phase)
    gate = np.floor(t / 2.0) != np.floor((t + 0.2) / 2.0)
    x *= np.where(gate, 0.0, 1.0)
    x += 1e-4 * np.random.RandomState(0).randn(n)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def signal(name: str, seconds):
    if name == "x16":
        x, fs, _, _ = BT.fixture(seconds)
        return x, fs
    return glide_signal(GLIDE_FS, GLIDE_SECONDS if seconds is None else seconds), GLIDE_FS


class Probe:
    """Wraps each stage function in place and records, per label, its calls
    and what the current mode measures: CUDA events (or host clock stamps
    on the CPU), the count of sync warnings, kernel launches, and a
    profiler range."""

    def __init__(self, device, stages=STAGES):
        self.device = device
        self.stages = stages
        self.mode = "time"
        self.records = {}
        self.sync_log = []

    def reset(self, mode: str):
        self.mode = mode
        self.records = {label: [] for label, _, _ in self.stages}
        self.sync_log = []

    def _stamp(self):
        import torch

        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @contextlib.contextmanager
    def stage(self, label: str):
        import torch

        if self.mode == "time":
            counters = BT.launch_counts()
            before = {k: c.launches for k, c in counters.items()}
            start = self._stamp()
            yield
            self.records[label].append(
                (start, self._stamp(),
                 {k: c.launches - before[k] for k, c in counters.items()}))
        elif self.mode == "sync":
            n0 = len(self.sync_log)
            yield
            self.records[label].append((n0, len(self.sync_log)))
        elif self.mode == "profile":
            with torch.profiler.record_function(label):
                yield
        else:
            yield

    @contextlib.contextmanager
    def installed(self):
        """The stages wrapped in their callers' modules."""
        saved = []
        for label, mod_name, fn_name in self.stages:
            if mod_name is None:
                continue
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)
            saved.append((mod, fn_name, fn))
            setattr(mod, fn_name, self._wrap(label, fn))
        try:
            yield self
        finally:
            for mod, fn_name, fn in saved:
                setattr(mod, fn_name, fn)

    def _wrap(self, label, fn):
        def wrapped(*args, **kwargs):
            with self.stage(label):
                return fn(*args, **kwargs)
        return wrapped

    def syncs(self) -> dict:
        """The host syncs inside each label's calls: the sync warnings
        recorded while they ran."""
        is_sync = [int("synchroniz" in str(w.message)) for w in self.sync_log]
        return {label: sum(sum(is_sync[a:b]) for a, b in recs)
                for label, recs in self.records.items()}

    def milliseconds(self) -> dict:
        BT.sync(self.device)
        out = {}
        for label, recs in self.records.items():
            if self.device.type == "cuda":
                ms = sum(a.elapsed_time(b) for a, b, _ in recs)
            else:
                ms = sum((b - a) * 1e3 for a, b, _ in recs)
            launches = {k: sum(r[2][k] for r in recs) for k in KERNELS}
            out[label] = {"calls": len(recs), "ms": ms, "launches": launches}
        return out


def device_by_range(prof, labels) -> dict:
    """(device events, device ms) of the kernels and copies launched by the
    ops inside each label's record_function ranges, or None where the
    profiler saw no device event at all."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    events = [e for e in prof.events() if e.device_type == cpu]
    launching = [e for e in events if e.kernels and e.name not in labels]
    if not launching:
        return {label: None for label in labels}
    starts = np.array([e.time_range.start for e in launching])
    counts = np.array([len(e.kernels) for e in launching])
    us = np.array([sum(k.duration for k in e.kernels) for e in launching])
    out = {}
    for label in labels:
        n, t = 0, 0.0
        for rng in (e for e in events if e.name == label):
            inside = (starts >= rng.time_range.start) & (starts <= rng.time_range.end)
            inside &= np.array([e.thread == rng.thread for e in launching])
            n += int(counts[inside].sum())
            t += float(us[inside].sum())
        out[label] = (n, t / 1e3)
    return out


def profile_signal(name: str, seconds, device, stages=STAGES) -> dict:
    import torch

    from world_tpu_torch import HarvestRequiem

    x, fs = signal(name, seconds)
    audio_s = x.shape[0] / fs
    model = HarvestRequiem(fs, x.shape[0], BT.FRAME_PERIOD, dtype=torch.float32,
                           device=device)
    xt = torch.tensor(x, device=device)[None]
    probe = Probe(device, stages)
    labels = [label for label, _, _ in stages]
    with probe.installed():
        def call():
            with probe.stage("round trip"):
                return BT.eager_round_trip(model, xt)

        probe.reset("off")
        call()
        BT.sync(device)
        probe.reset("time")
        call()
        table = probe.milliseconds()
        syncs = {label: None for label in labels}
        dev = {label: None for label in labels}
        if device.type == "cuda":
            probe.reset("sync")
            mode = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                probe.sync_log = caught
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    call()
                    BT.sync(device)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            syncs = probe.syncs()
            from torch.profiler import ProfilerActivity, profile

            probe.reset("profile")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                call()
                BT.sync(device)
            dev = device_by_range(prof, labels)
    rows = {}
    for label in labels:
        t = table[label]
        d = dev[label]
        rows[label.strip()] = {
            "calls": t["calls"], "ms": t["ms"], "launches": t["launches"],
            "host_syncs": syncs[label],
            "device_events": None if d is None else d[0],
            "device_ms": None if d is None else d[1],
            "idle_share": (None if d is None or t["ms"] <= 0
                           else 1.0 - d[1] / t["ms"])}
    total = table["round trip"]["ms"]
    print(f"\n{name}: {audio_s:.3f} s at {fs} Hz, float32, round trip "
          f"{total:.2f} ms = {audio_s / (total / 1e3):.2f} xRT")
    width = max(24, max(map(len, labels)))
    print(f"{'stage':{width}s} {'calls':>5s} {'ms':>9s} {'share':>6s} {'syncs':>6s} "
          f"{'dev ev':>7s} {'dev ms':>8s} {'idle':>6s} "
          + " ".join(f"{k:>3s}" for k in KERNELS.values()))
    fmt = lambda v, f: "-" if v is None else format(v, f)     # noqa: E731
    for label in labels:
        r = rows[label.strip()]
        print(f"{label:{width}s} {r['calls']:5d} {r['ms']:9.2f} "
              f"{r['ms'] / total:6.3f} {fmt(r['host_syncs'], 'd'):>6s} "
              f"{fmt(r['device_events'], 'd'):>7s} {fmt(r['device_ms'], '.3f'):>8s} "
              f"{fmt(r['idle_share'], '.3f'):>6s} "
              + " ".join(f"{r['launches'][k]:3d}" for k in KERNELS))
    return {"signal": name, "fs": fs, "seconds": audio_s, "stages": rows}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--signal", nargs="*", default=["x16", "glide"],
                    choices=["x16", "glide"])
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", type=Path, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_stages_torch: no CUDA device; pass --device cpu "
                         "to run on the CPU")
    doc = {"dtype": "float32",
           "method": "stage functions wrapped in place; ms by CUDA events "
                     "(inclusive), syncs by set_sync_debug_mode('warn'), device "
                     "events and time by torch.profiler ranges; idle = 1 - "
                     "device ms / ms",
           "signals": [profile_signal(s, args.seconds, device) for s in args.signal],
           **BT.environment(device)}
    line = json.dumps(doc)
    print(line)
    if args.out is not None:
        args.out.write_text(line + "\n")
    return doc


if __name__ == "__main__":
    main()
