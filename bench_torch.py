#!/usr/bin/env python3
"""Benchmark of world_tpu_torch: xRT of the Harvest -> CheapTrick ->
D4C-Requiem -> Requiem round trip on one GPU, golden-gated (the PyTorch
port's counterpart of bench.py).

Run from the repository root:

    python3 bench_torch.py                                  # on the GPU
    python3 bench_torch.py --device cpu --seconds 0.5 --readings 1 --rounds 1

It times the round trip through ``HarvestRequiem`` (its static tables
resident on the device) in float32 on tests/golden/harvest_16k.npz's
``x16`` (4.644 s at 16 kHz), single-stream and as a batch of 4 copies, at
the JAX package's widths (f0 71-800 Hz, frame period 5 ms, 8192 pulses, 256
voiced sections, 15 candidates).  Each path is gated on its own timed
output before its number counts: vuv agreement > 0.99 and voiced F0 RMSE
< 1 Hz against the golden f0 and vuv, log-spectral distance < 1 dB against
its envelope and band-aperiodicity error < 1 dB.  A path that fails
reports ``"gate": "FAIL"`` and is left out of the headline; on a cut of the
utterance the golden does not apply and the gate is ``"n/a"``.

Timing: a reading enqueues ``rounds`` round trips back to back between two
CUDA events and pays one synchronize.  On the GPU each round trip is the
replay of the module's CUDA graph for its batch size (the first warm-up
call runs eagerly, the second captures it); nothing inside it syncs the
host.  Each path takes
``readings`` readings in this process and reports their min, median and
max.  On the CPU the readings are host-clock times of a CPU run.

Prints ONE JSON line.
"""
import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "harvest_16k.npz"
# bench.py's widths: max_candidates = int(n_bands / 10 + 0.5), 152 bands
BENCH_CAPS = {"max_pulses": 8192, "max_candidates": 15, "max_sections": 256}
FRAME_PERIOD = 5
BATCH = 4
# PERF.md section 2: the Harvest path's parity bars against the golden
GATE_BARS = {"vuv_agreement": 0.99, "f0_rmse_hz": 1.0, "lsd_db": 1.0,
             "band_ap_max_db": 1.0}


def card_line():
    """The card's name and power limit as nvidia-smi prints them, or None
    where there is no nvidia-smi."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0]


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reading_ms(fn, rounds: int, device):
    """(milliseconds a call, the last call's output) of ``rounds`` calls of
    fn enqueued back to back: CUDA events around them on the GPU, the host
    clock on the CPU."""
    import torch

    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(rounds):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / rounds, out
    t0 = time.perf_counter()
    for _ in range(rounds):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / rounds, out


def spread(values) -> dict:
    v = np.asarray(values, np.float64)
    return {"min": float(v.min()), "median": float(np.median(v)),
            "max": float(v.max())}


def launch_counts():
    """The kernels' launch counters (world_tpu_torch.ops)."""
    from world_tpu_torch.ops import edge_interp, extension_scan, refine_dft

    return {"event_engine": edge_interp.counter, "refine_dft": refine_dft.counter,
            "extension_scan": extension_scan.counter}


def timed_readings(fn, audio_seconds: float, readings: int, rounds: int,
                   device):
    """(stats, output of the last timed call): min/median/max of ms a call
    and of xRT over ``readings`` readings, after two warm-up calls (a path
    with CUDA graphs runs the first eagerly and captures on the second) and
    one call whose kernel launches are counted."""
    counters = launch_counts()
    fn()
    fn()
    sync(device)
    before = {k: c.launches for k, c in counters.items()}
    fn()
    sync(device)
    launches = {k: c.launches - before[k] for k, c in counters.items()}
    ms = []
    for _ in range(readings):
        m, out = reading_ms(fn, rounds, device)
        ms.append(m)
    stats = {"ms_per_call": spread(ms),
             "xrt": spread([audio_seconds / (m / 1e3) for m in ms]),
             "readings": readings, "rounds": rounds, "ms_readings": ms,
             "launches": launches}
    return stats, out


def eager_round_trip(model, x):
    """A ``HarvestRequiem``'s round trip of rows x run eagerly, never by a
    CUDA graph: :func:`encode_decode_one` on the module's tables and caps,
    the static code its graphs capture."""
    from world_tpu_torch.parallel.batch import HARVEST_TABLE_KEYS, encode_decode_one

    return encode_decode_one(
        x, model.pulse_seed, model.noise_seed, model.fs, model.frame_period,
        model.max_pulses, model.max_candidates, model.max_sections,
        tables={k: getattr(model, k) for k in HARVEST_TABLE_KEYS})


def eager_classic_round_trip(model, x, noise):
    """A ``DioClassic``'s round trip of rows x with the draw noise run
    eagerly, never by a CUDA graph: :func:`encode_decode_classic_one` on the
    module's tables, the static code its graphs capture."""
    from world_tpu_torch.parallel.batch import encode_decode_classic_one

    return encode_decode_classic_one(x, model.fs, model.frame_period, noise=noise,
                                     tables=dict(model.named_buffers()))


def golden_bars(f0, vuv, spectrogram, band_ap, g) -> dict:
    """One row's analysis against the golden: vuv agreement, voiced F0
    RMSE, LSD of the envelope and the band aperiodicity's largest error,
    on frames voiced in both.  f0, vuv (F,); spectrogram (F, bins);
    band_ap (F, bands)."""
    vuv, gvuv = np.asarray(vuv) > 0, np.asarray(g["vuv"]) > 0
    both = vuv & gvuv
    f0 = np.asarray(f0, np.float64)
    spec = np.asarray(spectrogram, np.float64).T[:, both]
    gspec = np.asarray(g["spectrogram"], np.float64)[:, both]
    ap = np.asarray(band_ap, np.float64).T[:, both]
    return {"vuv_agreement": float(np.mean(vuv == gvuv)),
            "f0_rmse_hz": float(np.sqrt(np.mean((f0[both] - g["f0"][both]) ** 2))),
            "lsd_db": float(np.sqrt(np.mean((10 * np.log10(spec + 1e-12)
                                             - 10 * np.log10(gspec + 1e-12)) ** 2))),
            "band_ap_max_db": float(np.max(np.abs(ap - g["band_aperiodicity"][:, both])))}


def gate_rows(out: dict, g, full: bool):
    """("PASS" | "FAIL" | "n/a", the worst row's bars) of a round trip's
    output (B rows); "n/a" on a cut, where the golden does not apply.
    Every row's waveform must be finite and not all zero."""
    import torch

    y_ok = bool(torch.isfinite(out["y"]).all()) and bool(
        (out["y"].abs().amax(dim=1) > 0).all())
    if not full:
        return ("n/a" if y_ok else "FAIL"), {"y_finite": y_ok}
    rows = [golden_bars(out["f0"][b].cpu().numpy(), out["vuv"][b].cpu().numpy(),
                        out["spectrogram"][b].cpu().numpy(),
                        out["band_aperiodicity"][b].cpu().numpy(), g)
            for b in range(out["f0"].shape[0])]
    worst = {"vuv_agreement": min(r["vuv_agreement"] for r in rows)}
    for k in ("f0_rmse_hz", "lsd_db", "band_ap_max_db"):
        worst[k] = max(r[k] for r in rows)
    ok = (y_ok and worst["vuv_agreement"] > GATE_BARS["vuv_agreement"]
          and all(worst[k] < GATE_BARS[k] for k in GATE_BARS
                  if k != "vuv_agreement"))
    return ("PASS" if ok else "FAIL"), dict(worst, y_finite=y_ok)


def fixture(seconds=None):
    """(x, fs, golden, full): x16, or its first ``seconds``."""
    g = np.load(GOLDEN)
    fs = int(g["fs"])
    x = np.asarray(g["x16"], np.float32)
    full = seconds is None or int(round(seconds * fs)) >= x.shape[0]
    if not full:
        x = x[:int(round(seconds * fs))]
    return x, fs, g, full


def environment(device) -> dict:
    import torch

    return {"device": str(device),
            "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu"),
            "card": card_line() if device.type == "cuda" else None,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=None,
                    help="cut x16 to its first SECONDS (the gate is n/a)")
    ap.add_argument("--readings", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=4,
                    help="round trips a reading enqueues (the batch path "
                         "takes half, at least one)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    import torch

    from world_tpu_torch import HarvestRequiem

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA device; pass --device cpu to "
                         "run on the CPU")
    x, fs, g, full = fixture(args.seconds)
    caps = BENCH_CAPS if full else {}
    audio_s = x.shape[0] / fs
    model = HarvestRequiem(fs, x.shape[0], frame_period=FRAME_PERIOD,
                           dtype=torch.float32, device=device, **caps)
    x1 = torch.tensor(x, device=device)[None]
    xb = x1.expand(BATCH, -1).contiguous()
    paths = {}
    for name, xin, rounds in (("single", x1, args.rounds),
                              (f"batch{BATCH}", xb, max(1, args.rounds // 2))):
        stats, out = timed_readings(lambda: model(xin), audio_s * xin.shape[0],
                                    args.readings, rounds, device)
        gate, detail = gate_rows(out, g, full)
        paths[name] = dict(stats, gate=gate, gate_detail=detail)
    counted = [p["xrt"]["median"] for p in paths.values() if p["gate"] != "FAIL"]
    doc = {
        "metric": "harvest+requiem encode+decode xRT (audio-s / wall-s), float32, "
                  "tables resident; the median of the better gated path",
        "value": max(counted) if counted else None,
        "unit": "x realtime",
        "fixture": f"tests/golden/harvest_16k.npz x16 ({fs} Hz, {audio_s:.3f} s"
                   f"{'' if full else ', a cut'})",
        "caps": dict(BENCH_CAPS if full else {
            "max_pulses": model.max_pulses, "max_candidates": model.max_candidates,
            "max_sections": model.max_sections}, frame_period=FRAME_PERIOD),
        "timing": "readings of `rounds` calls enqueued back to back, CUDA events "
                  "and one synchronize a reading; min/median/max over readings",
        "gate_bars": GATE_BARS,
        "paths": paths,
        **environment(device),
    }
    print(json.dumps(doc))
    return doc


if __name__ == "__main__":
    main()
