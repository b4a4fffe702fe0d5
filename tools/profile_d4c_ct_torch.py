#!/usr/bin/env python3
"""Where D4C-Requiem's and CheapTrick's time goes on one GPU: their
sub-stages, with each one's milliseconds, device events (the kernels and
copies it launches), device time and host syncs (the PyTorch port's
counterpart of tools/profile_d4c_ct.py and tools/profile_raw_band.py).

Run from the repository root:

    PYTHONPATH=. python3 tools/profile_d4c_ct_torch.py [--signal x16 glide] [--out f.json]
    PYTHONPATH=. python3 tools/profile_d4c_ct_torch.py --device cpu --signal x16 --seconds 0.5
    PYTHONPATH=_checkout/parent:. python3 tools/profile_d4c_ct_torch.py --peak

The sub-stages (STAGES), wrapped in place in the modules that call them:
  * D4C-Requiem (``aperiodicity/d4c_requiem.py::d4c_requiem_core``): its
    LoveTrain slabs (``frame_slabs``) and ``love_train_vuv``, then
    ``coarse_ap_frames`` and inside it the coarse slabs (``frame_slabs``
    again), K6 (``d4c_centroid``) and K7 (``d4c_band_ap``), whose plain
    versions (``ops/d4c_spectra.py``: ``static_centroid_half``, then
    ``smoothed_power_spectrum_half``, ``static_group_delay_half``,
    ``coarse_aperiodicity`` and its ``torch.topk``, ``largest_bins``) run
    on the CPU only: on the card they read 0 calls;
  * CheapTrick (``spectral/cheaptrick.py::cheaptrick_core``): the slabs,
    ``apply_adaptive_window``, ``_power_spectrum_with_dc_fill``,
    ``_linear_smoothing``, ``_smoothing_with_recovery``.
The band candidates' sub-stages (the FIR bank, the event rows and K1,
``detect_candidates``), which tools/profile_raw_band.py times in the JAX
package, are rows of tools/profile_stages_torch.py and are not repeated
here.

Signals and method are tools/profile_stages_torch.py's (its
``profile_signal`` over these STAGES): x16 (4.644 s at 16 kHz) and the 60 s
glide at 22.05 kHz, float32, one eager round trip on ``HarvestRequiem``'s
tables after a warm-up call; then one call with each sub-stage between CUDA
events (inclusive; a stage called more than once sums its calls), one
under ``set_sync_debug_mode("warn")`` and one under torch.profiler, each
sub-stage inside a ``record_function`` range, for its device events and
device time.  The idle share is 1 - device time / milliseconds.  On the CPU
only the milliseconds (host clock) are measured.  The kernels, launched
through ctypes, are not among the profiler's device events; their rows'
milliseconds (CUDA events) are their time.  Beside each of K6's, K7's and
the plain sub-stages' rows stands its bound (chip_smoke.d4c_bounds: the
least time of the function's bytes and operations on an H100 SXM, computed
from the operands of the round trip's coarse_ap_frames); on the card one
more eager call reads D4C-Requiem's peak memory above what was allocated
when it began (``d4c_requiem_peak_bytes``).

Prints a table per signal and one JSON line; ``--out`` also writes it.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import bench_torch as BT  # noqa: E402
import profile_stages_torch as PS  # noqa: E402

AP = "world_tpu_torch.aperiodicity"
CT = "world_tpu_torch.spectral.cheaptrick"
BATCH = "world_tpu_torch.parallel.batch"
OPS = "world_tpu_torch.ops.d4c_spectra"
# (label, module, function): the sub-stages, where their callers look them up
STAGES = (
    ("round trip", None, None),
    ("CheapTrick", BATCH, "spectral_envelope"),
    ("  frame_slabs (CheapTrick)", CT, "frame_slabs"),
    ("  apply_adaptive_window", CT, "apply_adaptive_window"),
    ("  _power_spectrum_with_dc_fill", CT, "_power_spectrum_with_dc_fill"),
    ("  _linear_smoothing", CT, "_linear_smoothing"),
    ("  _smoothing_with_recovery", CT, "_smoothing_with_recovery"),
    ("D4C-Requiem", BATCH, "d4c_aperiodicity"),
    ("  frame_slabs (LoveTrain)", f"{AP}.d4c_requiem", "frame_slabs"),
    ("  love_train_vuv", f"{AP}.d4c_requiem", "love_train_vuv"),
    ("  coarse_ap_frames", f"{AP}.d4c_requiem", "coarse_ap_frames"),
    ("    frame_slabs (coarse)", f"{AP}.common", "frame_slabs"),
    ("    K6 d4c_centroid", f"{AP}.common", "d4c_centroid"),
    ("      static_centroid_half", OPS, "static_centroid_half"),
    ("    K7 d4c_band_ap", f"{AP}.common", "d4c_band_ap"),
    ("      smoothed_power_spectrum_half", OPS, "smoothed_power_spectrum_half"),
    ("      static_group_delay_half", OPS, "static_group_delay_half"),
    ("      coarse_aperiodicity", OPS, "coarse_aperiodicity"),
    ("        largest_bins (torch.topk)", OPS, "largest_bins"),
)
# the rows that take a bound, by chip_smoke.d4c_bounds' names
BOUNDS = {"K6 d4c_centroid": "d4c_centroid", "K7 d4c_band_ap": "d4c_band_ap",
          "static_centroid_half": "static_centroid_half",
          "smoothed_power_spectrum_half": "smoothed_power_spectrum_half",
          "static_group_delay_half": "static_group_delay_half",
          "coarse_aperiodicity": "coarse_aperiodicity"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--signal", nargs="*", default=["x16", "glide"],
                    choices=["x16", "glide"])
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--peak", action="store_true",
                    help="only D4C-Requiem's peak memory on the card")
    return ap.parse_args(argv)


def _eager_call(name: str, seconds, device, patches: dict):
    """One eager round trip of the signal ``name`` with module attributes
    replaced ({(module, name): function}) for its duration."""
    import importlib

    import torch

    from world_tpu_torch import HarvestRequiem

    x, fs = PS.signal(name, seconds)
    model = HarvestRequiem(fs, x.shape[0], BT.FRAME_PERIOD, dtype=torch.float32,
                           device=device)
    saved = []
    for (mod_name, fn_name), fn in patches.items():
        mod = importlib.import_module(mod_name)
        saved.append((mod, fn_name, getattr(mod, fn_name)))
        setattr(mod, fn_name, fn(getattr(mod, fn_name)))
    try:
        BT.eager_round_trip(model, torch.tensor(x, device=device)[None])
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def d4c_bounds(name: str, seconds, device) -> dict:
    """chip_smoke.d4c_bounds on the operands of the round trip's
    coarse_ap_frames (K7's call recorded)."""
    import chip_smoke as CS

    seen = []

    def record(real):
        def call(*args):
            seen.append(args)
            return real(*args)
        return call

    _eager_call(name, seconds, device, {(f"{AP}.common", "d4c_band_ap"): record})
    (slab, margin, _, fs, f0, t, max_half, N, fi, n_ap, window), = seen
    return CS.d4c_bounds({"slab": slab, "margin": margin, "fs": fs, "f0": f0,
                          "t": t, "max_half": max_half, "fft_size": N, "fi": fi,
                          "n_ap": n_ap, "window": window})


def d4c_peak(name: str, seconds, device):
    """D4C-Requiem's peak memory on the card above what was allocated when
    it began, in one eager round trip (None on the CPU).  It wraps only
    ``parallel/batch.py::d4c_aperiodicity``, so it measures any checkout of
    the port (``--peak`` with that checkout first on the path)."""
    import torch

    if device.type != "cuda":
        return None
    peak = []

    def measure(real):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            peak.append(torch.cuda.max_memory_allocated() - before)
            return out
        return call

    _eager_call(name, seconds, device, {(BATCH, "d4c_aperiodicity"): measure})
    return peak[0]


def main(argv=None) -> dict:
    args = parse(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_d4c_ct_torch: no CUDA device; pass --device "
                         "cpu to run on the CPU")
    signals = []
    for s in args.signal:
        if args.peak:
            signals.append({"signal": s,
                            "d4c_requiem_peak_bytes": d4c_peak(s, args.seconds,
                                                               device)})
            print(f"{s}: D4C-Requiem's peak above what was allocated when it "
                  f"began {signals[-1]['d4c_requiem_peak_bytes']} bytes")
            continue
        sig = PS.profile_signal(s, args.seconds, device, STAGES)
        bounds = d4c_bounds(s, args.seconds, device)
        peak = d4c_peak(s, args.seconds, device)
        sig["d4c_requiem_peak_bytes"] = peak
        if peak is not None:
            print(f"{s}: D4C-Requiem's peak above what was allocated when it "
                  f"began {peak / 2**20:.1f} MiB")
        for label, name in BOUNDS.items():
            sig["stages"][label]["bound_ms"], sig["stages"][label]["bound_by"] = \
                bounds[name]
        print(f"{s} bounds (H100 SXM: 3.35 TB/s, 67 TFLOP/s): "
              + ", ".join(f"{label} {bounds[name][0]:.4g} ms ({bounds[name][1]}) "
                          f"against {sig['stages'][label]['ms']:.4g} ms"
                          for label, name in BOUNDS.items()))
        signals.append(sig)
    doc = {"dtype": "float32",
           "method": "sub-stage functions wrapped in place; ms by CUDA events "
                     "(inclusive), syncs by set_sync_debug_mode('warn'), device "
                     "events and time by torch.profiler ranges; idle = 1 - "
                     "device ms / ms; bound_ms by chip_smoke.d4c_bounds",
           "signals": signals, **BT.environment(device)}
    line = json.dumps(doc)
    print(line)
    if args.out is not None:
        args.out.write_text(line + "\n")
    return doc


if __name__ == "__main__":
    main()
