#!/usr/bin/env python3
"""Where D4C-Requiem's and CheapTrick's time goes on one GPU: their
sub-stages, with each one's milliseconds, device events (the kernels and
copies it launches), device time and host syncs (the PyTorch port's
counterpart of tools/profile_d4c_ct.py and tools/profile_raw_band.py).

Run from the repository root:

    PYTHONPATH=. python3 tools/profile_d4c_ct_torch.py [--signal x16 glide] [--out f.json]
    PYTHONPATH=. python3 tools/profile_d4c_ct_torch.py --device cpu --signal x16 --seconds 0.5

The sub-stages (STAGES), wrapped in place in the modules that call them:
  * D4C-Requiem (``aperiodicity/d4c_requiem.py::d4c_requiem_core``): its
    LoveTrain slabs (``frame_slabs``) and ``love_train_vuv``, then
    ``coarse_ap_frames`` and inside it the coarse slabs (``frame_slabs``
    again), ``static_centroid_half``, ``smoothed_power_spectrum_half``,
    ``static_group_delay_half``, ``coarse_aperiodicity`` and its
    ``torch.topk`` (``aperiodicity/common.py::largest_bins``);
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
only the milliseconds (host clock) are measured.

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
    ("    static_centroid_half", f"{AP}.common", "static_centroid_half"),
    ("    smoothed_power_spectrum_half", f"{AP}.common",
     "smoothed_power_spectrum_half"),
    ("    static_group_delay_half", f"{AP}.common", "static_group_delay_half"),
    ("    coarse_aperiodicity", f"{AP}.common", "coarse_aperiodicity"),
    ("      largest_bins (torch.topk)", f"{AP}.common", "largest_bins"),
)


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
        raise SystemExit("profile_d4c_ct_torch: no CUDA device; pass --device "
                         "cpu to run on the CPU")
    doc = {"dtype": "float32",
           "method": "sub-stage functions wrapped in place; ms by CUDA events "
                     "(inclusive), syncs by set_sync_debug_mode('warn'), device "
                     "events and time by torch.profiler ranges; idle = 1 - "
                     "device ms / ms",
           "signals": [PS.profile_signal(s, args.seconds, device, STAGES)
                       for s in args.signal],
           **BT.environment(device)}
    line = json.dumps(doc)
    print(line)
    if args.out is not None:
        args.out.write_text(line + "\n")
    return doc


if __name__ == "__main__":
    main()
