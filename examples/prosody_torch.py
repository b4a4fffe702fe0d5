#!/usr/bin/env python3
"""End-to-end analysis, modification and resynthesis with world_tpu_torch
(examples/prosody.py on the PyTorch port).

Read a wav, encode it (Harvest and D4C-Requiem by default), optionally
modify the prosody, decode, and write the resynthesized wav.  With no wav
given it reads the 4.644 s utterance ``x16`` of
tests/golden/harvest_16k.npz.  Runs on the GPU unless ``--device cpu``.

Usage, from the repository root:

    PYTHONPATH=. python3 examples/prosody_torch.py [input.wav] [--pitch 1.5]
        [--duration 2.0] [--warp F1 F2 T1 T2] [--f0-method harvest]
        [--classic] [--device cuda] [--dtype float32] [--out out.wav]
"""
import argparse
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parent.parent / "tests" / "golden" / "harvest_16k.npz"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("wav", nargs="?", default=None,
                    help="input wav (default: x16 of tests/golden/harvest_16k.npz)")
    ap.add_argument("--pitch", type=float, default=None,
                    help="global pitch scale factor")
    ap.add_argument("--duration", type=float, default=None,
                    help="global duration scale factor")
    ap.add_argument("--warp", type=float, nargs=4, default=None,
                    metavar=("FROM1", "FROM2", "TO1", "TO2"),
                    help="piecewise time warp: map times FROM1,FROM2 (s) to "
                         "TO1,TO2 (s); TO2=-1 pins FROM2 to itself and keeps "
                         "the total duration")
    ap.add_argument("--f0-method", default="harvest",
                    choices=["dio", "harvest", "swipe"])
    ap.add_argument("--classic", action="store_true",
                    help="classic (non-Requiem) analysis and synthesis")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--out", type=Path, default=None,
                    help="output wav (default: <input stem>-resynth.wav in the "
                         "working directory)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    from world_tpu_torch import World
    from world_tpu_torch.io.wav import read_wav, write_wav

    if args.wav is None:
        g = np.load(GOLDEN)
        fs, x, stem = int(g["fs"]), np.asarray(g["x16"], np.float64), "x16"
    else:
        fs, x = read_wav(args.wav)
        stem = Path(args.wav).stem
    vocoder = World(device=args.device, dtype=args.dtype)
    dat = vocoder.encode(fs, x, f0_method=args.f0_method,
                         is_requiem=not args.classic)
    if args.pitch:
        dat = vocoder.scale_pitch(dat, args.pitch)
    if args.duration:
        dat = vocoder.scale_duration(dat, args.duration)
    if args.warp:
        f1, f2, t1, t2 = args.warp
        vocoder.modify_duration(dat, [f1, f2], [t1, t2])
    dat = vocoder.decode(dat)
    y = np.asarray(dat["out"])
    out_path = args.out or Path.cwd() / f"{stem}-resynth.wav"
    write_wav(out_path, fs, y)
    print(f"wrote {out_path} ({len(y) / fs:.2f} s, peak {np.abs(y).max():.3f}, "
          f"finite {bool(np.isfinite(y).all())})")
    return {"path": str(out_path), "fs": fs, "y": y}


if __name__ == "__main__":
    main()
