#!/usr/bin/env python3
"""Feature codecs with world_tpu_torch and their log-spectral distortion
(examples/spectral_features.py on the PyTorch port).

Encode a wav with Harvest, take the log-filterbank and MCEP-40 features of
its envelope, rebuild the envelope from the MCEP, and print the
log-spectral distortion of the round trip.  With no wav given it reads the
4.644 s utterance ``x16`` of tests/golden/harvest_16k.npz.  Runs on the GPU
unless ``--device cpu``.

Usage, from the repository root:

    PYTHONPATH=. python3 examples/spectral_features_torch.py [input.wav]
        [--device cuda] [--dtype float32]
"""
import argparse
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parent.parent / "tests" / "golden" / "harvest_16k.npz"


def lsd(A, B):
    return float(np.mean(np.sqrt(np.mean((20 * np.log10(A / B)) ** 2, axis=1))))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("wav", nargs="?", default=None,
                    help="input wav (default: x16 of tests/golden/harvest_16k.npz)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    from world_tpu_torch import World
    from world_tpu_torch.io.wav import read_wav

    if args.wav is None:
        g = np.load(GOLDEN)
        fs, x = int(g["fs"]), np.asarray(g["x16"], np.float64)
    else:
        fs, x = read_wav(args.wav)
    vocoder = World(device=args.device, dtype=args.dtype)
    dat = vocoder.encode(fs, x, f0_method="harvest")
    spec = np.sqrt(np.asarray(dat["spectrogram"]).T)     # (frames, bins) magnitude
    lf = vocoder.encode_lfbank(spec, fs=fs)
    print(f"log-filterbank: {lf.shape}")
    mcep = vocoder.encode_mcep(spec, n0=40, fs=fs, highhz=fs / 2)
    rec = vocoder.decode_mcep(mcep, (spec.shape[1] - 1) * 2)
    d = lsd(spec, rec)
    print(f"MCEP-40 round-trip LSD: {d:.2f} dB")
    return {"lfbank_shape": lf.shape, "mcep_shape": mcep.shape, "lsd_db": d}


if __name__ == "__main__":
    main()
