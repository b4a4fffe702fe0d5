"""The facade's path: ``World.encode`` (the configuration's f0 method,
classic D4C) and ``decode`` of each request at its own length, eagerly.
TF32 reaches nothing of it, so its control rounds its input to
bfloat16."""
import numpy as np

from paths._lib import classic_noise, cut_of
from reference import facade as RF
from reference.synth import classic as RC

CONTROL = "bf16"


def outputs(cfg, x32, items, dtype, device, gots=()) -> list:
    """``World.encode`` (DIO, classic D4C) and ``decode`` of each request at
    its own length, the classic synthesis' noise drawn as the program's
    ``decode(dat, key=generator)`` draws it (float32 on the card, the
    request's seed); and for each of ``gots``, ``decode`` of its own
    analysis on the same draw, in ``y_syn``."""
    fs, fp = cfg["fs"], cfg["frame_period_ms"]

    def decode(d, seed):
        tp = np.asarray(d["temporal_positions"], np.float64)
        f0 = np.asarray(d["f0"], np.float64)
        noise = classic_noise(seed, (RC.default_max_pulses(tp, f0),
                                     RC.max_noise_length(fs)), device).to(dtype)
        y = RC.synthesis(d, d, noise=noise, dtype=dtype, device=device)
        y = y.double().cpu().numpy()
        m = np.max(np.abs(y))
        return y / m if m > 1.0 else y

    out = []
    for i, (req, call, _row, *_rest) in enumerate(items):
        dat = RF.encode(fs, cut_of(x32, req).astype(np.float64), dtype, device,
                        f0_method=cfg["f0_method"], f0_floor=cfg["f0_floor"],
                        f0_ceil=cfg["f0_ceil"],
                        channels_in_octave=cfg["channels_in_octave"],
                        target_fs=cfg["target_fs"], frame_period=fp)
        o = {"f0": dat["f0"], "vuv": dat["vuv"], "sp": dat["spectrogram"].T,
             "ap": dat["aperiodicity"].T, "y": decode(dat, call.noise_seed),
             "tp": dat["temporal_positions"]}
        # each analysis' own frame times, which set its waveform's length
        o["y_syn"] = [decode({"f0": g[i]["f0"], "vuv": g[i]["vuv"], "fs": fs,
                              "temporal_positions": g[i]["tp"],
                              "spectrogram": np.asarray(g[i]["sp"]).T,
                              "aperiodicity": np.asarray(g[i]["ap"]).T},
                             call.noise_seed) for g in gots]
        out.append(o)
    return out
