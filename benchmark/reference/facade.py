"""world_tpu_torch.api.World's encode and decode, frozen for the benchmark's
reference: the analysis of one utterance through :func:`.roundtrip.analyze`
in the facade's output layout, and the synthesis with the facade's
rescaling.  Only the methods the benchmark's cells call are copied."""
import numpy as np
import torch

from .f0.harvest import default_max_sections, warn_capacity
from .frames import host
from .roundtrip import analyze
from .synth.classic import synthesis
from .synth.requiem import synthesis_requiem
from .synth.seeds import seed_tables


def encode(fs, x, dtype, device, f0_method="harvest", f0_floor=71,
           f0_ceil=800, channels_in_octave=2, target_fs=4000, frame_period=5,
           allowed_range=0.1, fft_size=None, is_requiem=False) -> dict:
    """``World(device, dtype).encode(fs, x, ...)``."""
    fs = int(fs)
    xt = torch.tensor(np.asarray(x), dtype=dtype, device=device)[None]
    an = analyze(xt, fs, frame_period, f0_method, is_requiem,
                 fft_size=fft_size, f0_floor=float(f0_floor),
                 f0_ceil=float(f0_ceil),
                 channels_in_octave=int(channels_in_octave),
                 target_fs=int(target_fs), allowed_range=float(allowed_range))
    if f0_method == "harvest":
        warn_capacity(bool(an["_refine_overflow"][0]),
                      bool(an["_section_overflow"][0]),
                      default_max_sections(xt.shape[1], fs))
    return {
        "temporal_positions": host(an["temporal_positions"]),
        "vuv": host(an["vuv"][0]),
        "fs": fs,
        "f0": host(an["f0"][0]),
        "aperiodicity": host(an["aperiodicity"][0].T),
        "ps spectrogram": host(an["ps_spectrogram"][0].T),
        "spectrogram": host(an["spectrogram"][0].T),
        "is_requiem": bool(is_requiem),
    }


def decode(dat, dtype, device, key=None, seed=0, noise_offsets=None) -> np.ndarray:
    """``World(device, dtype).decode(dat, key, seed, noise_offsets)["out"]``:
    classic synthesis draws its noise from ``key``, Requiem synthesis takes
    the seed bank of ``seed``; a waveform past full scale is rescaled."""
    if dat.get("is_requiem"):
        y = synthesis_requiem(dat, dat, seed_tables(int(dat["fs"]), seed, dtype,
                                                    device),
                              noise_offsets=noise_offsets, dtype=dtype,
                              device=device)
    else:
        y = synthesis(dat, dat, generator=key, dtype=dtype, device=device)
    y = host(y)
    m = np.max(np.abs(y))
    return y / m if m > 1.0 else y
