"""pyworld's default chain, Harvest -> CheapTrick -> classic D4C -> classic
synthesis, frozen for the benchmark's reference from the Harvest branch of
world_tpu_torch/parallel/batch.py's classic round trip: Harvest's caps
(``max_candidates``, ``max_sections``) at their defaults, its capacity
flags or'd into ``_overflow``, and the pulse caps and the overlap-add's
passes from Harvest's ceiling.  The analysis is :mod:`.roundtrip`'s.
Everything runs eagerly as plain PyTorch."""
import functools

import numpy as np
import torch

from .f0.dio import frame_positions
from .f0.harvest import harvest_tables, smooth_zero_phase_kernel
from .roundtrip import F0_CEIL, F0_FLOOR, analyze
from .spectral.cheaptrick import default_fft_size
from .synth.classic import (default_max_pulses, max_noise_length,
                            pulse_rank_bound, standard_normal, synthesis_core)
from .tables import device_key

HARVEST_FLAGS = ("_refine_overflow", "_section_overflow")


@functools.lru_cache(maxsize=None)
def harvest_ceiling() -> float:
    """The highest f0 of a Harvest contour, from the caps alone: the F0
    ceiling (plus FixStep4's one hertz of fill), raised by the smoothing's
    gain (the sum of its kernel's magnitudes bounds any smoothed value)."""
    gain = float(np.abs(smooth_zero_phase_kernel()).sum())
    return (F0_CEIL + 1.0) * gain


def encode_classic_one(x: torch.Tensor, fs: int, frame_period: int,
                       tables: dict = None) -> dict:
    """Harvest with its caps at their defaults, then CheapTrick -> D4C, for
    rows x (B, n).  Returns f0, vuv (B, F), temporal_positions (F,),
    spectrogram and aperiodicity (B, bins, F), and Harvest's capacity flags
    (B,) ``HARVEST_FLAGS``."""
    if tables is None:
        tables = classic_tables(fs, x.dtype, x.device)
    an = analyze(x, fs, frame_period, "harvest", False, tables=tables)
    out = {"f0": an["f0"], "vuv": an["vuv"],
           "temporal_positions": an["temporal_positions"],
           "spectrogram": an["spectrogram"].transpose(1, 2),
           "aperiodicity": an["aperiodicity"].transpose(1, 2)}
    out.update({k: an[k] for k in HARVEST_FLAGS})
    return out


@functools.lru_cache(maxsize=None)
def classic_caps(sig_len: int, fs: int, frame_period: int):
    """(y_length, max_pulses, max_noise) of the round trip, bounded by
    :func:`harvest_ceiling` rather than the data: the shape of its noise
    draw."""
    n_frames = frame_positions(sig_len, fs, frame_period).shape[0]
    tp_last = (n_frames - 1) * frame_period / 1000.0
    y_length = len(np.arange(0.0, tp_last + 1.0 / fs, 1.0 / fs))
    max_pulses = default_max_pulses(np.array([0.0, tp_last]),
                                    np.array([harvest_ceiling()]))
    return y_length, max_pulses, max_noise_length(fs)


@functools.lru_cache(maxsize=None)
def classic_rank_bound(fs: int) -> int:
    """The overlap-add's passes in the round trip's classic synthesis, from
    the caps alone: its f0 is at most :func:`harvest_ceiling`."""
    return pulse_rank_bound(harvest_ceiling(), fs)


def synthesize_classic(dat: dict, noise: torch.Tensor, fs: int, sig_len: int,
                       frame_period: int):
    """Classic pulse/noise synthesis of every row of
    :func:`encode_classic_one`'s dat at once, row b from the standard-normal
    draw noise[b] of shape :func:`classic_caps`.  Returns y (B, y_length)
    and the per-row capacity flags (B,)."""
    y_length, max_pulses, max_noise = classic_caps(sig_len, fs, frame_period)
    return synthesis_core(
        dat["f0"], dat["vuv"], dat["temporal_positions"], dat["spectrogram"],
        dat["aperiodicity"], noise, fs, y_length, default_fft_size(fs),
        max_pulses, max_noise, "gaussian", "standard",
        float(frame_period) / 1000.0, classic_rank_bound(fs))


def encode_decode_classic_one(x: torch.Tensor, fs: int, frame_period: int,
                              noise: torch.Tensor = None,
                              generator: torch.Generator = None,
                              tables: dict = None) -> dict:
    """The round trip for rows x (B, n): :func:`encode_classic_one`, then
    :func:`synthesize_classic`.  ``noise`` is the standard-normal draw
    (B, max_pulses, max_noise) of :func:`classic_caps`; when None it is
    drawn from ``generator`` (seeded 0 on x's device when None).  Returns
    the encode outputs, y (B, y_length) and the per-row capacity flag
    _overflow (B,): the synthesis' flag, or'd with Harvest's."""
    B, sig_len = x.shape
    dat = encode_classic_one(x, fs, frame_period, tables)
    if noise is None:
        _, max_pulses, max_noise = classic_caps(sig_len, fs, frame_period)
        noise = standard_normal((B, max_pulses, max_noise), generator, x.dtype,
                                x.device)
    y, overflow = synthesize_classic(dat, noise, fs, sig_len, frame_period)
    for k in HARVEST_FLAGS:
        overflow = overflow | dat[k]
    return dict(dat, y=y, _overflow=overflow)


def classic_tables(fs: int, dtype: torch.dtype, device) -> dict:
    """Harvest's static tables at the f0 range 71-800 Hz, built once per
    (fs, type, device) and kept (:mod:`.tables`)."""
    return harvest_tables(fs, F0_FLOOR, F0_CEIL, dtype, device_key(device))
