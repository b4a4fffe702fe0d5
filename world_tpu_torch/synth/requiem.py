"""Requiem synthesis: excitation + spectral filtering (port of
world_tpu/synth/requiem.py).  The velvet noise is read at explicit
per-band offsets, pulses are overlap-added in a fixed order, and all
frames are filtered through batched minimum-phase spectra.  The syntheses
take a leading batch axis, on the JAX package's static shapes: nothing is
read back to the host."""
import math
import warnings

import numpy as np
import torch

from .._backend import resolve_device, sdiv
from ..dsp.interp import interp1_extrap
from ..dsp.minphase import minimum_phase_spectrum, mirror_full
from ..dsp.ola import SLOT, slot_ola, uniform_ola
from ..dsp.scanops import compact_rows, running_sum
from ..dsp.windows import np_hanning_matlab
from ..frames import host, host_flag, uniform_frame_period_ms, upload
from ..tables import table
from .classic import default_max_pulses, grid_interp, pulse_rank_bound, sample_times


def _interp(values, temporal_positions, time_axis, frame_period_s):
    if frame_period_s is not None:
        return grid_interp(values, temporal_positions, time_axis, frame_period_s)
    return interp1_extrap(temporal_positions, values, time_axis)


def pulse_locations(temporal_positions, f0, vuv, fs: float, time_axis,
                    max_pulses: int, frame_period_s=None):
    """time_base_generation (synthesisRequiem.py:104-118) of f0 and vuv
    (..., frames): 1-based pulse sample indices (..., max_pulses), the kept
    count, the interpolated vuv and the raw pulse count.  The first
    ``max_pulses`` phase wraps are compacted in order (the JAX package's
    static form); the indices past the count are 1.  ``time_axis`` is the
    float64 axis of :func:`.classic.sample_times`; the interpolations take
    it in f0's type."""
    queries = time_axis.to(f0.dtype)
    f0_i = _interp(f0, temporal_positions, queries, frame_period_s)
    vuv_i = _interp(vuv, temporal_positions, queries, frame_period_s) > 0.5
    zero = torch.zeros((), dtype=f0_i.dtype, device=f0_i.device)
    f0_i = torch.where(vuv_i, f0_i, zero)
    f0_i = torch.where(f0_i == 0, torch.full_like(f0_i, 500.0), f0_i)
    # the running phase in float64 in every working type: over a minute it
    # passes 60,000 rad, where a float32 sum places pulses samples off
    total_phase = running_sum(sdiv(2 * math.pi * f0_i, fs).double())
    wrap = torch.remainder(total_phase, 2 * math.pi)
    mask = torch.abs(torch.diff(wrap, dim=-1)) > math.pi
    locs, rank = compact_rows(time_axis[:-1].expand(mask.shape), mask,
                              max_pulses)
    raw_count = rank[..., -1]
    count = torch.clamp(raw_count, max=max_pulses)
    pli = torch.floor(locs * fs + 0.5).to(torch.int64) + 1
    return pli, count, vuv_i, raw_count


def excitation_core(temporal_positions, f0, vuv, band_ap_db, pulse_seed,
                    noise_seed, noise_offsets, fs: int, y_length: int,
                    max_pulses: int, frame_period_s=None, max_rank: int = SLOT):
    """Excitation signal (..., y_length) and the capacity flag (...) of f0
    and vuv (..., frames) and band_ap_db (..., bands, frames); pulse_seed
    (fft, bands); noise_seed (noise_len, bands); noise_offsets (bands,) int.
    The flag is set where the pulses pass ``max_pulses`` or a slot of the
    overlap-add holds more than ``max_rank`` of them (:func:`..dsp.ola.
    slot_ola`; :func:`.classic.pulse_rank_bound` gives the bound of an f0
    range)."""
    dtype, dev = pulse_seed.dtype, pulse_seed.device
    fft_size = pulse_seed.shape[0]
    time_axis = sample_times(y_length, fs, temporal_positions[0])
    pli, count, vuv_i, raw_count = pulse_locations(
        temporal_positions, f0, vuv, float(fs), time_axis, max_pulses,
        frame_period_s)

    # band aperiodicity on the sample grid (linear in 10^(dB/10))
    ap_lin = 10.0 ** sdiv(band_ap_db, 10.0)
    interp_ap = _interp(ap_lin, temporal_positions, time_axis.to(dtype),
                        frame_period_s)                         # (..., bands, y)

    # aperiodic part: per-band looped velvet noise read from its offset
    noise_len = noise_seed.shape[0]
    off = torch.remainder(noise_offsets.to(torch.int64), noise_len)
    idx = (off[:, None] + torch.arange(y_length, device=dev)[None, :]) % noise_len
    noise = torch.gather(noise_seed.T, 1, idx)
    aperiodic = (noise * interp_ap).sum(dim=-2)

    # periodic part: (pulses, bands) weights @ (bands, fft) pulse seeds
    pulse_ids = torch.arange(max_pulses, device=dev)
    valid = pulse_ids < count[..., None]
    at_pulse = torch.clamp(pli - 1, 0, y_length - 1)
    ap_at_pulse = torch.gather(
        interp_ap, -1, at_pulse[..., None, :].expand(
            *at_pulse.shape[:-1], interp_ap.shape[-2], max_pulses))  # (..., bands, P)
    voiced = (torch.gather(vuv_i, -1, at_pulse)
              & (ap_at_pulse[..., 0, :] <= 0.999) & valid)
    nxt = torch.clamp(torch.minimum(pulse_ids + 1, count[..., None] - 1), 0,
                      max_pulses - 1)
    noise_size = torch.sqrt(torch.clamp(
        (torch.gather(pli, -1, nxt) - pli).to(dtype), min=1.0))
    weights = (1.0 - ap_at_pulse.transpose(-1, -2)) * torch.where(
        voiced, noise_size, torch.zeros((), dtype=dtype, device=dev))[..., None]
    responses = weights @ pulse_seed.T                          # (..., P, fft)
    starts = torch.where(valid, pli - fft_size // 2,
                         torch.full_like(pli, y_length + fft_size + 2))
    periodic, crowded = slot_ola(responses, starts, y_length, max_rank)
    return periodic + aperiodic, (raw_count > max_pulses) | crowded


def waveform_core(excitation, spectrogram, fs: int, fft_size: int, fps: int):
    """get_waveform (synthesisRequiem.py:74-101) for all frames at once;
    excitation (..., y_length), spectrogram (..., bins, frames)."""
    dtype, dev = excitation.dtype, excitation.device
    n_frames = spectrogram.shape[-1]
    y_len = excitation.shape[-1]
    win_len = fps * 2 - 1
    half = fps - 1
    win = table("hanning_matlab", (win_len,), lambda: np_hanning_matlab(win_len),
                dtype, dev)
    frames = torch.arange(2, n_frames - 1, device=dev)
    origins = (frames - 1) * fps - half                          # 1-based
    seg_idx = torch.clamp(origins[:, None] + torch.arange(win_len, device=dev),
                          max=y_len) - 1
    tmp = excitation[..., seg_idx] * win
    # frame i uses column i-1
    spec = spectrogram.transpose(-1, -2)[..., 1:n_frames - 2, :]
    mp = minimum_phase_spectrum(mirror_full(spec))
    resp = torch.fft.ifft(mp * torch.fft.fft(tmp, fft_size)).real
    return uniform_ola(resp, fps - half - 1, fps, y_len)


def synthesis_requiem(source_object: dict, filter_object: dict,
                      seeds_signals: dict, noise_offsets=None,
                      max_pulses: int = None, dtype=torch.float64,
                      device=None) -> torch.Tensor:
    """Waveform of a source/filter dict pair (API of
    world_tpu.synth.requiem.synthesis_requiem) on ``device`` (the GPU unless
    the CPU is asked for), on any ascending frame grid.  ``seeds_signals``
    is :func:`..synth.seeds.get_seeds_signals`' dict of arrays or
    :func:`..synth.seeds.seed_tables`' of tensors; ``noise_offsets`` is
    one velvet-noise read cursor per band (zeros when None)."""
    dev = resolve_device(device)
    as_t = lambda a: upload(np.asarray(host(a), dtype=np.float64),   # noqa: E731
                            dtype, dev)
    f0 = np.asarray(host(source_object["f0"]), dtype=np.float64)
    tp = np.asarray(host(source_object["temporal_positions"]), dtype=np.float64)
    fs = int(filter_object["fs"])
    spectrogram = as_t(filter_object["spectrogram"])
    # banks given as tensors (seeds.seed_tables) stay where they are
    seed = lambda a: (a.to(dtype=dtype, device=dev)        # noqa: E731
                      if isinstance(a, torch.Tensor) else as_t(a))
    pulse_seed = seed(seeds_signals["pulse"])
    noise_seed = seed(seeds_signals["noise"])
    if noise_offsets is None:
        noise_offsets = np.zeros(pulse_seed.shape[1], np.int64)
    offsets = torch.as_tensor(np.asarray(host(noise_offsets), np.int64), device=dev)
    y_length = len(np.arange(tp[0], tp[-1] + 1 / fs, 1.0 / fs))
    if max_pulses is None:
        max_pulses = default_max_pulses(tp, f0)
    fp_ms = uniform_frame_period_ms(tp)
    excitation, overflow = excitation_core(
        as_t(tp), as_t(f0), as_t(source_object["vuv"]),
        as_t(source_object["aperiodicity"]), pulse_seed, noise_seed, offsets,
        fs, y_length, max_pulses, None if fp_ms is None else fp_ms / 1000.0,
        pulse_rank_bound(np.max(f0, initial=0.0), fs))   # the contour is on the host
    if host_flag(overflow):
        warnings.warn(f"synthesis_requiem: pulse count exceeded max_pulses="
                      f"{max_pulses}; trailing pulses were dropped — raise "
                      f"max_pulses", RuntimeWarning, stacklevel=2)
    fft_size = (spectrogram.shape[0] - 1) * 2
    return waveform_core(excitation, spectrogram, fs, fft_size,
                         int((tp[1] - tp[0]) * fs))
