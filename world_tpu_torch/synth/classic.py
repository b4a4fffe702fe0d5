"""Classic WORLD synthesis (port of world_tpu/synth/classic.py): a pulse
train and filtered noise, overlap-added.

Pulse times come from the wrapped phase of the interpolated f0, on a
static pulse axis; every per-pulse decision (positions, shifts, noise
lengths, overlap-add starts, frame pairs, the voicing gate) is a (B, P)
tensor here.  Each pulse's periodic response (minimum-phase spectrum with a
fractional time shift) and aperiodic response (noise convolved with a
minimum-phase response), and their overlap-add in a fixed order, are
:mod:`..ops.classic_pulses`': K8 on the card, which computes the live
pulses only, and its plain version on the CPU, which computes every slot.
The synthesis takes a leading batch axis and reads nothing back to the
host, as the JAX package's static program does.  The noise is an explicit
argument, a standard-normal draw of shape (B, max_pulses, max_noise), so
that a run is reproducible: callers draw it from a ``torch.Generator`` of
their own.
"""
import math
import warnings

import numpy as np
import torch

from .._backend import resolve_device, sdiv
from ..dsp.interp import interp1_extrap
from ..dsp.ola import SLOT, rank_bound
from ..dsp.scanops import compact_rows, running_sum
from ..frames import host_flag, uniform_frame_period_ms, upload
from ..ops.classic_pulses import pulse_synthesis
from ..utils.profiling import TRACER

DEFAULT_F0 = 500.0


def grid_interp(values: torch.Tensor, temporal_positions: torch.Tensor,
                queries: torch.Tensor, frame_period_s: float) -> torch.Tensor:
    """interp1d(tp, values, fill_value='extrapolate') on the uniform frame
    grid, by index arithmetic; values (..., n)."""
    n = values.shape[-1]
    pos = sdiv(queries - temporal_positions[0], frame_period_s)
    j = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
    frac = pos - j
    y0 = values[..., j]
    y1 = values[..., j + 1]
    return y0 + (y1 - y0) * frac


def sample_times(y_length: int, fs: int, t0: torch.Tensor) -> torch.Tensor:
    """The synthesis' sample-time axis t0 + n / fs, n < y_length, in float64
    in every working type: the pulse indices are taken from it, and in
    float32 n / fs places a pulse a sample off from 256 s of 22.05 kHz audio
    on.  A stage that interpolates in the working type casts it."""
    return (sdiv(torch.arange(y_length, dtype=torch.float64, device=t0.device),
                 fs) + t0.to(torch.float64))


def _interp(values, temporal_positions, queries, frame_period_s):
    if frame_period_s is not None:
        return grid_interp(values, temporal_positions, queries, frame_period_s)
    return interp1_extrap(temporal_positions, values, queries)


def time_base(temporal_positions, f0, vuv, fs: float, time_axis,
              max_pulses: int, wrap_threshold: float = math.pi,
              frame_period_s=None):
    """Pulse times from the wrapped phase (synthesis.py:120-140) of f0 and
    vuv (B, frames), on the JAX package's static pulse axis.

    ``time_axis`` is :func:`sample_times`' float64 axis; the pulse indices
    come from it, the interpolations take it in f0's type.  The first
    ``max_pulses`` phase wraps of each row are compacted in order
    (:func:`..dsp.scanops.compact_rows`; the slots past the count read time
    0).  Returns the pulse locations (B, max_pulses) in seconds in f0's
    type, their 1-based sample indices, the fractional time shifts, the
    interpolated vuv (B, y_length) and the raw pulse count (B,), of which
    the first min(count, max_pulses) slots are kept.  f0 and vuv may also
    be one utterance (frames,).  ``wrap_threshold`` pi/2 is synthesis_a's
    detection."""
    queries = time_axis.to(f0.dtype)
    f0_i = _interp(f0, temporal_positions, queries, frame_period_s)
    vuv_i = _interp(vuv, temporal_positions, queries, frame_period_s) > 0.5
    zero = torch.zeros((), dtype=f0_i.dtype, device=f0_i.device)
    f0_i = torch.where(vuv_i, f0_i, zero)
    f0_i = torch.where(f0_i == 0, torch.full_like(f0_i, DEFAULT_F0), f0_i)
    # The phase is summed in float64 whatever the working type: over seconds
    # it reaches thousands of radians, where float32 keeps ~5e-4 rad.
    # Float64 runs are unchanged.
    total_phase = running_sum(sdiv(2 * math.pi * f0_i.to(torch.float64), fs))
    wrap = torch.remainder(total_phase, 2 * math.pi)
    mask = torch.abs(torch.diff(wrap, dim=-1)) > wrap_threshold
    n = mask.shape[-1]
    locs, rank = compact_rows(time_axis[:-1].expand(mask.shape), mask,
                              max_pulses)
    raw_count = rank[..., -1]
    pli = torch.floor(locs * fs + 0.5).to(torch.int64) + 1
    y1 = torch.gather(wrap, -1, pli - 1) - 2.0 * math.pi
    y2 = torch.gather(wrap, -1, torch.clamp(pli, max=n))
    shift = sdiv(-y1 / (y2 - y1), fs).to(f0_i.dtype)
    return locs.to(f0_i.dtype), pli, shift, vuv_i, raw_count


def frame_pair(locs, temporal_positions, dtype, frame_period_s=None):
    """Each pulse's 2-frame lerp at its location locs (B, P): the 0-based
    frame pair (floor_i, ceil_i) and the weights (a, b) of its two frames
    (synthesis.py's interp1 of the frame index), in the working type
    ``dtype``."""
    dev = locs.device
    n_frames = temporal_positions.shape[0]
    frame_ids = torch.arange(1, n_frames + 1, dtype=dtype, device=dev)
    tpi = torch.clamp(_interp(frame_ids, temporal_positions, locs,
                              frame_period_s), 1.0, float(n_frames))
    floor_i = torch.floor(tpi).to(torch.int64) - 1
    ceil_i = torch.ceil(tpi).to(torch.int64) - 1
    t1 = temporal_positions[floor_i]
    t2 = temporal_positions[ceil_i]
    xq = torch.maximum(t1, torch.minimum(t2, locs))
    same = t1 == t2
    zero = torch.zeros((), dtype=dtype, device=dev)
    b = torch.where(same, zero, (xq - t1) / torch.where(
        same, torch.ones_like(t1), t2 - t1))
    return floor_i, ceil_i, 1.0 - b, b


def synthesis_core(f0, vuv, temporal_positions, spectrogram, aperiodicity,
                   noise, fs: int, y_length: int, fft_size: int,
                   max_pulses: int, max_noise: int, noise_mode: str = "gaussian",
                   variant: str = "standard", frame_period_s=None,
                   max_rank: int = SLOT):
    """Classic synthesis (synthesis.py:21-116) of a batch of utterances on
    the JAX package's static shapes: nothing is read back to the host.

    f0 and vuv are (B, frames); spectrogram and aperiodicity (B, bins,
    frames); noise is the standard-normal draw (B, max_pulses, max_noise),
    whose rows feed the pulses in order.  One utterance may come without its
    batch axis, and its outputs then have none.  The per-pulse decisions
    are (B, max_pulses) tensors here; the responses and the overlap-add are
    :func:`..ops.classic_pulses.pulse_synthesis`' (K8 on the card, on the
    live pulses only; on the CPU every slot, the slots past the pulse count
    left out of the overlap-add).  ``noise_mode="constant"``
    uses 0.1 in the draw's place, as the golden waveform does, and takes
    noise None.  ``variant="a"`` is synthesis_a: pulses at pi/2 phase wraps,
    no fractional shift, no aperiodicity gate.  ``max_rank``: the overlap-
    add's passes (:func:`..dsp.ola.slot_ola`).  Returns (y (B, y_length),
    overflow (B,)): the pulses passed ``max_pulses`` or a slot of the
    overlap-add held more than ``max_rank``."""
    if f0.dim() == 1:
        y, overflow = synthesis_core(
            f0[None], vuv[None], temporal_positions, spectrogram[None],
            aperiodicity[None], None if noise is None else noise[None], fs,
            y_length, fft_size, max_pulses, max_noise, noise_mode, variant,
            frame_period_s, max_rank)
        return y[0], overflow[0]
    B = f0.shape[0]
    if noise_mode == "gaussian" and (noise is None or tuple(noise.shape)
                                     != (B, max_pulses, max_noise)):
        raise ValueError(f"gaussian noise_mode needs a ({B}, {max_pulses}, "
                         f"{max_noise}) standard-normal draw")
    if noise_mode not in ("gaussian", "constant"):
        raise ValueError(f"noise_mode {noise_mode!r}")
    ops = pulse_operands(f0, vuv, temporal_positions, aperiodicity, fs,
                         y_length, fft_size, max_pulses, max_noise, variant,
                         frame_period_s)
    raw_count = ops.pop("raw_count")
    y, crowded = pulse_synthesis(spectrogram, aperiodicity, noise, **ops, fs=fs,
                                 y_length=y_length, fft_size=fft_size,
                                 max_noise=max_noise, noise_mode=noise_mode,
                                 max_rank=max_rank)
    return y, (raw_count > max_pulses) | crowded


def pulse_operands(f0, vuv, temporal_positions, aperiodicity, fs: int,
                   y_length: int, fft_size: int, max_pulses: int,
                   max_noise: int, variant: str = "standard",
                   frame_period_s=None) -> dict:
    """Every per-pulse decision of :func:`synthesis_core` for f0 and vuv
    (B, frames) and aperiodicity (B, bins, frames), as (B, max_pulses)
    tensors: the frame pair ``floor_i``/``ceil_i`` and weights ``wa``/``wb``
    of each pulse's spectral lerp, its ``voiced`` gate, fractional
    ``shifts``, ``noise_sizes`` and ``n_noise``, and the overlap-add
    ``starts`` (the slots past the count parked past the output); ``count``
    (B,), the pulses kept, and ``raw_count`` (B,), the phase wraps found."""
    dtype, dev = aperiodicity.dtype, aperiodicity.device
    time_axis = sample_times(y_length, fs, temporal_positions[0])
    wrap_threshold = math.pi if variant == "standard" else math.pi / 2
    locs, pli, shifts, vuv_i, raw_count = time_base(
        temporal_positions, f0, vuv, float(fs), time_axis, max_pulses,
        wrap_threshold, frame_period_s)
    count = torch.clamp(raw_count, max=max_pulses)
    if variant == "a":
        shifts = torch.zeros_like(shifts)

    pulse_ids = torch.arange(max_pulses, device=dev)
    valid = pulse_ids < count[:, None]
    nxt = torch.clamp(torch.minimum(pulse_ids + 1, count[:, None] - 1), 0,
                      max_pulses - 1)
    noise_sizes = torch.gather(pli, -1, nxt) - pli
    n_noise = torch.clamp(torch.clamp(noise_sizes, max=max_noise), min=3)
    starts = torch.where(valid, pli - fft_size // 2,
                         torch.full_like(pli, y_length + fft_size + 2))
    floor_i, ceil_i, wa, wb = frame_pair(locs, temporal_positions, dtype,
                                         frame_period_s)
    voiced = torch.gather(vuv_i, -1, pli - 1)
    if variant == "standard":
        ap0 = aperiodicity[:, 0, :] ** 2                      # (B, frames)
        voiced = voiced & (wa * torch.gather(ap0, -1, floor_i)
                           + wb * torch.gather(ap0, -1, ceil_i) <= 0.999)
    return {"floor_i": floor_i, "ceil_i": ceil_i, "wa": wa, "wb": wb,
            "voiced": voiced, "shifts": shifts, "noise_sizes": noise_sizes,
            "n_noise": n_noise, "starts": starts, "count": count,
            "raw_count": raw_count}


def default_max_pulses(temporal_positions: np.ndarray, f0: np.ndarray) -> int:
    est = int(np.ceil((temporal_positions[-1] - temporal_positions[0])
                      * max(500.0, float(np.max(f0)) * 1.2))) + 8
    return int(2 ** np.ceil(np.log2(est)))


def max_noise_length(fs: int) -> int:
    return int(fs / 40) + 4


def synthesis(source_object: dict, filter_object: dict, noise: torch.Tensor = None,
              generator: torch.Generator = None, noise_mode: str = "gaussian",
              max_pulses: int = None, variant: str = "standard",
              dtype=torch.float64, device=None) -> torch.Tensor:
    """Waveform of a source/filter dict pair (API of
    world_tpu.synth.classic.synthesis) on ``device`` (the GPU unless the
    CPU is asked for).  The noise draw is ``noise``, or drawn from
    ``generator`` (seeded 0 on the device when None)."""
    dev = resolve_device(device)
    as_t = lambda a: upload(np.asarray(a, dtype=np.float64), dtype,   # noqa: E731
                            dev)
    f0 = np.asarray(source_object["f0"], dtype=np.float64)
    tp = np.asarray(source_object["temporal_positions"], dtype=np.float64)
    spectrogram = as_t(filter_object["spectrogram"])
    fs = int(filter_object["fs"])
    y_length = len(np.arange(tp[0], tp[-1] + 1 / fs, 1.0 / fs))
    fft_size = (spectrogram.shape[0] - 1) * 2
    if max_pulses is None:
        max_pulses = default_max_pulses(tp, f0)
    TRACER.count("synth.pulses.slots", max_pulses)
    max_noise = max_noise_length(fs)
    if noise is None and noise_mode == "gaussian":
        noise = standard_normal((max_pulses, max_noise), generator, dtype, dev)
    fp_ms = uniform_frame_period_ms(tp)
    y, overflow = synthesis_core(
        as_t(f0), as_t(source_object["vuv"]), as_t(tp), spectrogram,
        as_t(source_object["aperiodicity"]), noise, fs, y_length, fft_size,
        max_pulses, max_noise, noise_mode, variant,
        None if fp_ms is None else fp_ms / 1000.0,
        pulse_rank_bound(np.max(f0, initial=0.0), fs, variant))
    if host_flag(overflow):
        warnings.warn(f"synthesis: pulse count exceeded max_pulses={max_pulses}; "
                      f"trailing pulses were dropped — raise max_pulses",
                      RuntimeWarning, stacklevel=2)
    return y


def pulse_rank_bound(f0_max: float, fs: int, variant: str = "standard") -> int:
    """The overlap-add's passes for a contour no higher than ``f0_max`` Hz
    (500 Hz where unvoiced): :func:`..dsp.ola.rank_bound`.  Synthesis_a's
    pi/2 detection fires at every sample once the phase gains pi/2 a sample
    (f0 >= fs / 4): then every one of a slot's SLOT samples may start a
    pulse."""
    f_max = max(float(f0_max), DEFAULT_F0)
    if variant == "a" and 4 * f_max >= fs:
        return SLOT
    return rank_bound(f_max, fs)


def synthesis_a(source_object, filter_object, **kwargs) -> torch.Tensor:
    """The historical synthesis variant (synthesis_a.py:21-101)."""
    return synthesis(source_object, filter_object, variant="a", **kwargs)


def standard_normal(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    """A standard-normal draw from ``generator``, or from a generator
    seeded 0 on ``device`` when None; never from the global RNG."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)
