"""The round trips of world_tpu/parallel/batch.py, with an explicit leading
batch axis of equal-length utterances:

  * Harvest -> CheapTrick -> D4C-Requiem -> Requiem synthesis
    (``_encode_decode_one``);
  * DIO -> StoneMask, or Harvest, -> CheapTrick -> D4C -> classic
    synthesis (``_encode_classic_one``, ``_encode_decode_classic_one``);
  * the first of these for a batch (``batch_encode_decode``) and for a
    ragged batch in length buckets (``batch_encode_decode_ragged``), on one
    device or with the rows sharded over a list of devices;
  * CheapTrick with its frames sharded over a list of devices
    (``frame_sharded_cheaptrick``).

Several devices are driven by one process, one worker thread per device
(what a ``jax.sharding.Mesh`` in one controller is).  Utterances and frames
are independent, so the shards exchange nothing; the results are gathered on
the first device.

On the card, ``HarvestRequiem``, ``DioClassic``, ``HarvestClassic`` and each
device's call of ``batch_encode_decode`` (so each bucket of
``batch_encode_decode_ragged``) replay one CUDA graph per static signature
from its second call on
(:mod:`.graphs`), what ``jax.jit`` is to ``_encode_decode_one`` and
``_encode_decode_classic_one``; a signature's first call, and every call on
the CPU, runs the same static code eagerly.  ``batch_encode_decode``'s
graphs are held in ``BATCH_GRAPHS`` (``BATCH_GRAPHS.clear()`` frees them); a
module holds its own.  ``DioClassic`` and ``HarvestClassic`` return their
outputs, and ``batch_encode_decode_ragged`` its arrays, on the host, copied
from the card into pinned memory (:func:`.graphs.copy_back`);
``HarvestRequiem`` and ``batch_encode_decode`` return theirs on the device.
"""
import functools
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch import nn

from .._backend import resolve_device
from ..aperiodicity import d4c as D4C
from ..aperiodicity.common import d4c_fft_size
from ..aperiodicity.d4c_requiem import d4c_requiem_core, n_bands_ap, requiem_fft_size
from ..f0.dio import dio_core, dio_tables, frame_positions
from ..dsp.ola import SLOT
from ..f0.harvest import (default_max_candidates, default_max_sections,
                          harvest_core, harvest_tables,
                          smooth_zero_phase_kernel)
from ..f0.stonemask import max_half_window, stonemask_core, table_size
from ..frames import host
from ..f0.swipe import swipe_core, swipe_tables
from ..ops.refine_dft import dft_table
from ..spectral.cheaptrick import cheaptrick_core, default_fft_size
from ..synth.classic import (default_max_pulses, max_noise_length,
                             pulse_rank_bound, standard_normal, synthesis_core)
from ..synth.requiem import excitation_core, waveform_core
from ..synth.seeds import seed_tables
from ..tables import cached, device_key
from ..utils.profiling import TRACER
from .graphs import GraphCache, copy_back

F0_FLOOR, F0_CEIL = 71.0, 800.0
SWIPE_DT = 0.005


def frame_period_of(f0_method: str, frame_period: float) -> float:
    """The frame period in ms of :func:`f0_contour`'s grid."""
    return SWIPE_DT * 1000 if f0_method == "swipe" else frame_period


def floor_of_fft_size(fs: int, fft_size: int) -> float:
    """The lowest f0 CheapTrick's window of ``fft_size`` samples resolves:
    an explicit fft_size sets the F0 search's floor to it."""
    return 3.0 * fs / fft_size


def output_length(signal_length: int, fs: int, frame_period: int) -> int:
    n_frames = int(1000 * signal_length / fs / frame_period + 1)
    return int(np.floor((n_frames - 1) * frame_period / 1000 * fs)) + 1


def stonemask_refine(x: torch.Tensor, fs: int, src: dict,
                     f0_floor: float = F0_FLOOR, tables: dict = None) -> dict:
    """DIO's contour src refined by StoneMask.  ``tables``:
    :func:`classic_tables`' dict (the DFT table is built when None)."""
    table = None if tables is None else (tables["stonemask_cos"],
                                         tables["stonemask_sin"])
    f0 = stonemask_core(x, fs, src["temporal_positions"], src["f0"],
                        max_half_window(fs, f0_floor), table)
    return {"f0": f0, "vuv": src["vuv"],
            "temporal_positions": src["temporal_positions"]}


def f0_contour(x: torch.Tensor, fs: int, frame_period: float,
               f0_method: str = "harvest", f0_floor: float = F0_FLOOR,
               f0_ceil: float = F0_CEIL, channels_in_octave: int = 2,
               target_fs: int = 4000, allowed_range: float = 0.1,
               max_candidates: int = None, max_sections: int = None,
               tables: dict = None) -> dict:
    """f0 and vuv (B, F) and temporal_positions (F,) of rows x (B, n): by
    Harvest, which adds its capacity flags _refine_overflow and
    _section_overflow (B,), by DIO refined by StoneMask, or by SWIPE' with
    pitch-strength threshold 0.3 and no refinement (always on the 5 ms
    grid, whatever ``frame_period``, as in world_tpu.World).  ``tables``
    holds the method's static tables (built when None)."""
    fp_ms = float(frame_period)
    if f0_method == "dio":
        src = dio_core(x, fs, f0_floor, f0_ceil, channels_in_octave, target_fs,
                       fp_ms, allowed_range, tables=tables)
        return stonemask_refine(x, fs, src, f0_floor, tables)
    if f0_method == "harvest":
        if max_candidates is None:
            max_candidates = default_max_candidates(f0_floor, f0_ceil)
        if max_sections is None:
            max_sections = default_max_sections(x.shape[1], fs)
        return harvest_core(x, fs, f0_floor, f0_ceil, fp_ms, max_candidates,
                            max_sections, tables=tables)
    if f0_method == "swipe":
        return swipe_core(x, fs, (f0_floor, f0_ceil), SWIPE_DT, 0.3, tables)
    raise ValueError(f"unknown f0_method {f0_method!r}")


def spectral_envelope(x: torch.Tensor, fs: int, src: dict,
                      frame_period: float, fft_size: int = None):
    """CheapTrick of rows x (B, n) on the contour src, unvoiced frames
    analysed at 500 Hz, with ``fft_size`` bins (the default size of fs when
    None).  Returns the envelope and the power spectrum (B, F, bins) and the
    f0 D4C takes (B, F): CheapTrick's effective f0, zeroed where unvoiced."""
    f0, vuv = src["f0"], src["vuv"]
    f0_ct = torch.where(vuv == 0, torch.full_like(f0, 500.0), f0)
    env, ps_spec, f0_eff = cheaptrick_core(
        x, fs, f0_ct, default_fft_size(fs) if fft_size is None else int(fft_size),
        -0.15, float(frame_period))
    return env, ps_spec, torch.where(vuv == 0, torch.zeros_like(f0_eff), f0_eff)


def d4c_aperiodicity(x: torch.Tensor, fs: int, f0_d4c: torch.Tensor,
                 temporal_positions: torch.Tensor, frame_period: float,
                 is_requiem: bool, fft_size: int = None) -> torch.Tensor:
    """D4C-Requiem's band aperiodicity in dB (B, F, n_ap+2), or classic
    D4C's full-resolution aperiodicity as linear amplitude (B, F, bins).
    An explicit ``fft_size`` is D4C-Requiem's own DFT size and the size of
    the spectrum classic D4C interpolates onto."""
    fp_ms = float(frame_period)
    if is_requiem:
        return d4c_requiem_core(
            x, fs, f0_d4c, temporal_positions,
            requiem_fft_size(fs) if fft_size is None else int(fft_size), 0.85,
            3000.0, n_bands_ap(fs), fp_ms)
    return D4C.d4c_core(
        x, fs, f0_d4c, temporal_positions, d4c_fft_size(fs),
        default_fft_size(fs) if fft_size is None else int(fft_size), 0.85,
        D4C.frequency_interval(fs), D4C.n_bands(fs), fp_ms)[0]


def analyze_contour(x: torch.Tensor, fs: int, src: dict, frame_period: float,
                    is_requiem: bool, fft_size: int = None) -> dict:
    """CheapTrick, then D4C-Requiem or classic D4C, of rows x (B, n) on the
    contour src of :func:`f0_contour`, at ``fft_size`` (each stage's default
    when None).

    Returns src with f0 zeroed where unvoiced, spectrogram and
    ps_spectrogram (B, F, bins) and aperiodicity (:func:`d4c_aperiodicity`)."""
    env, ps_spec, f0_d4c = spectral_envelope(x, fs, src, frame_period, fft_size)
    TRACER.stamp("envelope", x.device)
    ap = d4c_aperiodicity(x, fs, f0_d4c, src["temporal_positions"],
                          frame_period, is_requiem, fft_size)
    TRACER.stamp("aperiodicity", x.device)
    return dict(src, f0=f0_d4c, spectrogram=env, ps_spectrogram=ps_spec,
                aperiodicity=ap)


def analyze(x: torch.Tensor, fs: int, frame_period: float,
            f0_method: str = "harvest", is_requiem: bool = True,
            tables: dict = None, fft_size: int = None, **f0_options) -> dict:
    """The analysis of rows x (B, n): :func:`f0_contour` (``f0_options``
    go to it), then :func:`analyze_contour`.  An explicit ``fft_size`` also
    sets the F0 search's floor, 3 fs / fft_size, before the F0 estimation
    (world_tpu.World.encode).  The stages' boundaries are the tracer's stage
    stamps (:meth:`..utils.profiling.Tracer.stamp`)."""
    if fft_size is not None:
        f0_options["f0_floor"] = floor_of_fft_size(fs, fft_size)
    TRACER.stamp("start", x.device)
    src = f0_contour(x, fs, frame_period, f0_method, tables=tables,
                     **f0_options)
    TRACER.stamp("f0", x.device)
    return analyze_contour(x, fs, src, frame_period_of(f0_method, frame_period),
                           is_requiem, fft_size)


@functools.lru_cache(maxsize=None)
def harvest_ceiling() -> float:
    """The highest f0 of a Harvest contour, from the caps alone: the F0
    ceiling (plus FixStep4's one hertz of fill), raised by the smoothing's
    gain (the sum of its kernel's magnitudes bounds any smoothed value)."""
    gain = float(np.abs(smooth_zero_phase_kernel()).sum())
    return (F0_CEIL + 1.0) * gain


@functools.lru_cache(maxsize=None)
def round_trip_rank_bound(fs: int) -> int:
    """The overlap-add's passes in the round trip's Requiem synthesis
    (:func:`..synth.classic.pulse_rank_bound`), from the caps alone: its f0 is
    at most :func:`harvest_ceiling`."""
    return pulse_rank_bound(harvest_ceiling(), fs)


def synthesize(temporal_positions, f0, vuv, band_ap_db, spectrogram,
               pulse_seed, noise_seed, noise_offsets, fs: int, y_length: int,
               max_pulses: int, fps: int, frame_period_s=None,
               max_rank: int = SLOT):
    """Requiem synthesis of f0 and vuv (..., frames), band_ap_db
    (..., bands, frames) and spectrogram (..., bins, frames).  Returns
    (y (..., y_length), capacity flag (...)); ``max_rank`` as in
    :func:`..synth.requiem.excitation_core`."""
    excitation, overflow = excitation_core(
        temporal_positions, f0, vuv, band_ap_db, pulse_seed, noise_seed,
        noise_offsets, fs, y_length, max_pulses, frame_period_s, max_rank)
    fft_size = (spectrogram.shape[-2] - 1) * 2
    return waveform_core(excitation, spectrogram, fs, fft_size, fps), overflow


def encode_decode_one(x: torch.Tensor, pulse_seed: torch.Tensor,
                      noise_seed: torch.Tensor, fs: int, frame_period: int,
                      max_pulses: int, max_candidates: int, max_sections: int,
                      noise_offsets: torch.Tensor = None,
                      tables: dict = None) -> dict:
    """Full round-trip for rows x (B, n).  Returns f0, vuv (B, F),
    spectrogram (B, F, bins), band_aperiodicity (B, F, n_ap+2), y
    (B, y_length) and the per-row capacity flag _overflow (B,), the or of
    _refine_overflow and _section_overflow (Harvest's) and _pulse_overflow
    (more pulses than max_pulses, or a pulse past the overlap-add's rank
    bound).

    The JAX package's ``_encode_decode_one`` on its static shapes: every
    stage runs on the whole batch, sized by the caps, and nothing is read
    back to the host, so that a CUDA graph can capture the call
    (:class:`GraphCache`)."""
    B, sig_len = x.shape
    an = analyze(x, fs, frame_period, "harvest", True, tables=tables,
                 max_candidates=max_candidates, max_sections=max_sections)
    if noise_offsets is None:
        noise_offsets = torch.zeros(pulse_seed.shape[1], dtype=torch.int64,
                                    device=x.device)
    y_length = output_length(sig_len, fs, frame_period)
    fps = int(frame_period / 1000 * fs)
    y, pulse_overflow = synthesize(
        an["temporal_positions"], an["f0"], an["vuv"],
        an["aperiodicity"].transpose(-1, -2), an["spectrogram"].transpose(-1, -2),
        pulse_seed, noise_seed, noise_offsets, fs, y_length, max_pulses, fps,
        float(frame_period) / 1000.0, round_trip_rank_bound(fs))
    TRACER.stamp("synthesis", x.device)
    return {"f0": an["f0"], "vuv": an["vuv"], "spectrogram": an["spectrogram"],
            "band_aperiodicity": an["aperiodicity"], "y": y,
            "_overflow": (an["_refine_overflow"] | an["_section_overflow"]
                          | pulse_overflow),
            "_refine_overflow": an["_refine_overflow"],
            "_section_overflow": an["_section_overflow"],
            "_pulse_overflow": pulse_overflow}


HARVEST_FLAGS = ("_refine_overflow", "_section_overflow")


def encode_classic_one(x: torch.Tensor, fs: int, frame_period: int,
                       tables: dict = None, f0_method: str = "dio") -> dict:
    """DIO -> StoneMask (the reference's main.py:126-130), or Harvest with
    its caps at their defaults, then CheapTrick -> D4C (main.py:138-146) for
    rows x (B, n).  Returns f0, vuv (B, F), temporal_positions (F,),
    spectrogram and aperiodicity (B, bins, F), and with Harvest its capacity
    flags (B,) ``HARVEST_FLAGS``.  ``tables``: :func:`classic_tables`' dict
    of the method (built when None)."""
    if tables is None:
        tables = classic_tables(fs, x.dtype, x.device, f0_method)
    an = analyze(x, fs, frame_period, f0_method, False, tables=tables)
    out = {"f0": an["f0"], "vuv": an["vuv"],
           "temporal_positions": an["temporal_positions"],
           "spectrogram": an["spectrogram"].transpose(1, 2),
           "aperiodicity": an["aperiodicity"].transpose(1, 2)}
    out.update({k: an[k] for k in HARVEST_FLAGS if k in an})
    return out


def classic_ceiling(f0_method: str = "dio") -> float:
    """The highest f0 of the classic round trip's contour, from the caps
    alone: StoneMask's 1.2 times the ceiling DIO keeps its candidates under,
    or :func:`harvest_ceiling` (500 Hz where unvoiced, in either)."""
    return F0_CEIL * 1.2 if f0_method == "dio" else harvest_ceiling()


@functools.lru_cache(maxsize=None)
def classic_caps(sig_len: int, fs: int, frame_period: int,
                 f0_method: str = "dio"):
    """(y_length, max_pulses, max_noise) of the classic round trip, bounded
    by the f0 method's ceiling rather than the data: the shape of its noise
    draw.  ``default_max_pulses`` reckons with 1.2 times the f0 it is given:
    DIO's ceiling (DIO keeps no candidate above it; the 1.2 is StoneMask's
    room), or :func:`harvest_ceiling`."""
    n_frames = frame_positions(sig_len, fs, frame_period).shape[0]
    tp_last = (n_frames - 1) * frame_period / 1000.0
    y_length = len(np.arange(0.0, tp_last + 1.0 / fs, 1.0 / fs))
    top = F0_CEIL if f0_method == "dio" else harvest_ceiling()
    max_pulses = default_max_pulses(np.array([0.0, tp_last]), np.array([top]))
    return y_length, max_pulses, max_noise_length(fs)


@functools.lru_cache(maxsize=None)
def classic_rank_bound(fs: int, f0_method: str = "dio") -> int:
    """The overlap-add's passes in the round trip's classic synthesis, from
    the caps alone: its f0 is at most :func:`classic_ceiling`."""
    return pulse_rank_bound(classic_ceiling(f0_method), fs)


def synthesize_classic(dat: dict, noise: torch.Tensor, fs: int, sig_len: int,
                       frame_period: int, f0_method: str = "dio"):
    """Classic pulse/noise synthesis (synthesis.py:21-82) of every row of
    :func:`encode_classic_one`'s dat at once, row b from the standard-normal
    draw noise[b] of shape :func:`classic_caps` of the same f0 method.
    Returns y (B, y_length) and the per-row capacity flags (B,)."""
    y_length, max_pulses, max_noise = classic_caps(sig_len, fs, frame_period,
                                                   f0_method)
    return synthesis_core(
        dat["f0"], dat["vuv"], dat["temporal_positions"], dat["spectrogram"],
        dat["aperiodicity"], noise, fs, y_length, default_fft_size(fs),
        max_pulses, max_noise, "gaussian", "standard",
        float(frame_period) / 1000.0, classic_rank_bound(fs, f0_method))


def encode_decode_classic_one(x: torch.Tensor, fs: int, frame_period: int,
                              noise: torch.Tensor = None,
                              generator: torch.Generator = None,
                              tables: dict = None,
                              f0_method: str = "dio") -> dict:
    """The classic round trip for rows x (B, n): :func:`encode_classic_one`,
    then :func:`synthesize_classic`, by ``f0_method`` (DIO and StoneMask,
    or Harvest).

    ``noise`` is the standard-normal draw (B, max_pulses, max_noise) of
    :func:`classic_caps`; when None it is drawn from ``generator`` (seeded
    0 on x's device when None).  Returns the encode outputs, y
    (B, y_length) and the per-row capacity flag _overflow (B,): the
    synthesis' flag, or'd with Harvest's.

    The JAX package's ``_encode_decode_classic_one`` on its static shapes:
    given its noise, nothing on the round trip is read back to the host, so
    that a CUDA graph can capture it (:class:`DioClassic`,
    :class:`HarvestClassic`)."""
    B, sig_len = x.shape
    dat = encode_classic_one(x, fs, frame_period, tables, f0_method)
    if noise is None:
        _, max_pulses, max_noise = classic_caps(sig_len, fs, frame_period,
                                                f0_method)
        noise = standard_normal((B, max_pulses, max_noise), generator, x.dtype,
                                x.device)
    y, overflow = synthesize_classic(dat, noise, fs, sig_len, frame_period,
                                     f0_method)
    TRACER.stamp("synthesis", x.device)
    for k in HARVEST_FLAGS:
        if k in dat:
            overflow = overflow | dat[k]
    return dict(dat, y=y, _overflow=overflow)


def classic_tables(fs: int, dtype: torch.dtype, device,
                   f0_method: str = "dio") -> dict:
    """The classic round trip's static tables for its f0 method: DIO's band
    bank, its offsets and its decimator's impulse response, and StoneMask's
    DFT table; or Harvest's (:data:`HARVEST_TABLE_KEYS`).  Built once per
    (fs, method, type, device) and kept (:mod:`..tables`).  Raises for a
    method the classic round trip does not take."""
    device = device_key(device)
    if f0_method == "harvest":
        return harvest_tables(fs, F0_FLOOR, F0_CEIL, dtype, device)
    if f0_method != "dio":
        raise ValueError(f"the classic round trip takes f0_method 'dio' or "
                         f"'harvest', not {f0_method!r}")

    def build():
        tables = dio_tables(fs, F0_FLOOR, F0_CEIL, 2, 4000, dtype, device)
        cos_tab, sin_tab = dft_table(table_size(max_half_window(fs, F0_FLOOR)),
                                     dtype, device)
        tables.update(stonemask_cos=cos_tab, stonemask_sin=sin_tab)
        return tables

    return dict(cached(("classic_tables", int(fs), dtype, device), build))


HARVEST_TABLE_KEYS = ("band_bank", "band_bias", "decimator_ir", "refine_cos",
                      "refine_sin", "smooth_kernel")


def harvest_requiem_tables(fs: int, seed: int, dtype: torch.dtype, device) -> dict:
    """The Harvest/Requiem round trip's static tables at the default f0
    range: Harvest's (HARVEST_TABLE_KEYS) and the Requiem seed banks
    pulse_seed and noise_seed of ``seed``.  Built once per (fs, seed, type,
    device) and kept (:mod:`..tables`)."""
    device = device_key(device)

    def build():
        tables = harvest_tables(fs, F0_FLOOR, F0_CEIL, dtype, device)
        for name, bank in seed_tables(fs, seed, dtype, device).items():
            tables[f"{name}_seed"] = bank
        return tables

    return dict(cached(("harvest_requiem_tables", int(fs), int(seed), dtype,
                        device), build))


def default_batch_max_pulses(n_samples: int, fs: int) -> int:
    return int(2 ** np.ceil(np.log2(n_samples / fs * 1000 + 8)))


def make_devices(devices=None) -> list:
    """The list of devices a sharded call takes (the counterpart of
    world_tpu.parallel.batch.make_mesh): every CUDA device when None, else
    the given device or devices.  A device may be named more than once; each
    mention gets a shard and a worker thread."""
    if devices is None:
        resolve_device(None)                  # raises without a GPU
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        return [torch.device(devices)]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("an empty list of devices")
    return devices


def _device_list(devices) -> list:
    """``devices`` of a batch call as a list: None is the GPU, one device."""
    return [resolve_device(None)] if devices is None else make_devices(devices)


def _on_devices(fn, devices: list, shards: list) -> list:
    """[fn(device, shard)] for each device and its shard, one worker thread
    per device, each under its own device (the current stream a kernel is
    launched on belongs to the thread and the device).  A worker's exception
    is raised here.  A worker waits for its stream's work before it returns:
    the caller reads the outputs on streams of its own, and nothing else
    orders them after the worker's kernels."""
    def work(dev, shard):
        if dev.type != "cuda":
            return fn(dev, shard)
        with torch.cuda.device(dev):
            out = fn(dev, shard)
            if len(devices) > 1:
                torch.cuda.current_stream(dev).synchronize()
            return out

    if len(devices) == 1:
        return [work(devices[0], shards[0])]
    with ThreadPoolExecutor(max_workers=len(devices)) as pool:
        return list(pool.map(work, devices, shards))


def batch_encode_decode(xs, fs: int, devices=None, frame_period: int = 5,
                        seed: int = 0, max_pulses: int = None,
                        max_candidates: int = None, max_sections: int = None,
                        check_capacity: bool = True, dtype=torch.float32,
                        tables=None) -> dict:
    """The Harvest/Requiem round trip of a (batch, n_samples) utterance
    batch xs (a tensor or an array), as one rectangular call on each device.
    ``devices``: None for the GPU, a device, or a list of devices
    (:func:`make_devices`): each device gets a contiguous block of rows (the
    rows are padded with zero rows to a multiple of the number of devices,
    and the padding is stripped again) and runs the one-device program on
    it, so a shard's rows are those of a one-device call on the same rows.
    Returns :func:`encode_decode_one`'s dict of tensors, on the first
    device.

    On a CUDA device the call replays the CUDA graph of its signature
    (run eagerly on its first call, captured on its second; held in
    :data:`BATCH_GRAPHS`).  The static table caps
    default to the sizes the single-utterance API uses.  ``check_capacity`` reads the per-utterance overflow flags once
    after the batch and raises the RuntimeWarning of ``harvest()`` and
    ``decode()``.  ``tables``: :func:`harvest_requiem_tables`' dict for fs
    and ``seed``, or a list of them, one per device (built when None)."""
    devs = _device_list(devices)
    fs = int(fs)
    with TRACER.span("world.batch.encode_decode", device=devs[0], fs=fs):
        xs = (xs.to(dtype=dtype) if isinstance(xs, torch.Tensor)
              else torch.tensor(np.asarray(xs), dtype=dtype))
        if tables is None:
            tables = [harvest_requiem_tables(fs, seed, dtype, d) for d in devs]
        elif isinstance(tables, dict):
            tables = [tables]
        if len(tables) != len(devs):
            raise ValueError(f"{len(tables)} table dicts for {len(devs)} devices")
        if max_pulses is None:
            max_pulses = default_batch_max_pulses(xs.shape[1], fs)
        if max_candidates is None:
            max_candidates = default_max_candidates(F0_FLOOR, F0_CEIL)
        if max_sections is None:
            max_sections = default_max_sections(xs.shape[1], fs)
        n_rows = xs.shape[0]
        per_dev = -(-n_rows // len(devs))
        if per_dev * len(devs) != n_rows:
            xs = torch.cat([xs, xs.new_zeros((per_dev * len(devs) - n_rows,
                                              xs.shape[1]))])
        TRACER.count("samples.computed", xs.shape[0] * xs.shape[1])

        caps = (int(frame_period), int(max_pulses), int(max_candidates),
                int(max_sections))

        def shard(dev, k):
            t = tables[k]
            rows = xs[k * per_dev:(k + 1) * per_dev]

            def run(x):
                return encode_decode_one(
                    x, t["pulse_seed"], t["noise_seed"], fs, *caps,
                    tables={name: t[name] for name in HARVEST_TABLE_KEYS})

            if not replays(dev):
                return run(rows.to(dev))
            key = (device_key(dev), tuple(rows.shape), rows.dtype, fs, caps,
                   table_identity(t))
            return BATCH_GRAPHS.run(key, run, (rows,), dev)

        outs = _on_devices(shard, devs, list(range(len(devs))))
        out = outs[0] if len(outs) == 1 else {
            k: torch.cat([o[k].to(devs[0]) for o in outs])[:n_rows] for k in outs[0]}
        if check_capacity:
            with TRACER.span("world.batch.overflow"):
                _warn_batch_capacity(host(out["_overflow"]), max_sections,
                                     max_pulses)
        return out


# batch_encode_decode's graphs, one per (device, rows, length, type, caps,
# tables); a ragged batch makes one signature per bucket.  ``clear()``
# frees their pools.
BATCH_GRAPHS = GraphCache()


def graph_rows(n_rows: int) -> int:
    """The rows a ragged bucket of ``n_rows`` utterances is padded to on
    the card: the next power of two, so that a stream of calls whose
    buckets change their rows makes few signatures (:mod:`.graphs`)."""
    return 1 << max(0, n_rows - 1).bit_length()


def replays(device: torch.device) -> bool:
    """Whether calls on ``device`` go through a :class:`GraphCache`: on the
    card; on the CPU the static code runs eagerly."""
    return device.type == "cuda"


def table_identity(tables: dict) -> tuple:
    """A table dict's identity in a graph's key: each tensor's storage, so
    that a graph is never replayed on tables other than its own (it reads
    them by address)."""
    return tuple((name, t.data_ptr(), tuple(t.shape), t.dtype)
                 for name, t in sorted(tables.items()))


def bucket_lengths(lens, fs: int, bucket_quantum_s: float) -> dict:
    """{padded length: indices of the utterances it holds}, in ascending
    length: each utterance is padded up to the next multiple of
    ``bucket_quantum_s`` seconds."""
    quantum = max(1, int(round(bucket_quantum_s * fs)))
    buckets = {}
    for i, n in enumerate(lens):
        buckets.setdefault(max(quantum, -(-n // quantum) * quantum), []).append(i)
    return dict(sorted(buckets.items()))


def batch_encode_decode_ragged(xs, fs: int, devices=None, frame_period: int = 5,
                               seed: int = 0, bucket_quantum_s: float = 1.0,
                               check_capacity: bool = True,
                               dtype=torch.float32) -> list:
    """The Harvest/Requiem round trip of a ragged batch: utterances of
    unequal lengths, as a server gets them.

    Utterances are grouped into length buckets (:func:`bucket_lengths`),
    each bucket runs through :func:`batch_encode_decode` as one rectangular
    call (sharded over ``devices`` when they are several), in ascending
    length, and the outputs are stripped back to each utterance's own frames
    and samples.  The static tables are built once per device and shared by
    all buckets.

    Each utterance is analysed as if zero-padded to its bucket's length; the
    zero tail analyses as unvoiced.  Within a bucket a row takes the
    decisions of a single-utterance call at the same padded length.  On the
    card a bucket's rows are padded with zero rows to :func:`graph_rows`,
    whose outputs are dropped: the rows are independent.

    Returns a list of per-utterance dicts of numpy arrays (f0, vuv,
    spectrogram, band_aperiodicity, y), in input order."""
    devs = _device_list(devices)
    fs, fp = int(fs), int(frame_period)
    with TRACER.span("world.batch.ragged", device=devs[0], fs=fs):
        np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
        xs = [np.asarray(host(x), np_dtype) for x in xs]
        lens = [int(x.shape[0]) for x in xs]
        TRACER.count("samples.true", sum(lens))
        tables = [harvest_requiem_tables(fs, seed, dtype, d) for d in devs]
        on_card = any(d.type == "cuda" for d in devs)
        results = [None] * len(xs)
        for L, idxs in bucket_lengths(lens, fs, bucket_quantum_s).items():
            with TRACER.span("world.batch.bucket", length=L, rows=len(idxs)):
                with TRACER.span("world.batch.pad"):
                    n_rows = graph_rows(len(idxs)) if on_card else len(idxs)
                    xb = np.zeros((n_rows, L), np_dtype)
                    for r, i in enumerate(idxs):
                        xb[r, :lens[i]] = xs[i]
                out = batch_encode_decode(xb, fs, devices=devs, frame_period=fp,
                                          seed=seed, check_capacity=check_capacity,
                                          dtype=dtype, tables=tables)
                out = copy_back({k: out[k] for k in (
                    "f0", "vuv", "spectrogram", "band_aperiodicity", "y")})
                out = {k: v.numpy() for k, v in out.items()}
                with TRACER.span("world.batch.strip"):
                    for r, i in enumerate(idxs):
                        nf = int(1000 * lens[i] / fs / fp + 1)
                        y_len = output_length(lens[i], fs, fp)
                        results[i] = {k: (v[r][:y_len] if k == "y" else v[r][:nf])
                                      for k, v in out.items()}
        return results


def _warn_batch_capacity(overflow, max_sections, max_pulses):
    """Surface per-utterance static-table saturation: the tables are static
    and must never truncate silently."""
    overflow = np.asarray(overflow)
    if overflow.any():
        idx = np.flatnonzero(overflow)
        warnings.warn(
            f"batch_encode_decode: static table capacity "
            f"(max_sections={max_sections}, refinement slots, or "
            f"max_pulses={max_pulses}) saturated for utterance(s) "
            f"{idx.tolist()}; results for those rows may degrade — "
            f"raise the caps", RuntimeWarning, stacklevel=3)


def frame_sharded_cheaptrick(x, f0, vuv, temporal_positions, fs: int, devices,
                             fft_size: int = None):
    """CheapTrick of one utterance x (n,) with its frames sharded over
    ``devices`` (:func:`make_devices`): the frames are padded to a multiple
    of the number of devices with frames of f0 500 Hz at time 0, each device
    analyses its block of frames against its own copy of the signal, and
    the envelope is gathered on the first device.

    Returns (envelope (n_frames, fft_size // 2 + 1), total_energy): the sum
    of the envelope over every shard, the padding frames included, as the
    JAX function's ``psum`` over its shards gives it."""
    devs = make_devices(devices)
    fs = int(fs)
    if fft_size is None:
        fft_size = default_fft_size(fs)
    x = torch.as_tensor(x)
    f0, vuv, tp = (torch.as_tensor(a).to(x.dtype)
                   for a in (f0, vuv, temporal_positions))
    n_frames = f0.shape[0]
    per_dev = -(-n_frames // len(devs))
    pad = per_dev * len(devs) - n_frames
    f0_p = torch.cat([torch.where(vuv == 0, torch.full_like(f0, 500.0), f0),
                      f0.new_full((pad,), 500.0)])
    tp_p = torch.cat([tp, tp.new_zeros(pad)])

    def shard(dev, k):
        rows = slice(k * per_dev, (k + 1) * per_dev)
        env, _, _ = cheaptrick_core(x.to(dev)[None], fs, f0_p[rows].to(dev)[None],
                                    int(fft_size), -0.15, None, tp_p[rows].to(dev))
        return env[0], env.sum()

    outs = _on_devices(shard, devs, list(range(len(devs))))
    env = torch.cat([e.to(devs[0]) for e, _ in outs])[:n_frames]
    total_energy = torch.stack([s.to(devs[0]) for _, s in outs]).sum()
    return env, total_energy


class _TableModule(nn.Module):
    """A round trip as a module whose buffers are its static tables."""

    def _register_tables(self, tables: dict):
        for name, t in tables.items():
            self.register_buffer(name, t.clone())

    def from_numpy_state(self, state: dict):
        """Load tables given as numpy arrays (e.g. the JAX package's) into
        the buffers of the same names; shapes must match."""
        for name, arr in state.items():
            buf = getattr(self, name)
            src = torch.tensor(np.asarray(arr), dtype=buf.dtype)
            if src.shape != buf.shape:
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(buf.shape)}")
            buf.copy_(src)
        return self

    def _batch(self, x: torch.Tensor) -> torch.Tensor:
        xb = x[None] if x.dim() == 1 else x
        if xb.shape[1] != self.n_samples:
            raise ValueError(f"expected {self.n_samples} samples, got "
                             f"{xb.shape[1]}")
        return xb


class SwipeF0(_TableModule):
    """SWIPE' as a module whose buffers are its static tables
    (:func:`..f0.swipe.swipe_tables`): the candidate grid and each octave's
    spline operator, kernel matrix, blending weights and window.

    ``forward(x)`` takes (B, n_samples) or (n_samples,) signals of the length
    the module was built for."""

    def __init__(self, fs: int, n_samples: int, plim=(F0_FLOOR, F0_CEIL),
                 dt: float = SWIPE_DT, sTHR: float = float("-inf"),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.fs = int(fs)
        self.n_samples = int(n_samples)
        self.plim = tuple(float(p) for p in plim)
        self.dt, self.sTHR = float(dt), float(sTHR)
        self._register_tables(swipe_tables(self.fs, self.plim, dtype,
                                           resolve_device(device)))

    def forward(self, x: torch.Tensor) -> dict:
        return swipe_core(self._batch(x), self.fs, self.plim, self.dt,
                          self.sTHR, dict(self.named_buffers()))


class _ClassicRoundTrip(_TableModule):
    """The classic round trip (F0 -> CheapTrick -> D4C -> classic synthesis)
    as a module whose buffers are its F0 method's static tables
    (:func:`classic_tables`); a subclass names the method (``F0_METHOD``)
    and the outermost span of its calls (``SPAN``).

    ``forward(x, noise=None, generator=None)`` takes (B, n_samples) or
    (n_samples,) signals of the length the module was built for, and the
    noise draw (B, max_pulses, max_noise) of :meth:`caps`, drawn from
    ``generator`` (seeded 0 on the module's device when None) before the
    round trip when it is None.  On the card it replays one CUDA graph per
    batch size and type from the second call of that size on (the first
    runs eagerly; :mod:`.graphs`), held in ``graphs``; the draw is an input
    the replay copies in, so a replay with the same draw gives the eager
    call's bits.  On the CPU the same static code runs eagerly.  Moving the
    module drops its graphs; :meth:`from_numpy_state` writes the buffers in
    place, which the graphs read at each replay.

    Its outputs come back on the host, whatever the device: every caller
    reads them there.  On the card each call, eager or replayed, copies
    them into pinned host tensors that are the caller's to keep
    (:func:`.graphs.copy_back`: pinned blocks are rounded up to a power of
    two and held until the caller frees them) and returns once the bytes
    have landed; on the CPU they are the round trip's own tensors."""

    F0_METHOD = SPAN = None

    def __init__(self, fs: int, n_samples: int, frame_period: int = 5,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.fs = int(fs)
        self.n_samples = int(n_samples)
        self.frame_period = int(frame_period)
        self.graphs = GraphCache()
        self._register_tables(classic_tables(
            self.fs, dtype, resolve_device(device), self.F0_METHOD))

    def _apply(self, fn, *args, **kwargs):
        self.graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    def caps(self) -> tuple:
        """:func:`classic_caps` of the module: (y_length, max_pulses,
        max_noise)."""
        return classic_caps(self.n_samples, self.fs, self.frame_period,
                            self.F0_METHOD)

    def _round_trip(self, x: torch.Tensor, noise: torch.Tensor) -> dict:
        return encode_decode_classic_one(
            x, self.fs, self.frame_period, noise=noise,
            tables=dict(self.named_buffers()), f0_method=self.F0_METHOD)

    def forward(self, x: torch.Tensor, noise: torch.Tensor = None,
                generator: torch.Generator = None) -> dict:
        xb = self._batch(x)
        dev = next(self.buffers()).device
        with TRACER.span(self.SPAN, device=dev, fs=self.fs):
            TRACER.count("samples.computed", xb.shape[0] * xb.shape[1])
            _, max_pulses, max_noise = self.caps()
            TRACER.count("synth.pulses.slots", xb.shape[0] * max_pulses)
            if noise is None:
                with TRACER.span("world.batch.noise"):
                    noise = standard_normal((xb.shape[0], max_pulses, max_noise),
                                            generator, xb.dtype, dev)
            if not replays(dev):
                return self._round_trip(xb, noise)
            return copy_back(self.graphs.run(
                self.signature(xb, noise), self._round_trip, (xb, noise), dev))

    def signature(self, xb: torch.Tensor, noise: torch.Tensor) -> tuple:
        """The key of the graph a call replays: the device, the rows, the
        length and type of the signals, the caps (the draw's shape) and its
        type, and the tables' identity."""
        return (device_key(next(self.buffers()).device), tuple(xb.shape),
                xb.dtype, tuple(noise.shape), noise.dtype,
                table_identity(dict(self.named_buffers())))


class DioClassic(_ClassicRoundTrip):
    """WORLD's original round trip, DIO -> StoneMask -> CheapTrick -> D4C ->
    classic synthesis (:class:`_ClassicRoundTrip`); its buffers are the DIO
    band bank and offsets, the decimator's impulse response and the
    StoneMask DFT table."""

    F0_METHOD, SPAN = "dio", "world.batch.dio_classic"


class HarvestClassic(_ClassicRoundTrip):
    """pyworld's default chain, Harvest -> CheapTrick -> D4C -> classic
    synthesis (:class:`_ClassicRoundTrip`); its buffers are Harvest's
    tables: the band FIR bank and offsets, the decimator's impulse
    response, the refinement DFT table and the smoothing kernel.  Harvest's
    caps (``max_candidates``, ``max_sections``) are its defaults for the
    range and the length, and its capacity flags join ``_overflow``."""

    F0_METHOD, SPAN = "harvest", "world.batch.harvest_classic"


class HarvestRequiem(_TableModule):
    """The round-trip as a module whose buffers are its static tables: the
    band FIR bank and offsets, the decimator impulse response, the
    refinement DFT table, the smoothing kernel and the Requiem seed banks.

    ``forward(x)`` takes (B, n_samples) or (n_samples,) signals of the length
    the module was built for.  On the card it replays one CUDA graph per
    batch size and type from the second call of that size on (the first
    runs eagerly; :mod:`.graphs`), held in ``graphs``; on the CPU the same
    static code runs eagerly.  Moving the module (``.to()``, ``.cuda()``)
    drops its graphs; :meth:`from_numpy_state` writes the buffers in place,
    which the graphs read at each replay."""

    def __init__(self, fs: int, n_samples: int, frame_period: int = 5,
                 seed: int = 0, max_pulses: int = None,
                 max_candidates: int = None, max_sections: int = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.fs = int(fs)
        self.n_samples = int(n_samples)
        self.frame_period = int(frame_period)
        self.max_pulses = (max_pulses if max_pulses is not None
                           else default_batch_max_pulses(n_samples, fs))
        self.max_candidates = (max_candidates if max_candidates is not None
                               else default_max_candidates(F0_FLOOR, F0_CEIL))
        self.max_sections = (max_sections if max_sections is not None
                             else default_max_sections(n_samples, fs))
        self.graphs = GraphCache()
        self._register_tables(harvest_requiem_tables(
            self.fs, seed, dtype, resolve_device(device)))

    def _apply(self, fn, *args, **kwargs):
        self.graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    def _round_trip(self, x: torch.Tensor, noise_offsets: torch.Tensor) -> dict:
        tables = {k: getattr(self, k) for k in HARVEST_TABLE_KEYS}
        return encode_decode_one(x, self.pulse_seed, self.noise_seed, self.fs,
                                 self.frame_period, self.max_pulses,
                                 self.max_candidates, self.max_sections,
                                 noise_offsets=noise_offsets, tables=tables)

    def forward(self, x: torch.Tensor, noise_offsets: torch.Tensor = None) -> dict:
        xb = self._batch(x)
        dev = self.pulse_seed.device
        with TRACER.span("world.batch.harvest_requiem", device=dev, fs=self.fs):
            TRACER.count("samples.computed", xb.shape[0] * xb.shape[1])
            if noise_offsets is None:
                noise_offsets = torch.zeros(self.pulse_seed.shape[1],
                                            dtype=torch.int64, device=dev)
            if not replays(dev):
                return self._round_trip(xb, noise_offsets)
            key = (device_key(dev), tuple(xb.shape), xb.dtype,
                   table_identity(dict(self.named_buffers())))
            return self.graphs.run(key, self._round_trip,
                                   (xb, torch.as_tensor(noise_offsets)), dev)
