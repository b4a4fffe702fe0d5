"""The round trips of world_tpu_torch/parallel/batch.py, frozen for the
benchmark's reference: the Harvest -> CheapTrick -> D4C-Requiem -> Requiem
round trip (:func:`encode_decode_one`) and the DIO -> StoneMask ->
CheapTrick -> D4C -> classic synthesis round trip
(:func:`encode_decode_classic_one`) with an explicit leading batch axis,
and the tables and caps they take.  Everything runs eagerly as plain
PyTorch: the copy keeps no CUDA graph, no device list and no kernel."""
import functools

import numpy as np
import torch

from .aperiodicity import d4c as D4C
from .aperiodicity.common import d4c_fft_size
from .aperiodicity.d4c_requiem import d4c_requiem_core, n_bands_ap, requiem_fft_size
from .f0.dio import dio_core, dio_tables, frame_positions
from .dsp.ola import SLOT
from .f0.harvest import (default_max_candidates, default_max_sections,
                          harvest_core, harvest_tables,
                          smooth_zero_phase_kernel)
from .f0.stonemask import max_half_window, stonemask_core, table_size
from .ops.refine_dft import dft_table
from .spectral.cheaptrick import cheaptrick_core, default_fft_size
from .synth.classic import (default_max_pulses, max_noise_length,
                             pulse_rank_bound, standard_normal, synthesis_core)
from .synth.requiem import excitation_core, waveform_core
from .synth.seeds import seed_tables
from .tables import cached, device_key

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
    _section_overflow (B,), or by DIO refined by StoneMask (the port's
    SWIPE' is not in this copy).  ``tables`` holds the method's static
    tables (built when None)."""
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
    ap = d4c_aperiodicity(x, fs, f0_d4c, src["temporal_positions"],
                          frame_period, is_requiem, fft_size)
    return dict(src, f0=f0_d4c, spectrogram=env, ps_spectrogram=ps_spec,
                aperiodicity=ap)


def analyze(x: torch.Tensor, fs: int, frame_period: float,
            f0_method: str = "harvest", is_requiem: bool = True,
            tables: dict = None, fft_size: int = None, **f0_options) -> dict:
    """The analysis of rows x (B, n): :func:`f0_contour` (``f0_options``
    go to it), then :func:`analyze_contour`.  An explicit ``fft_size`` also
    sets the F0 search's floor, 3 fs / fft_size, before the F0 estimation
    (world_tpu.World.encode)."""
    if fft_size is not None:
        f0_options["f0_floor"] = floor_of_fft_size(fs, fft_size)
    src = f0_contour(x, fs, frame_period, f0_method, tables=tables,
                     **f0_options)
    return analyze_contour(x, fs, src, frame_period_of(f0_method, frame_period),
                           is_requiem, fft_size)


@functools.lru_cache(maxsize=None)
def round_trip_rank_bound(fs: int) -> int:
    """The overlap-add's passes in the round trip's Requiem synthesis
    (:func:`..synth.classic.pulse_rank_bound`), from the caps alone: its f0 is
    at most the F0 ceiling (plus FixStep4's one hertz of fill), raised by
    the smoothing's gain (the sum of its kernel's magnitudes bounds any
    smoothed value)."""
    gain = float(np.abs(smooth_zero_phase_kernel()).sum())
    return pulse_rank_bound((F0_CEIL + 1.0) * gain, fs)


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
    return {"f0": an["f0"], "vuv": an["vuv"], "spectrogram": an["spectrogram"],
            "band_aperiodicity": an["aperiodicity"], "y": y,
            "temporal_positions": an["temporal_positions"],
            "_overflow": (an["_refine_overflow"] | an["_section_overflow"]
                          | pulse_overflow),
            "_refine_overflow": an["_refine_overflow"],
            "_section_overflow": an["_section_overflow"],
            "_pulse_overflow": pulse_overflow}


def encode_classic_one(x: torch.Tensor, fs: int, frame_period: int,
                       tables: dict = None) -> dict:
    """DIO -> StoneMask -> CheapTrick -> D4C for rows x (B, n) (the
    reference's main.py:126-130 + 138-146).  Returns f0, vuv (B, F),
    temporal_positions (F,), spectrogram and aperiodicity (B, bins, F).
    ``tables``: :func:`classic_tables`' dict (built when None)."""
    if tables is None:
        tables = classic_tables(fs, x.dtype, x.device)
    an = analyze(x, fs, frame_period, "dio", False, tables=tables)
    return {"f0": an["f0"], "vuv": an["vuv"],
            "temporal_positions": an["temporal_positions"],
            "spectrogram": an["spectrogram"].transpose(1, 2),
            "aperiodicity": an["aperiodicity"].transpose(1, 2)}


def classic_caps(sig_len: int, fs: int, frame_period: int):
    """(y_length, max_pulses, max_noise) of the classic round trip, bounded
    by the f0 ceiling rather than the data (DIO keeps no candidate above
    it): the shape of its noise draw."""
    n_frames = frame_positions(sig_len, fs, frame_period).shape[0]
    tp_last = (n_frames - 1) * frame_period / 1000.0
    y_length = len(np.arange(0.0, tp_last + 1.0 / fs, 1.0 / fs))
    max_pulses = default_max_pulses(np.array([0.0, tp_last]), np.array([F0_CEIL]))
    return y_length, max_pulses, max_noise_length(fs)


@functools.lru_cache(maxsize=None)
def classic_rank_bound(fs: int) -> int:
    """The overlap-add's passes in the round trip's classic synthesis, from
    the caps alone: its f0 is at most StoneMask's 1.2 times the F0 ceiling
    (:func:`classic_caps`), 500 Hz where unvoiced."""
    return pulse_rank_bound(F0_CEIL * 1.2, fs)


def synthesize_classic(dat: dict, noise: torch.Tensor, fs: int, sig_len: int,
                       frame_period: int):
    """Classic pulse/noise synthesis (synthesis.py:21-82) of every row of
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
    """The classic round trip for rows x (B, n): :func:`encode_classic_one`,
    then :func:`synthesize_classic`.

    ``noise`` is the standard-normal draw (B, max_pulses, max_noise) of
    :func:`classic_caps`; when None it is drawn from ``generator`` (seeded
    0 on x's device when None).  Returns the encode outputs, y
    (B, y_length) and the per-row capacity flag _overflow (B,).

    The JAX package's ``_encode_decode_classic_one`` on its static shapes:
    given its noise, nothing on the round trip is read back to the host, so
    that a CUDA graph can capture it (:class:`DioClassic`)."""
    B, sig_len = x.shape
    dat = encode_classic_one(x, fs, frame_period, tables)
    if noise is None:
        _, max_pulses, max_noise = classic_caps(sig_len, fs, frame_period)
        noise = standard_normal((B, max_pulses, max_noise), generator, x.dtype,
                                x.device)
    y, overflow = synthesize_classic(dat, noise, fs, sig_len, frame_period)
    return dict(dat, y=y, _overflow=overflow)


def classic_tables(fs: int, dtype: torch.dtype, device) -> dict:
    """The classic round trip's static tables: DIO's band bank, its offsets
    and its decimator's impulse response, and StoneMask's DFT table.  Built
    once per (fs, type, device) and kept (:mod:`..tables`)."""
    device = device_key(device)

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


def bucket_lengths(lens, fs: int, bucket_quantum_s: float) -> dict:
    """{padded length: indices of the utterances it holds}, in ascending
    length: each utterance is padded up to the next multiple of
    ``bucket_quantum_s`` seconds."""
    quantum = max(1, int(round(bucket_quantum_s * fs)))
    buckets = {}
    for i, n in enumerate(lens):
        buckets.setdefault(max(quantum, -(-n // quantum) * quantum), []).append(i)
    return dict(sorted(buckets.items()))


