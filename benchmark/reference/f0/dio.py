"""DIO F0 estimation (port of world_tpu/f0/dio.py).

Every stage takes a leading batch axis of utterances.  The band low-pass
filters are one FIR bank (the reference multiplies three spectra at the
full signal length, which equals one linear convolution with host-combined
taps), the four event types of every band go to K1 as rows, and the
contour fixer runs batched.  Its two sequential passes, FixStep3 and
FixStep4, are the JAX package's frame scans, one K3 launch each on the card
(:mod:`..ops.extension_scan`).  Nothing reads the device from the host, and
the tables the stages take are kept (:mod:`..tables`), so that a round trip
can be captured into a CUDA graph.

Long audio and large batches: the band stage takes ``band_chunk`` and
``block`` as Harvest's does (:func:`..dsp.fir.band_blocking` sizes them in
:func:`dio_core`), so that the bank's unfolded columns, its output and the
event rows stay inside a budget of bytes.
"""
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.fir import band_blocking, band_filtered
from ..dsp.iir import decimate_world, world_decimator_impulse
from ..dsp.rounding import round_half_even_decimals
from ..dsp.windows import np_hanning_matlab, np_nuttall
from ..ops import extension_scan as K3
from ..tables import cached, device_key, frame_grid, table
from .events import four_event_stats, launch_pieces


# ---------------------------------------------------------------------------
# static tables
# ---------------------------------------------------------------------------

def boundary_f0_list(f0_floor: float, f0_ceil: float,
                     channels_in_octave: int) -> np.ndarray:
    n = math.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave)
    return f0_floor * 2.0 ** ((np.arange(n) + 1) / channels_in_octave)


def low_cut_taps(actual_fs: float):
    """The low-cut FIR of get_spectrum (dio.py:80-85) and its centre."""
    cutoff = int(actual_fs / 50 + 0.5)
    w = np_hanning_matlab(2 * cutoff + 1)
    taps = -w / w.sum()
    taps[cutoff] += 1.0
    return taps, cutoff


def band_bank(boundary_f0s: np.ndarray, actual_fs: float):
    """(low-cut * Nuttall low-pass) FIR bank (n_bands, L), left-aligned, and
    each band's read offset argmax(low-pass) + 1 + cutoff (n_bands,)."""
    lcf, cutoff = low_cut_taps(actual_fs)
    lens = [int(actual_fs / bf / 2 + 0.5) * 4 for bf in boundary_f0s]
    combined = [np.convolve(lcf, np_nuttall(n)) for n in lens]
    bank = np.zeros((len(lens), max(len(c) for c in combined)))
    for i, c in enumerate(combined):
        bank[i, :len(c)] = c
    return bank, band_offsets(tuple(boundary_f0s), actual_fs)


@functools.lru_cache(maxsize=64)
def band_offsets(boundary_f0s: tuple, actual_fs: float) -> np.ndarray:
    """Each band's read offset (n_bands,) on the host: the blocked bank
    reads its span from them, not from the device's copy."""
    _, cutoff = low_cut_taps(actual_fs)
    out = np.array([int(np.argmax(np_nuttall(int(actual_fs / bf / 2 + 0.5) * 4)))
                    + 1 + cutoff for bf in boundary_f0s], dtype=np.int64)
    out.flags.writeable = False
    return out


def dio_tables(fs: int, f0_floor: float, f0_ceil: float,
               channels_in_octave: int, target_fs: int, dtype: torch.dtype,
               device) -> dict:
    """DIO's static tables, built on the host in float64: the band bank and
    its offsets and the decimation filter's truncated impulse response.
    Built once per (rate, f0 range, type, device) and kept (:mod:`..tables`)."""
    device = device_key(device)

    def build():
        bank, offsets = band_bank(boundary_f0_list(f0_floor, f0_ceil,
                                                   channels_in_octave),
                                  float(target_fs))
        as_t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
        return {"dio_bank": as_t(bank, dtype),
                "dio_offsets": as_t(offsets, torch.int64),
                "dio_decimator_ir": as_t(world_decimator_impulse(int(fs / target_fs)),
                                         dtype)}

    return dict(cached(("dio_tables", int(fs), float(f0_floor), float(f0_ceil),
                        int(channels_in_octave), int(target_fs), dtype, device),
                       build))


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

def candidates_and_stability(y: torch.Tensor, actual_fs: float, f0_floor: float,
                             f0_ceil: float, boundary_f0s: np.ndarray,
                             temporal_positions: torch.Tensor,
                             frame_period: float, bank: torch.Tensor,
                             offsets: torch.Tensor, band_chunk: int = None,
                             block: int = None):
    """Per-band f0 candidates and their stability, each (B, n_bands, F), for
    decimated rows y (B, ny).  ``band_chunk``: filter and run K1 on that
    many bands at a time (one launch per chunk, and never more event rows
    than a launch takes: :func:`.events.launch_pieces`); ``block``: the FIR
    bank's block of output samples."""
    B, y_len = y.shape
    n_bands = bank.shape[0]
    row_piece, chunk = launch_pieces(B, n_bands, band_chunk)
    if row_piece < B:
        done = [candidates_and_stability(y[r0:r0 + row_piece], actual_fs,
                                         f0_floor, f0_ceil, boundary_f0s,
                                         temporal_positions, frame_period,
                                         bank, offsets, band_chunk, block)
                for r0 in range(0, B, row_piece)]
        return (torch.cat([d[0] for d in done]), torch.cat([d[1] for d in done]))
    stride = actual_fs * frame_period / 1000.0
    bfl = tuple(float(f) for f in boundary_f0s)
    bf_all = table("dio_boundary_f0s", bfl, lambda: bfl, y.dtype, y.device)
    host_offsets = band_offsets(bfl, float(actual_fs))
    f0s, stabs = [], []
    for b0 in range(0, n_bands, chunk):
        span = host_offsets[b0:b0 + chunk]
        filtered = band_filtered(y, bank[b0:b0 + chunk], offsets[b0:b0 + chunk],
                                 block, span=(int(span.min()), int(span.max())))
        f0c, dev, _ = four_event_stats(filtered.reshape(-1, y_len), actual_fs,
                                       temporal_positions, stride)
        del filtered
        f0c = f0c.reshape(B, -1, f0c.shape[-1])
        dev = dev.reshape(f0c.shape)
        bf = bf_all[b0:b0 + chunk, None]
        bad = (f0c > bf) | (f0c < bf / 2) | (f0c > f0_ceil) | (f0c < f0_floor)
        f0c = torch.where(bad, torch.zeros_like(f0c), f0c)
        dev = torch.where(f0c == 0, torch.full_like(dev, 100000.0), dev)
        f0s.append(f0c)
        stabs.append(torch.exp(-(dev / torch.clamp(f0c, min=0.0000001))))
    if len(f0s) == 1:
        return f0s[0], stabs[0]
    return torch.cat(f0s, dim=1), torch.cat(stabs, dim=1)


# ---------------------------------------------------------------------------
# contour fixing (dio.py:216-326)
# ---------------------------------------------------------------------------

def fix_step1(f0_cands: torch.Tensor, voice_range_minimum: int,
              allowed_range: float):
    """Zero rapid changes of the best candidate, after zeroing its first and
    last voice_range_minimum frames.  The reference zeroes those edges of
    candidate row 0 in place (dio.py:237-247), so the candidates later
    passes see are returned too.  f0_cands (B, C, n)."""
    n = f0_cands.shape[-1]
    idx = torch.arange(n, device=f0_cands.device)
    edge = (idx < voice_range_minimum) | (idx >= n - voice_range_minimum)
    f0_base = torch.where(edge, torch.zeros_like(f0_cands[:, 0]), f0_cands[:, 0])
    r = round_half_even_decimals(f0_base, 6)
    r_prev = torch.cat([r[:, :1], r[:, :-1]], dim=-1)
    rapid = torch.abs((r - r_prev) / (0.000001 + r)) > allowed_range
    apply = idx >= voice_range_minimum - 1
    f0_step1 = torch.where(apply & rapid, torch.zeros_like(f0_base), f0_base)
    cands_mut = f0_cands.clone()
    cands_mut[:, 0] = f0_base
    return f0_step1, cands_mut


def fix_step2(f0_step1: torch.Tensor, voice_range_minimum: int):
    """Zero every frame whose +-(vrm-1)/2 neighbourhood holds a zero
    (dio.py:252-259); f0_step1 (B, n)."""
    n = f0_step1.shape[-1]
    hw = (voice_range_minimum - 1) // 2
    z = (f0_step1 == 0).to(torch.int64)
    c = F.pad(torch.cumsum(z, dim=-1), (1, 0))
    i = torch.arange(n, device=f0_step1.device)
    lo = (i - hw).clamp(0, n)
    hi = (i + hw + 1).clamp(0, n)
    any_zero = (c[:, hi] - c[:, lo]) > 0
    inner = (i >= hw) & (i < n - hw)
    return torch.where(inner & any_zero, torch.zeros_like(f0_step1), f0_step1)


def _section_edges(f0: torch.Tensor):
    """Voiced-section starts and ends (B, n) of f0 (B, n), and each frame's
    next start strictly after it and previous end strictly before it
    (n + 10 and -1 where there is none)."""
    n = f0.shape[-1]
    v = f0 != 0
    i = torch.arange(n, device=f0.device).expand_as(v)
    is_start = v & ~F.pad(v[:, :-1], (1, 0))
    is_end = v & ~F.pad(v[:, 1:], (0, 1))
    big = n + 10
    starts = torch.where(is_start, i, torch.full_like(i, big))
    next_start = torch.flip(torch.cummin(torch.flip(starts, (-1,)), dim=-1).values,
                            (-1,))
    next_after = F.pad(next_start[:, 1:], (0, 1), value=big)
    ends = torch.where(is_end, i, torch.full_like(i, -1))
    prev_end = torch.cummax(ends, dim=-1).values
    prev_before = F.pad(prev_end[:, :-1], (1, 0), value=-1)
    return is_start, is_end, next_after, prev_before


def fix_step3(f0_step2, cands, allowed_range: float):
    """Extend each voiced section forward (dio.py:264-277) up to one frame
    past the next section's start, or to the last frame: the JAX package's
    forward scan (K3 on the card)."""
    n = f0_step2.shape[-1]
    _, is_end, next_after, _ = _section_edges(f0_step2)
    limit = torch.where(next_after >= n + 10, torch.full_like(next_after, n - 1),
                        next_after + 1)
    return K3.extension_scan(f0_step2, is_end, limit, cands, allowed_range)


def fix_step4(f0_step3, f0_step2, cands, allowed_range: float):
    """Extend each voiced section of f0_step2 backward (dio.py:281-293)
    over f0_step3, down to one frame before the previous section's end, or
    to frame 0: the JAX package's backward scan (K3 on the card)."""
    is_start, _, _, prev_before = _section_edges(f0_step2)
    limit = torch.where(prev_before < 0, torch.ones_like(prev_before), prev_before)
    return K3.extension_scan(f0_step3, is_start, limit, cands, allowed_range,
                             backward=True)


def fix_f0_contour(f0_candidates: torch.Tensor, frame_period: float,
                   f0_floor: float, allowed_range: float):
    """(f0, vuv, (f0_step1, f0_step2, f0_step3, mutated candidates)) for
    sorted candidates (B, C, n)."""
    voice_range_minimum = int(1 / (frame_period / 1000) / f0_floor + 0.5) * 2 + 1
    f0_step1, cands_mut = fix_step1(f0_candidates, voice_range_minimum,
                                    allowed_range)
    f0_step2 = fix_step2(f0_step1, voice_range_minimum)
    f0_step3 = fix_step3(f0_step2, cands_mut, allowed_range)
    f0_step4 = fix_step4(f0_step3, f0_step2, cands_mut, allowed_range)
    vuv = (f0_step4 != 0).to(f0_step4.dtype)
    return f0_step4, vuv, (f0_step1, f0_step2, f0_step3, cands_mut)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def frame_positions(signal_length: int, fs: int, frame_period: float) -> np.ndarray:
    """DIO's frame grid, arange(num_samples) * frame_period / 1000 (host
    float64, dio.py:29)."""
    num_samples = int(1000 * signal_length / fs / frame_period + 1)
    return np.arange(num_samples) * frame_period / 1000


def _band_tables(boundary_f0s, actual_fs: float, dtype, device):
    """The band bank and its offsets at ``actual_fs``, kept."""
    device = device_key(device)

    def build():
        bank, offsets = band_bank(boundary_f0s, actual_fs)
        return (torch.tensor(bank, dtype=dtype, device=device),
                torch.tensor(offsets, device=device))

    return cached(("dio_band_tables", tuple(float(f) for f in boundary_f0s),
                   float(actual_fs), dtype, device), build)


def dio_stages(y: torch.Tensor, actual_fs: float, f0_floor: float,
               f0_ceil: float, channels_in_octave: int, frame_period: float,
               allowed_range: float, n_frames: int, bank: torch.Tensor = None,
               offsets: torch.Tensor = None, band_chunk: int = None,
               block: int = None) -> dict:
    """DIO after the decimation, for decimated rows y (B, ny) at actual_fs:
    candidates, their stability-sorted order and the fixed contour.  Every
    intermediate is returned, under the JAX package's names.  ``band_chunk``
    and ``block``: :func:`candidates_and_stability`'s."""
    dtype, dev = y.dtype, y.device
    bfl = boundary_f0_list(f0_floor, f0_ceil, channels_in_octave)
    if bank is None:
        bank, offsets = _band_tables(bfl, actual_fs, dtype, dev)
    tp = frame_grid(n_frames, frame_period, dev).to(dtype)
    raw_f0, raw_stab = candidates_and_stability(
        y, actual_fs, f0_floor, f0_ceil, bfl, tp, frame_period, bank, offsets,
        band_chunk, block)
    order = torch.argsort(-raw_stab, dim=1, stable=True)
    f0_candidates = torch.gather(raw_f0, 1, order)
    f0_scores = torch.gather(raw_stab, 1, order)
    f0, vuv, (step1, step2, step3, cands_mut) = fix_f0_contour(
        f0_candidates, frame_period, f0_floor, allowed_range)
    return {"f0": f0, "vuv": vuv, "temporal_positions": tp,
            "f0_candidates": f0_candidates, "raw_f0_candidates": raw_f0,
            "_f0_scores": f0_scores, "_raw_stability": raw_stab,
            "_f0_step1": step1, "_f0_step2": step2, "_f0_step3": step3,
            "_f0_candidates_mutated": cands_mut}


def dio_core(x: torch.Tensor, fs: int, f0_floor: float = 71.0,
             f0_ceil: float = 800.0, channels_in_octave: int = 2,
             target_fs: int = 4000, frame_period: float = 5.0,
             allowed_range: float = 0.1, tables: dict = None) -> dict:
    """DIO on rows x (B, n).  The decimated rate is taken to be target_fs,
    as in the reference.  ``tables`` is :func:`dio_tables`' dict (built
    when None)."""
    if tables is None:
        tables = dio_tables(fs, f0_floor, f0_ceil, channels_in_octave,
                            target_fs, x.dtype, x.device)
    y = decimate_world(x, int(fs / target_fs), h=tables["dio_decimator_ir"])
    n_frames = frame_positions(x.shape[1], fs, frame_period).shape[0]
    bank = tables["dio_bank"]
    band_chunk, block = band_blocking(y.shape[0], bank.shape[0], y.shape[1],
                                      bank.shape[1], y.element_size())
    return dio_stages(y, float(target_fs), f0_floor, f0_ceil, channels_in_octave,
                      frame_period, allowed_range, n_frames, bank,
                      tables["dio_offsets"], band_chunk, block)


def dio(x: torch.Tensor, fs: int, f0_floor: float = 71, f0_ceil: float = 800,
        channels_in_octave: int = 2, target_fs: int = 4000,
        frame_period: float = 5, allowed_range: float = 0.1) -> dict:
    """DIO F0 estimation of one utterance x (n,) or a batch (B, n).  Outputs
    keep the input's batch shape."""
    single = x.dim() == 1
    out = dio_core(x[None] if single else x, int(fs), float(f0_floor),
                   float(f0_ceil), int(channels_in_octave), int(target_fs),
                   float(frame_period), float(allowed_range))
    if single:
        out = {k: (v if k == "temporal_positions" else v[0])
               for k, v in out.items()}
    return out
