"""Harvest F0 estimation (port of world_tpu/f0/harvest.py).

Every stage takes a leading batch axis of utterances: the band filtering,
the event engine (K1, bands x 4 event types x batch as rows), the candidate
detection and compaction, the refinement (K2, batch folded into frames), the
per-frame contour stages, FixStep3's chains and merge and the section
smoothing.  The contour stages keep the JAX package's static shapes: each
utterance has ``max_sections`` voiced-section rows, masked where it has
fewer, so that nothing is read back to the host and the shapes depend on the
caps alone (what a CUDA graph needs, and what ``jax.jit`` needs).  Tables
that come from the host are built once (:mod:`..tables`).

Long audio and large batches run in bounded memory.  Each stage whose
temporaries grow with batch x duration takes the JAX package's argument for
its blocking (``block``: output samples of the FIR bank, ``band_chunk``:
bands of the candidate stage, ``frame_chunk``: frames of the refinement and
of RemoveUnreliableCandidates, ``section_chunk``: voiced sections of
FixStep3 and of the smoothing), None for one block.  :func:`harvest_core`
sizes them from the bytes the stage would hold alive (:func:`stage_blocking`)
against ``STAGE_BYTES_BUDGET``.  Bands, frames and sections are independent,
so a blocked stage computes what the whole one computes: bitwise from the
refinement on, and up to the summation order of the FIR bank's matrix
products before it.  The last chunk of bands, frames or sections is simply
shorter (the JAX package pads to equal chunks for ``lax.map``).

Left out on purpose, since it changes no result: the f0 bucketing of the
refinement (``_bucket_caps`` / ``_refine_bucketed``), an MXU flop saver; the
CUDA kernel gets the same saving by looping only over each candidate's own
window.
"""
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from .._backend import F64_EPS, STAGE_BYTES_BUDGET, chunk_size, rdiv
from ..dsp.fir import band_blocking, band_filtered
from ..dsp.iir import decimate_matlab, decimator_impulse
from ..dsp.rounding import matlab_round_half
from ..dsp.scanops import compact_rows
from ..dsp.windows import np_nuttall
from ..frames import host_flag, uniform_centered_slabs
from ..ops import fix_step3 as step3_kernels
from ..ops.refine_dft import dft_table, refine_full
from ..tables import cached, device_key, frame_grid, table
from .events import four_event_interp, launch_pieces

C2_SLOTS = 48           # refinement slots per frame after compaction


# ---------------------------------------------------------------------------
# static tables
# ---------------------------------------------------------------------------

def boundary_f0_list(f0_floor: float, f0_ceil: float) -> np.ndarray:
    adj_floor = f0_floor * 0.9
    adj_ceil = f0_ceil * 1.1
    channels_in_octave = 40
    return adj_floor * 2.0 ** (
        (np.arange(np.ceil(np.log2(adj_ceil / adj_floor) * channels_in_octave))
         + 1) / channels_in_octave)


def band_half_lengths(boundary_f0s: np.ndarray, actual_fs: float) -> list:
    """Each band filter's half length; band b is read from sample
    ``halfs[b] + 1`` of its full convolution."""
    return [int(math.floor(actual_fs / bf * 2 + 0.5)) for bf in boundary_f0s]


def band_filter_bank(boundary_f0s: np.ndarray, actual_fs: float):
    """Static per-band Nuttall band-pass FIRs (harvest.py:252-257): bank
    (n_bands, L) left-aligned, bias (n_bands,) output offsets."""
    halfs = band_half_lengths(boundary_f0s, actual_fs)
    max_len = 2 * max(halfs) + 1
    bank = np.zeros((len(halfs), max_len))
    bias = np.zeros(len(halfs), dtype=np.int64)
    for i, (h, bf) in enumerate(zip(halfs, boundary_f0s)):
        n = 2 * h + 1
        shifter = np.cos(2 * np.pi * bf * np.arange(-h, h + 1) / actual_fs)
        bank[i, :n] = np_nuttall(n) * shifter
        bias[i] = h + 1
    return bank, bias


# Zero-phase kernel of SmoothF0's forward+backward biquad (harvest.py:663-695):
# its poles sit at radius 0.875, so the response at lag 300 — the
# reference's own section padding — is below float64 eps.
_SMOOTH_B = np.array([0.0078202080334971724, 0.015640416066994345,
                      0.0078202080334971724])
_SMOOTH_A = np.array([1.0, -1.7347257688092754, 0.76600660094326412])
_SMOOTH_RADIUS = 300


def smooth_zero_phase_kernel() -> np.ndarray:
    """(2R+1,) symmetric impulse response h * reverse(h) of the biquad."""
    R = _SMOOTH_RADIUS
    h = np.zeros(R + 1)
    x = np.zeros(R + 1)
    x[0] = 1.0
    for i in range(R + 1):
        acc = _SMOOTH_B[0] * x[i]
        if i >= 1:
            acc += _SMOOTH_B[1] * x[i - 1] - _SMOOTH_A[1] * h[i - 1]
        if i >= 2:
            acc += _SMOOTH_B[2] * x[i - 2] - _SMOOTH_A[2] * h[i - 2]
        h[i] = acc
    return np.convolve(h, h[::-1])


# ---------------------------------------------------------------------------
# downsampling + band candidates
# ---------------------------------------------------------------------------

def decimation(fs: int, target_fs: int = 8000):
    """(ratio, actual_fs) of Harvest's downsampler."""
    ratio = int(fs / target_fs + 0.5)
    return ratio, (float(fs) if fs <= target_fs else fs / ratio)


def refinement_geometry(actual_fs: float, f0_floor: float):
    """(max_half, S): the widest candidate half-window and the DFT size it
    needs; every candidate's fft_size divides S."""
    max_half = int(np.ceil(3 * actual_fs / f0_floor / 2))
    return max_half, int(2 ** np.ceil(np.log2(2 * max_half + 1) + 1))


def harvest_tables(fs: int, f0_floor: float, f0_ceil: float,
                   dtype: torch.dtype, device) -> dict:
    """Harvest's static tables, built on the host in float64: the band FIR
    bank and its output offsets, the decimator's truncated impulse response,
    the refinement DFT table and the smoothing kernel (kept in float64: its
    spectrum is taken in float64, as the JAX package does).  Built once per
    (fs, f0 range, type, device) and kept (:mod:`..tables`)."""
    device = device_key(device)
    return dict(cached(("harvest_tables", int(fs), float(f0_floor),
                        float(f0_ceil), dtype, device),
                       lambda: _build_harvest_tables(fs, f0_floor, f0_ceil,
                                                     dtype, device)))


def _build_harvest_tables(fs, f0_floor, f0_ceil, dtype, device) -> dict:
    ratio, actual_fs = decimation(fs)
    bank, bias = band_filter_bank(boundary_f0_list(f0_floor, f0_ceil),
                                  actual_fs)
    decim = decimator_impulse(ratio) if fs > 8000 else np.zeros(0)
    _, S = refinement_geometry(actual_fs, f0_floor)
    cos_tab, sin_tab = dft_table(S, dtype, device)
    as_t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    return {"band_bank": as_t(bank, dtype),
            "band_bias": as_t(bias, torch.int64),
            "decimator_ir": as_t(decim, dtype),
            "refine_cos": cos_tab, "refine_sin": sin_tab,
            "smooth_kernel": as_t(smooth_zero_phase_kernel(), torch.float64)}


def downsample(x: torch.Tensor, fs: int, target_fs: int = 8000,
               h: torch.Tensor = None):
    """CalculateDownsampledSignal for rows x (B, n): (y (B, ny), actual_fs).
    ``h``: the decimator's truncated impulse response (computed when None)."""
    ratio = int(fs / target_fs + 0.5)
    if fs <= target_fs:
        y = x
        actual_fs = float(fs)
    else:
        offset = int(np.ceil(140 / ratio) * ratio)
        B = x.shape[0]
        xp = torch.cat([x[:, :1].expand(B, offset), x,
                        x[:, -1:].expand(B, offset)], dim=1)
        y0 = decimate_matlab(xp, ratio, order=3, h=h)
        actual_fs = fs / ratio
        y = y0[:, offset // ratio:-(offset // ratio)]
    return y - y.mean(dim=1, keepdim=True), actual_fs


def raw_band_candidates(y: torch.Tensor, actual_fs: float, bank: torch.Tensor,
                        bias: torch.Tensor, boundary_f0s: np.ndarray,
                        temporal_positions: torch.Tensor, f0_floor: float,
                        f0_ceil: float, band_chunk: int = None,
                        block: int = None) -> torch.Tensor:
    """CalculateCandidates: (B, n_bands, n_frames) per-band f0 means.

    ``band_chunk``: filter, run K1 and range-check that many bands at a
    time, keeping only each chunk's (B, bands, n_frames) result; K1 then
    launches once per chunk.  A chunk never holds more event rows than one
    K1 launch takes, whatever B is (:func:`.events.launch_pieces`).
    ``block``: the FIR bank's block of output samples
    (:func:`..dsp.fir.band_filtered`)."""
    B, y_len = y.shape
    n_bands = bank.shape[0]
    row_piece, chunk = launch_pieces(B, n_bands, band_chunk)
    if row_piece < B:
        return torch.cat([
            raw_band_candidates(y[r0:r0 + row_piece], actual_fs, bank, bias,
                                boundary_f0s, temporal_positions, f0_floor,
                                f0_ceil, band_chunk, block)
            for r0 in range(0, B, row_piece)])
    bf_all = table("boundary_f0s", (float(f0_floor), float(f0_ceil)),
                   lambda: boundary_f0s, y.dtype, y.device)
    # the bands' offsets on the host: the blocked bank reads its span from
    # them, not from ``bias`` on the device
    offsets = np.asarray(band_half_lengths(boundary_f0s, actual_fs)) + 1
    out = []
    for b0 in range(0, n_bands, chunk):
        span = offsets[b0:b0 + chunk]
        filtered = band_filtered(y, bank[b0:b0 + chunk], bias[b0:b0 + chunk],
                                 block, span=(int(span.min()), int(span.max())))
        f0c, _ = four_event_interp(filtered.reshape(-1, y_len), actual_fs,
                                   temporal_positions, actual_fs * 0.001)
        del filtered
        f0c = f0c.reshape(B, -1, f0c.shape[-1])
        bf = bf_all[b0:b0 + chunk, None]
        bad = ((f0c > bf * 1.1) | (f0c < bf * 0.9) | (f0c > f0_ceil)
               | (f0c < f0_floor))
        out.append(torch.where(bad, torch.zeros_like(f0c), f0c))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def detect_candidates(raw: torch.Tensor, max_candidates: int,
                      threshold: int = 10):
    """Per-frame runs of >= threshold positive bands -> run mean f0.
    raw (B, n_bands, F) -> (cands (B, max_candidates, F), n_detected (B,))."""
    n_bands = raw.shape[-2]
    max_runs = n_bands // 2 + 1
    band = torch.arange(n_bands, device=raw.device)[:, None]
    # the reference zeroes the first and last band before run detection
    pos = (raw > 0) & (band > 0) & (band < n_bands - 1)
    prev = F.pad(pos[..., :-1, :], (0, 0, 1, 0))
    nxt = F.pad(pos[..., 1:, :], (0, 0, 0, 1))
    start = (pos & ~prev).to(torch.int64)
    end = (pos & ~nxt).to(torch.int64)
    cs_start = torch.cumsum(start, dim=-2).transpose(-1, -2).contiguous()
    cs_end = torch.cumsum(end, dim=-2).transpose(-1, -2).contiguous()
    q = torch.arange(1, max_runs + 1, device=raw.device)
    q = q.expand(cs_start.shape[:-1] + (max_runs,)).contiguous()
    start_pos = torch.searchsorted(cs_start, q).clamp(max=n_bands - 1)
    end_pos = torch.searchsorted(cs_end, q).clamp(max=n_bands - 1)
    n_runs = cs_start[..., -1]
    run_valid = (torch.arange(max_runs, device=raw.device) < n_runs[..., None])

    raw_cs = torch.cumsum(raw, dim=-2).transpose(-1, -2)
    raw_cs0 = F.pad(raw_cs, (1, 0))
    sums = (torch.gather(raw_cs0, -1, end_pos + 1)
            - torch.gather(raw_cs0, -1, start_pos))
    lens = end_pos - start_pos + 1
    qualify = run_valid & (lens >= threshold)
    means = torch.where(qualify, sums / torch.clamp(lens, min=1),
                        torch.zeros_like(sums))
    cands, rank = compact_rows(means, qualify, max_candidates)
    return cands.transpose(-1, -2), rank[..., -1].amax(dim=-1)


def overlap_candidates(cands: torch.Tensor, n: int = 3) -> torch.Tensor:
    """OverlapF0Candidates with the reference's row-0 quirk; (B, mc, F) ->
    (B, (2n+1)*mc, F)."""
    n_over = 2 * n + 1
    n_frames = cands.shape[-1]
    blocks = []
    for i in range(n_over):
        st1 = max(-(i - n) + 1, 1)
        ed1 = min(-(i - n), 0)
        width = n_frames + ed1 - (st1 - 1)
        block = torch.zeros_like(cands)
        block[..., st1 - 1:st1 - 1 + width] = cands[..., -ed1:-ed1 + width]
        blocks.append(block)
    out = torch.cat(blocks, dim=-2)
    # row 0 was initialized from cands[n_over-1] before block 0 overwrote
    # columns [n:], leaving columns [0:n] holding cands[n_over-1, 0:n]
    out[..., 0, :n] = cands[..., n_over - 1, :n]
    return out


# ---------------------------------------------------------------------------
# refinement
# ---------------------------------------------------------------------------

def refinement_phase(actual_fs: float, max_half: int,
                     temporal_positions: torch.Tensor) -> torch.Tensor:
    """(F, W) window phase of GetRefinedF0 (see world_tpu/f0/harvest.py:242-259):
    (base - 0.499)/fs, minus 1/fs where t*fs + base + 0.001 <= 0."""
    dtype, dev = temporal_positions.dtype, temporal_positions.device
    key = (float(actual_fs), int(max_half))
    base = lambda: np.arange(-max_half, max_half + 1, dtype=np.float64)  # noqa: E731
    phase_c = table("refine_phase_c", key,
                    lambda: (base() - 0.499) / np.float64(actual_fs), dtype, dev)
    base_t = table("refine_base", key, base, dtype, dev)
    inv_fs = torch.full((), float(np.float64(1.0) / actual_fs), dtype=dtype,
                        device=dev)
    fs_t = torch.full((), float(actual_fs), dtype=dtype, device=dev)
    raw = temporal_positions[:, None] * fs_t + base_t[None, :] + 0.001
    return phase_c[None, :] - (raw <= 0.0).to(dtype) * inv_fs


def refinement_inputs(y: torch.Tensor, actual_fs: float,
                      temporal_positions: torch.Tensor, cands: torch.Tensor,
                      max_half: int, first: int = 0):
    """K2's operands for (B, C, F) candidates on rows y (B, ny), with the
    batch folded into the frame axis: seg and phase (B*F, W), f0 (C, B*F).
    Every frame's segment is shared by its candidates.  The F frames are
    those from frame ``first`` of the 1 ms grid, at ``temporal_positions``
    (F,)."""
    B, C, Fr = cands.shape
    W = 2 * max_half + 1
    seg = uniform_centered_slabs(y, actual_fs, actual_fs * 0.001 / actual_fs,
                                 Fr, max_half, offset=-1, first=first)  # (B, F, W)
    phase = refinement_phase(actual_fs, max_half, temporal_positions)
    f0 = torch.clamp(cands, min=1e-12)
    return (seg.reshape(B * Fr, W).contiguous(),
            phase.expand(B, Fr, W).reshape(B * Fr, W).contiguous(),
            f0.permute(1, 0, 2).reshape(C, B * Fr).contiguous())


def refine_candidates(y: torch.Tensor, actual_fs: float,
                      temporal_positions: torch.Tensor, cands: torch.Tensor,
                      f0_floor: float, f0_ceil: float, max_half: int,
                      table=None, frame_chunk: int = None):
    """RefineCandidates for (B, C, F) candidates: (refined, score) (B, C, F).
    ``table``: the refinement DFT (cos, sin) table (computed when None).
    ``frame_chunk``: cut the segments and run K2 that many frames at a time
    (one launch per chunk); every (candidate, frame) pair is computed as in
    the whole call."""
    B, C, Fr = cands.shape
    _, S = refinement_geometry(actual_fs, f0_floor)
    chunk = Fr if frame_chunk is None else max(1, int(frame_chunk))
    refs, scores = [], []
    for q0 in range(0, Fr, chunk):
        q1 = min(q0 + chunk, Fr)
        seg, phase, f0 = refinement_inputs(y, actual_fs,
                                           temporal_positions[q0:q1],
                                           cands[..., q0:q1], max_half, q0)
        ref, score = refine_full(seg, phase, f0, actual_fs, max_half, S,
                                 f0_floor, f0_ceil, table)
        del seg, phase, f0
        refs.append(ref.reshape(C, B, q1 - q0).permute(1, 0, 2))
        scores.append(score.reshape(C, B, q1 - q0).permute(1, 0, 2))
    if len(refs) == 1:
        return refs[0], scores[0]
    return torch.cat(refs, dim=-1), torch.cat(scores, dim=-1)


def remove_unreliable(cands: torch.Tensor, scores: torch.Tensor,
                      threshold: float = 0.05, frame_chunk: int = None):
    """RemoveUnreliableCandidates on (B, C, F).  ``frame_chunk``: compare
    that many frames at a time with their two neighbours, so that the
    (B, C, C, frames) errors exist a chunk at a time."""
    Fr = cands.shape[-1]
    ref = torch.clamp(cands, min=torch.finfo(cands.dtype).tiny)
    chunk = Fr if frame_chunk is None else max(1, int(frame_chunk))

    def min_err_vs(other):
        parts = []
        for q0 in range(0, Fr, chunk):
            r = ref[..., :, None, q0:q0 + chunk]
            e = torch.abs(r - other[..., None, :, q0:q0 + chunk]) / r
            parts.append(torch.clamp(e.amin(dim=-2), max=1.0))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

    nxt = F.pad(cands[..., 1:], (0, 1))
    prv = F.pad(cands[..., :-1], (1, 0))
    min_error = torch.minimum(min_err_vs(nxt), min_err_vs(prv))
    i = torch.arange(Fr, device=cands.device)
    interior = (i >= 1) & (i <= Fr - 2)
    remove = (cands != 0) & (min_error > threshold) & interior
    zero = torch.zeros((), dtype=cands.dtype, device=cands.device)
    return torch.where(remove, zero, cands), torch.where(remove, zero, scores)


# ---------------------------------------------------------------------------
# contour fixing
# ---------------------------------------------------------------------------

def search_f0_base(cands: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Highest-score candidate per frame (first one on ties)."""
    idx = torch.argmax(scores, dim=-2, keepdim=True)
    return torch.gather(cands, -2, idx).squeeze(-2)


def fix_step1(f0_base: torch.Tensor, allowed_range: float = 0.008):
    """Zero rapid changes; f0_base (B, n)."""
    n = f0_base.shape[-1]
    p1 = F.pad(f0_base[..., :-1], (1, 0))
    p2 = F.pad(f0_base[..., :-2], (2, 0))
    ref = p1 * 2 - p2
    rapid = ((torch.abs((f0_base - ref) / (ref + F64_EPS)) > allowed_range)
             & (torch.abs((f0_base - p1) / (p1 + F64_EPS)) > allowed_range))
    i = torch.arange(n, device=f0_base.device)
    out = torch.where((i >= 2) & (f0_base != 0) & rapid,
                      torch.zeros_like(f0_base), f0_base)
    out[..., :2] = 0.0
    return out


def _voiced_edges(f0: torch.Tensor):
    """Voiced mask with GetBoundaryList's edge forcing, and its run starts
    and ends."""
    n = f0.shape[-1]
    i = torch.arange(n, device=f0.device)
    v = (f0 != 0) & (i > 0) & (i < n - 1)
    v_prev = F.pad(v[..., :-1], (1, 0))
    v_next = F.pad(v[..., 1:], (0, 1))
    return v, v & ~v_prev, v & ~v_next, i


def _cummax(t):
    return torch.cummax(t, dim=-1).values


def _rev_cummin(t):
    return torch.flip(torch.cummin(torch.flip(t, (-1,)), dim=-1).values, (-1,))


def fix_step2(f0_step1: torch.Tensor, voice_range_minimum: int = 6):
    """Remove short voiced sections."""
    n = f0_step1.shape[-1]
    v, is_start, is_end, i = _voiced_edges(f0_step1)
    minus1 = torch.full_like(i, -1)
    run_start = _cummax(torch.where(is_start, i, minus1))
    run_end = _rev_cummin(torch.where(is_end, i, torch.full_like(i, n + 10)))
    short = v & ((run_end - run_start) < voice_range_minimum)
    return torch.where(short, torch.zeros_like(f0_step1), f0_step1)


def sections(f0: torch.Tensor, max_sections: int):
    """The voiced sections of f0 (..., n) under GetBoundaryList's edge
    forcing, in the JAX package's static form
    (world_tpu/f0/harvest.py::_sections): starts, ends and valid, each
    (..., max_sections); the first ``max_sections`` sections in order, the
    rows past a contour's own count 0 and not valid."""
    _, is_start, is_end, i = _voiced_edges(f0)
    where_at = i.expand(f0.shape)
    starts, rank = compact_rows(where_at, is_start, max_sections)
    ends, _ = compact_rows(where_at, is_end, max_sections)
    valid = (torch.arange(max_sections, device=f0.device)
             < rank[..., -1:])
    return starts, ends, valid


def fix_step3(f0_step2: torch.Tensor, cands: torch.Tensor, scores: torch.Tensor,
              allowed_range: float = 0.18, max_sections: int = 256,
              section_chunk: int = None):
    """Extend + merge voiced sections (harvest.py:357-383) of one utterance,
    f0_step2 (n,) and cands/scores (C, n), or of a batch, (B, n) and
    (B, C, n), on the JAX package's static shapes
    (world_tpu/f0/harvest.py::fix_step3): every utterance has
    ``max_sections`` section rows, those past its own sections masked.

    MergeF0 walks the rows sorted by extended start, the kept ones first,
    ``max_sections`` steps for every utterance; a step whose row is not kept
    changes nothing (the reference's ``lax.scan`` with ``lax.cond``).  Each
    step replaces one interval of the merged contour by the row's values;
    the merge (K5 on the card) reads each row from the chains and takes
    SerachScore over each overlap it decides, so no (B, sections, n) row or
    score is held for it.  ``section_chunk``: hold the (B, sections, n)
    extended contour rows of that many sections at a time to decide which
    sections are kept (their means)."""
    single = f0_step2.dim() == 1
    if single:
        f0_step2, cands, scores = f0_step2[None], cands[None], scores[None]
    B, n = f0_step2.shape
    S = int(max_sections)
    dev, dtype = f0_step2.device, f0_step2.dtype
    starts, ends, valid = sections(f0_step2, S)
    threshold1, threshold2 = 100, 2200.0
    n_steps = threshold1 + 1
    # both directions at once: forward from each end, backward from each start
    shift = torch.cat([torch.ones(S, dtype=torch.int64, device=dev),
                       torch.full((S,), -1, dtype=torch.int64, device=dev)])
    _, val, act, reached = step3_kernels.extend_chains(
        f0_step2.contiguous(), torch.cat([ends, starts], -1),
        torch.cat([torch.clamp(ends + threshold1, max=n - 2),
                   torch.clamp(starts - threshold1, min=1)], -1),
        shift, cands.contiguous(), allowed_range, n_steps)
    r1, r0 = reached[:, :S], reached[:, S:]
    i = torch.arange(n, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    chunk = S if section_chunk is None else max(1, int(section_chunk))

    # the kept sections: those whose extended range is longer than
    # threshold2 over the mean of the extended row over that range
    means = []
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        in_rng = ((i >= r0[:, lo:hi, None]) & (i <= r1[:, lo:hi, None]))
        rows = step3_kernels.section_rows(
            f0_step2, starts, ends, val, act,
            torch.arange(lo, hi, device=dev).expand(B, -1))
        means.append(torch.where(in_rng, rows, zero).sum(dim=-1)
                     / in_rng.sum(dim=-1))
    mean_f0 = means[0] if len(means) == 1 else torch.cat(means, dim=-1)
    keeps = valid & (rdiv(threshold2, mean_f0) < (r1 - r0))

    # MergeF0 (harvest.py:442-486): the rows in order of extended start,
    # the kept ones first
    order = torch.argsort(torch.where(keeps, r0, torch.full_like(r0, n + 10)),
                          dim=-1, stable=True)
    keep_o = torch.gather(keeps, 1, order)
    st_o = torch.gather(r0, 1, order)
    ed_o = torch.gather(r1, 1, order)

    # one launch for the whole merge: K5 rebuilds each kept row from the
    # chains and scores the overlaps itself
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    f0_m, _, _, started = step3_kernels.merge_sections(
        f0_step2.contiguous(), cands.contiguous(), scores.contiguous(),
        starts.contiguous(), ends.contiguous(), val, act, order, st_o, ed_o,
        keep_o, torch.zeros_like(f0_step2), zeros, zeros.clone(),
        torch.zeros(B, dtype=torch.bool, device=dev))
    out = torch.where(started[:, None], f0_m, f0_step2)
    return out[0] if single else out


def fix_step4(f0_step3: torch.Tensor, threshold: int = 9):
    """Fill short unvoiced gaps by linear interpolation; (B, n)."""
    n = f0_step3.shape[-1]
    v, is_start, is_end, i = _voiced_edges(f0_step3)
    big = n + 10
    prev_end = _cummax(torch.where(is_end, i, torch.full_like(i, -1)))
    next_start = _rev_cummin(torch.where(is_start, i, torch.full_like(i, big)))
    pe = F.pad(prev_end[..., :-1], (1, 0), value=-1)
    ns = F.pad(next_start[..., 1:], (0, 1), value=big)
    gap = ~v & (pe >= 0) & (ns < big)
    distance = ns - pe - 1
    tmp0 = torch.gather(f0_step3, -1, pe.clamp(0, n - 1)) + 1
    tmp1 = torch.gather(f0_step3, -1, ns.clamp(0, n - 1)) - 1
    c = (tmp1 - tmp0) / (distance + 1)
    fill = tmp0 + c * (i - pe)
    return torch.where(gap & (distance < threshold), fill, f0_step3)


def smooth_f0(f0: torch.Tensor, max_sections: int = 256,
              kernel: torch.Tensor = None,
              section_chunk: int = None) -> torch.Tensor:
    """Per-voiced-section zero-phase biquad smoothing (harvest.py:533-559) as
    one batched FFT convolution of the constant-extended section rows of f0
    (n,) or (B, n): ``max_sections`` rows an utterance, masked past its own
    sections (world_tpu/f0/harvest.py::smooth_f0, with torch.fft for its
    matrix FFTs).  ``kernel``: the (2R+1,) float64 zero-phase kernel (the
    kept table when None).  ``section_chunk``: convolve that many section
    rows at a time; sections are disjoint, so each sample gets at most one
    nonzero term and the sum over chunks is the single sum."""
    single = f0.dim() == 1
    f0b = f0[None] if single else f0
    R = _SMOOTH_RADIUS
    S = int(max_sections)
    dtype, dev = f0b.dtype, f0b.device
    padded = F.pad(f0b, (R, R))
    m = padded.shape[-1]
    starts, ends, valid = sections(padded, S)
    N = int(2 ** np.ceil(np.log2(m + 2 * R)))
    if kernel is None:
        kernel = table("smooth_kernel", (), smooth_zero_phase_kernel,
                       torch.float64, dev)
    kern = torch.zeros(N, dtype=torch.float64, device=dev)
    kern[:R + 1] = kernel[R:]
    kern[-R:] = kernel[:R]
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    gf = torch.fft.rfft(kern).to(cdtype)
    i = torch.arange(m, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    chunk = S if section_chunk is None else max(1, int(section_chunk))
    smoothed = None
    for lo in range(0, S, chunk):
        st, ed = starts[:, lo:lo + chunk], ends[:, lo:lo + chunk]
        c_st = torch.gather(padded, 1, st)[..., None]
        c_ed = torch.gather(padded, 1, ed)[..., None]
        st, ed = st[..., None], ed[..., None]
        rows = torch.where(i < st, c_st, torch.where(i > ed, c_ed,
                                                     padded[:, None, :]))
        out = torch.fft.irfft(torch.fft.rfft(rows, N) * gf, N)[..., :m]
        keep = (i >= st) & (i <= ed) & valid[:, lo:lo + chunk, None]
        part = torch.where(keep, out, zero).sum(dim=-2)
        smoothed = part if smoothed is None else smoothed + part
    out = smoothed[..., R:m - R]
    return out[0] if single else out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def default_max_candidates(f0_floor: float = 71, f0_ceil: float = 800) -> int:
    n_bands = int(np.ceil(np.log2((f0_ceil * 1.1) / (f0_floor * 0.9)) * 40))
    return int(n_bands / 10 + 0.5)


def default_max_sections(signal_length: int, fs) -> int:
    num_samples = int(1000 * signal_length / fs + 1)
    return max(256, num_samples // 32 + 64)


def warn_capacity(refine_overflow: bool, section_overflow: bool,
                  max_sections: int):
    """Surface static-table saturation, as world_tpu.f0.harvest does."""
    if refine_overflow:
        warnings.warn(
            "harvest: per-frame candidate count exceeded the refinement "
            f"slot capacity ({C2_SLOTS}); some candidates were dropped — "
            "results may degrade on this input", RuntimeWarning, stacklevel=3)
    if section_overflow:
        warnings.warn(
            f"harvest: voiced-section count exceeded max_sections="
            f"{max_sections}; extra sections were ignored — raise "
            f"max_sections", RuntimeWarning, stacklevel=3)


def _n_sections(f: torch.Tensor) -> torch.Tensor:
    v = f != 0
    return (v & ~F.pad(v[..., :-1], (1, 0))).sum(dim=-1)


def stage_units(n_rows: int, n_frames: int, max_half: int, n_slots: int,
                max_sections: int, itemsize: int) -> dict:
    """(bytes per unit, units) of the temporaries of each stage after the
    bands, by :func:`stage_blocking`'s key:

      * ``refine_chunk`` (refine_candidates' ``frame_chunk``): per frame, the
        segment and phase windows of W = 2 max_half + 1 items for every row,
        the phase's three temporaries and the int64 segment index;
      * ``unreliable_chunk`` (remove_unreliable's ``frame_chunk``): per
        frame, three (slots, slots) error temporaries for every row;
      * ``step3_chunk`` (fix_step3's ``section_chunk``, the keeps' means):
        per section of every row, one contour row of n_frames items, the
        row masked to its range and two boolean masks (the merge holds no
        section row);
      * ``smooth_chunk`` (smooth_f0's ``section_chunk``): per section of
        every row, the padded row, its convolution of N items and two half
        spectra of N / 2 + 1 complex items, N the power of two past
        n_frames + 1200, and two boolean masks.
    Both stages hold ``max_sections`` rows an utterance, used or not."""
    W = 2 * max_half + 1
    m = n_frames + 2 * _SMOOTH_RADIUS
    N = int(2 ** np.ceil(np.log2(m + 2 * _SMOOTH_RADIUS)))
    return {"refine_chunk": (W * (8 + 3 * itemsize + 2 * n_rows * itemsize),
                             n_frames),
            "unreliable_chunk": (3 * n_rows * n_slots * n_slots * itemsize,
                                 n_frames),
            "step3_chunk": (n_rows * n_frames * (2 * itemsize + 2),
                            max_sections),
            "smooth_chunk": (n_rows * (itemsize * (m + N + 2 * (N + 2)) + 2 * m),
                             max_sections)}


def stage_blocking(n_rows: int, y_len: int, n_frames: int, n_bands: int,
                   n_taps: int, max_half: int, n_slots: int, max_sections: int,
                   itemsize: int, budget: int = STAGE_BYTES_BUDGET) -> dict:
    """The blocking of every Harvest stage for ``n_rows`` decimated signals
    of ``y_len`` samples and ``n_frames`` 1 ms frames: each argument's
    value, None where the stage's temporaries fit ``budget`` bytes whole,
    else the chunk that fits half of it (:func:`.._backend.chunk_size` says
    why half).  ``band_chunk`` and ``block`` are
    :func:`..dsp.fir.band_blocking`'s, the others follow
    :func:`stage_units`."""
    band_chunk, block = band_blocking(n_rows, n_bands, y_len, n_taps, itemsize,
                                      budget)
    out = {"band_chunk": band_chunk, "block": block}
    units = stage_units(n_rows, n_frames, max_half, n_slots, max_sections,
                        itemsize)
    for name, (unit_bytes, count) in units.items():
        out[name] = chunk_size(unit_bytes, count, budget)
    return out


def harvest_core(x: torch.Tensor, fs: int, f0_floor: float, f0_ceil: float,
                 frame_period: float, max_candidates: int, max_sections: int,
                 debug_outputs: bool = False, tables: dict = None,
                 blocking: dict = None) -> dict:
    """Harvest on rows x (B, n).  ``tables`` is :func:`harvest_tables`'
    dict (built when None).  ``blocking``: the stages' blocking, a dict with
    :func:`stage_blocking`'s keys (a missing key is None, one block);
    sized by :func:`stage_blocking` when None."""
    if tables is None:
        tables = harvest_tables(fs, f0_floor, f0_ceil, x.dtype, x.device)
    y, actual_fs = downsample(x, fs, 8000, h=tables["decimator_ir"])
    return harvest_decimated(y, actual_fs, x.shape[1], fs, f0_floor, f0_ceil,
                             frame_period, max_candidates, max_sections,
                             debug_outputs, tables, blocking)


def harvest_decimated(y: torch.Tensor, actual_fs: float, signal_length: int,
                      fs: int, f0_floor: float, f0_ceil: float,
                      frame_period: float, max_candidates: int,
                      max_sections: int, debug_outputs: bool = False,
                      tables: dict = None, blocking: dict = None) -> dict:
    """Harvest from the downsampler on: rows y (B, ny) of
    :func:`downsample` at ``actual_fs``, from signals of ``signal_length``
    samples at ``fs``.  Arguments and outputs as :func:`harvest_core`'s."""
    B = y.shape[0]
    dtype, dev = y.dtype, y.device
    num_samples = int(1000 * signal_length / fs + 1)
    basic_tp = frame_grid(num_samples, 1.0, dev).to(dtype)
    bfl = boundary_f0_list(f0_floor, f0_ceil)
    if tables is None:
        tables = harvest_tables(fs, f0_floor, f0_ceil, dtype, dev)
    max_half, _ = refinement_geometry(actual_fs, f0_floor)
    C = 7 * max_candidates             # overlap_candidates' rows
    C2 = min(C2_SLOTS, C)
    if blocking is None:
        blocking = stage_blocking(B, y.shape[1], num_samples, len(bfl),
                                  tables["band_bank"].shape[1], max_half, C2,
                                  max_sections, y.element_size())
    blk = blocking.get
    raw = raw_band_candidates(y, actual_fs, tables["band_bank"],
                              tables["band_bias"], bfl, basic_tp,
                              f0_floor, f0_ceil, blk("band_chunk"), blk("block"))
    cands0, _ = detect_candidates(raw, max_candidates)
    cands1 = overlap_candidates(cands0)

    # compact the sparse candidate grid to C2 slots per frame, in order
    nzT = (cands1 != 0).transpose(-1, -2)                  # (B, F, C)
    compactT, rankT = compact_rows(cands1.transpose(-1, -2), nzT, C2)
    compact = compactT.transpose(-1, -2).contiguous()      # (B, C2, F)
    refine_overflow = rankT[..., -1].amax(dim=-1) > C2
    ref_c, score_c = refine_candidates(y, actual_fs, basic_tp, compact,
                                       f0_floor, f0_ceil, max_half,
                                       (tables["refine_cos"],
                                        tables["refine_sin"]),
                                       blk("refine_chunk"))
    cands3, scores3 = remove_unreliable(ref_c, score_c,
                                        frame_chunk=blk("unreliable_chunk"))

    f0_base = search_f0_base(cands3, scores3)
    f0_step1 = fix_step1(f0_base, 0.008)
    f0_step2 = fix_step2(f0_step1, 6)
    f0_step3 = fix_step3(f0_step2, cands3, scores3, 0.18, max_sections,
                         blk("step3_chunk"))
    f0_step4 = fix_step4(f0_step3, 9)
    vuv_full = (f0_step4 != 0).to(dtype)
    smoothed = smooth_f0(f0_step4, max_sections, tables["smooth_kernel"],
                         blk("smooth_chunk"))
    section_overflow = torch.maximum(_n_sections(f0_step2),
                                     _n_sections(f0_step4)) > max_sections

    out_samples = int(1000 * signal_length / fs / frame_period + 1)
    tp_out = frame_grid(out_samples, frame_period, dev).to(dtype, copy=True)
    idx = torch.clamp(matlab_round_half(tp_out * 1000),
                      max=smoothed.shape[-1] - 1).to(torch.int64)
    out = {
        "temporal_positions": tp_out,
        "f0": smoothed[:, idx],
        "vuv": vuv_full[:, idx],
        "_refine_overflow": refine_overflow,
        "_section_overflow": section_overflow,
    }
    if debug_outputs:
        def scatter_back(sf):
            back_ok = nzT & (rankT <= C2)
            slot = torch.clamp(rankT - 1, 0, C2 - 1)
            got = torch.gather(sf.transpose(-1, -2), -1, slot)
            return torch.where(back_ok, got, torch.zeros_like(got)).transpose(-1, -2)

        out.update({
            "_raw_candidates": raw,
            "_cands_detected": cands0,
            "_cands_overlap": cands1,
            "_cands_refined": scatter_back(ref_c),
            "_scores_refined": scatter_back(score_c),
            "_cands_clean": scatter_back(cands3),
            "_scores_clean": scatter_back(scores3),
            "_f0_base": f0_base,
            "_f0_step1": f0_step1,
            "_f0_step2": f0_step2,
            "_f0_step3": f0_step3,
            "_f0_step4": f0_step4,
            "_smoothed": smoothed,
        })
    return out


def harvest(x: torch.Tensor, fs: int, f0_floor: float = 71,
            f0_ceil: float = 800, frame_period: float = 5,
            max_candidates: int = None, max_sections: int = None,
            check_capacity: bool = True, debug_outputs: bool = False,
            blocking: dict = None) -> dict:
    """Harvest F0 estimation of one utterance x (n,) or a batch (B, n).
    Outputs keep the input's batch shape.  ``blocking``: see
    :func:`harvest_core`; ``{}`` runs every stage in one block."""
    single = x.dim() == 1
    xb = x[None] if single else x
    if max_candidates is None:
        max_candidates = default_max_candidates(f0_floor, f0_ceil)
    if max_sections is None:
        max_sections = default_max_sections(xb.shape[1], fs)
    out = harvest_core(xb, int(fs), float(f0_floor), float(f0_ceil),
                       float(frame_period), int(max_candidates),
                       int(max_sections), debug_outputs=debug_outputs,
                       blocking=blocking)
    if check_capacity:
        warn_capacity(host_flag(out["_refine_overflow"].any()),
                      host_flag(out["_section_overflow"].any()), max_sections)
    if single:
        out = {k: (v if k == "temporal_positions" else v[0])
               for k, v in out.items()}
    return out
