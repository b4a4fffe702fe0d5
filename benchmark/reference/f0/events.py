"""Zero-crossing interval interpolation: the plain PyTorch version of K1.

Port of world_tpu/f0/events.py (batched_interval_interp :85,
interval_select :137, four_event_interp :173).  The JAX twin builds nine
dense running max/min "k-th previous / next crossing" chains per row; the
same values come here from the row's crossings compacted in order and
indexed through a running crossing count — the algorithm of the CUDA event
engine (csrc/event_engine.cu), in stock tensor ops.
"""
from fractions import Fraction

import torch

from .._backend import scalar, sdiv

N_PREV = 4
N_NEXT = 5
# rows of one K1 launch: a CUDA grid's second extent ends at 65,535
MAX_EVENT_ROWS = 65535


def launch_pieces(n_rows: int, n_bands: int, band_chunk: int = None):
    """(row_piece, chunk): how the band stages of Harvest and DIO cut
    ``n_rows`` signals times ``n_bands`` bands into K1 launches of at most
    MAX_EVENT_ROWS event rows (four per band signal).  ``chunk`` bands at a
    time: ``band_chunk`` (every band when None), fewer where the rows ask
    for it; ``row_piece`` is n_rows unless one band of every row is already
    too much."""
    row_piece = max(1, min(n_rows, MAX_EVENT_ROWS // 4))
    chunk = n_bands if band_chunk is None else max(1, int(band_chunk))
    return row_piece, max(1, min(chunk, MAX_EVENT_ROWS // (4 * row_piece)))


def stride_fraction(stride_samples: float):
    """(pnum, qden): samples per frame as the rational the frame grid uses."""
    frac = Fraction(float(stride_samples)).limit_denominator(1000)
    return int(frac.numerator), int(frac.denominator)


def crossings(x: torch.Tensor):
    """Negative-going crossing mask (S, n) and the sub-sample position of
    every sample's would-be crossing, (i+1) - x/(x_next - x)."""
    n = x.shape[-1]
    x_next = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    mask = (x_next * x < 0) & (x_next < x)
    den = x_next - x
    idx1 = torch.arange(1, n + 1, dtype=x.dtype, device=x.device)
    fine = idx1[None, :] - x / torch.where(den == 0, torch.ones_like(den), den)
    return mask, fine


def interval_select(E: torch.Tensor, t_frames: torch.Tensor, fs: float,
                    n_prev: int = N_PREV) -> torch.Tensor:
    """Pick the crossing interval holding each query and linearly
    interpolate/extrapolate its f0.  E: (S, Q, n_prev+n_next) ascending edge
    positions in 1-based samples, +-inf where an edge is missing."""
    fs_t = scalar(fs, E)
    valid = torch.isfinite(E)
    tq = t_frames[None, :]
    T = (tq * fs_t)[..., None]
    mids = (E[..., :-1] + E[..., 1:]) / 2.0
    diffs = E[..., 1:] - E[..., :-1]
    f0s = fs_t / torch.where(diffs <= 0, torch.ones_like(diffs), diffs)
    mid_valid = valid[..., :-1] & valid[..., 1:]

    left_invalid = (~valid[..., :n_prev]).sum(-1)
    v_count = mid_valid.sum(-1)
    raw_cnt = (mid_valid & (mids <= T)).sum(-1) + left_invalid
    hi_v = left_invalid + torch.clamp(v_count, min=2) - 1
    j = torch.minimum(torch.maximum(raw_cnt - 1, left_invalid), hi_v - 1)
    n_mid = mids.shape[-1]

    def sel(arr, jj):
        inside = (jj >= 0) & (jj < n_mid)
        got = torch.gather(arr, -1, jj.clamp(0, n_mid - 1)[..., None])[..., 0]
        return torch.where(inside, got, arr[..., 0])

    x0 = sel(mids, j) / fs_t
    x1 = sel(mids, j + 1) / fs_t
    y0 = sel(f0s, j)
    y1 = sel(f0s, j + 1)
    dx = x1 - x0
    return y0 + (y1 - y0) / torch.where(dx == 0, torch.ones_like(dx), dx) * (tq - x0)


def edge_table(signals: torch.Tensor, n_frames: int, stride_samples: float,
               n_prev: int = N_PREV, n_next: int = N_NEXT):
    """(E (S, Q, n_prev+n_next), n_edges (S,)): for frame q with sample
    g = floor(q*pnum/qden), the n_prev last crossings at or before sample
    clip(g-2) and the n_next first crossings at or after clip(g-1)."""
    x = signals
    S, n = x.shape
    dev = x.device
    mask, fine = crossings(x)
    csum = torch.cumsum(mask.to(torch.int64), dim=1)      # crossings <= p
    cnt = csum[:, -1]
    width = max(int(cnt.max()), 1) if S else 1
    rows, cols = mask.nonzero(as_tuple=True)               # row-major order
    comp = torch.zeros((S, width), dtype=x.dtype, device=dev)
    comp[rows, csum[rows, cols] - 1] = fine[rows, cols]

    pnum, qden = stride_fraction(stride_samples)
    g = torch.arange(n_frames, device=dev, dtype=torch.int64) * pnum // qden
    p_prev = (g - 2).clamp(0, n - 1)
    p_next = (g - 1).clamp(0, n - 1)
    k_prev = csum[:, p_prev]                                # (S, Q)
    k_next = csum[:, p_next] - mask[:, p_next].to(torch.int64)

    inf = torch.full((), float("inf"), dtype=x.dtype, device=dev)
    cols_E = []
    for j in range(n_prev):                                  # ascending
        k = k_prev - n_prev + j
        got = torch.gather(comp, 1, k.clamp(0, width - 1))
        cols_E.append(torch.where(k >= 0, got, -inf))
    for j in range(n_next):
        k = k_next + j
        got = torch.gather(comp, 1, k.clamp(0, width - 1))
        cols_E.append(torch.where(k < cnt[:, None], got, inf))
    return torch.stack(cols_E, dim=-1), cnt


def batched_interval_interp(signals: torch.Tensor, fs: float,
                            t_frames: torch.Tensor, stride_samples: float):
    """Plain K1: for each row, negative-going crossings -> interval
    (location, f0) lists -> linear interp (end-slope extrapolation) at the
    uniform frame grid ``t_frames``.  Returns (f0 (S, Q), n_intervals (S,))
    with n_intervals int32."""
    E, cnt = edge_table(signals, t_frames.shape[0], stride_samples)
    out = interval_select(E, t_frames, fs)
    return out, torch.clamp(cnt - 1, min=0).to(torch.int32)


def event_rows(filtered: torch.Tensor) -> torch.Tensor:
    """The (4B, n) rows of the four event types of (B, n) band signals:
    x, -x, dx, -dx.  Repeating the last difference can never add a crossing
    (x_next == x there)."""
    d = torch.diff(filtered, dim=1)
    d_pad = torch.cat([d, d[:, -1:]], dim=1)
    return torch.cat([filtered, -filtered, d_pad, -d_pad], dim=0).contiguous()


def _four_event_parts(filtered: torch.Tensor, fs: float, t_frames: torch.Tensor,
                      stride_samples: float):
    """K1 over the four event types of (B, n) rows: the four (B, Q)
    interpolated f0s, their mean and the (B,) usable flag (every type has
    at least 3 intervals)."""
    from ..ops.edge_interp import interval_interp

    B = filtered.shape[0]
    interp, m = interval_interp(event_rows(filtered), fs, t_frames,
                                stride_samples)
    parts = [interp[i * B:(i + 1) * B] for i in range(4)]
    counts = torch.stack([m[i * B:(i + 1) * B] for i in range(4)])
    usable = (counts >= 3).all(dim=0)
    mean_f0 = (((parts[0] + parts[1]) + parts[2]) + parts[3]) / 4.0
    return parts, mean_f0, usable


def four_event_interp(filtered: torch.Tensor, fs: float, t_frames: torch.Tensor,
                      stride_samples: float):
    """Harvest's 4-event-type candidate mean for a batch of bands.

    filtered: (B, n) band-filtered rows.  Returns (mean_f0 (B, Q),
    usable (B,)), the mean zeroed on unusable rows."""
    _, mean_f0, usable = _four_event_parts(filtered, fs, t_frames,
                                           stride_samples)
    return torch.where(usable[:, None], mean_f0, torch.zeros_like(mean_f0)), usable


def four_event_stats(filtered: torch.Tensor, fs: float, t_frames: torch.Tensor,
                     stride_samples: float):
    """DIO's 4-event-type candidates (get_f0_candidates, dio.py:156-185):
    (mean_f0, deviation) (B, Q) and usable (B,).  The deviation is the
    sample standard deviation (ddof=1) of the four f0s; unusable rows read
    mean 0 and deviation 1000."""
    parts, mean_f0, usable = _four_event_parts(filtered, fs, t_frames,
                                               stride_samples)
    sq = [(p - mean_f0) ** 2 for p in parts]
    dev = torch.sqrt(sdiv(((sq[0] + sq[1]) + sq[2]) + sq[3], 3.0))
    keep = usable[:, None]
    return (torch.where(keep, mean_f0, torch.zeros_like(mean_f0)),
            torch.where(keep, dev, torch.full_like(dev, 1000.0)), usable)
