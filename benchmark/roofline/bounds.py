"""The least time of each hand-written kernel's work, K1-K7, counted from
its operands: a copy of chip_smoke.py's bound functions (``k1_bound`` ...
``k5_bound``, ``d4c_bounds`` with ``k3_groups``, ``merge_trace``,
``d4c_reads``, ``folded_bins`` and ``d4c_window_samples``), kept here so
that the yardstick does not move with the program.  They count the work
whatever implements it: each needed input byte read once, each output byte
written once, and the operations the function needs on this run's data.

``band_geometry`` comes from the benchmark's frozen reference, not from the
program.
"""
import json
from pathlib import Path

import numpy as np
import torch

from reference.ops.d4c_spectra import band_geometry

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
HBM_BYTES_PER_S = PEAKS["hbm_bytes_per_s"]
F32_OPS_PER_S = PEAKS["f32_ops_per_s"]

# Operations counted per unit of work, fixed when the kernels were first
# timed, so that their times compare across designs.  K1: the crossing test
# and position of each input sample (4), and for each (row, frame) the
# search for its edges and interval_select's arithmetic (64).  K2: for each
# sample of a slot's own window, the two window cosines and their blend, the
# two windowed samples and 24 multiply-adds (60).
K1_OPS_PER_SAMPLE, K1_OPS_PER_FRAME = 4, 64
K2_OPS_PER_WINDOW_SAMPLE = 60
# K3: the carry's test and update at every frame (4), and at each frame an
# extension runs through, the prediction (3), one subtraction, absolute
# value and comparison per candidate, and the relative-error test (5).
K3_OPS_PER_FRAME, K3_OPS_PER_EXTENSION_FRAME, K3_OPS_PER_CANDIDATE = 4, 8, 3
# K4: at each active step of a chain, the floor of the reference and the
# carry's update (6), and per candidate a subtraction, an absolute value, a
# division and a comparison (4).  K5: at each frame of a deciding overlap,
# per candidate its comparisons with the contour's and the row's values (2),
# and the two float64 additions of the sums (2; counted by merge_trace).
K4_OPS_PER_STEP, K4_OPS_PER_CANDIDATE = 6, 4
K5_OPS_PER_CANDIDATE, K5_OPS_PER_FRAME = 2, 2
# K6/K7: a window sample's products (24), a bin's arithmetic (10), a running
# sum's step (4).
D4C_OPS_PER_WINDOW_SAMPLE, D4C_OPS_PER_BIN, D4C_OPS_PER_SUM = 24, 10, 4


def bound(n_bytes: float, n_ops: float):
    """(least ms, what bounds it) for moving n_bytes and doing n_ops."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(rows, tq):
    """K1 reads the rows and frame times once and writes f0 (S, Q) and the
    counts (S,)."""
    S, n = rows.shape
    Q = tq.shape[0]
    isz = rows.element_size()
    return bound((S * n + Q + S * Q) * isz + 4 * S,
                 K1_OPS_PER_SAMPLE * S * n + K1_OPS_PER_FRAME * S * Q)


def k2_bound(ops):
    """K2 reads seg, phase (F, W), the candidates (C, F) and the DFT table,
    and writes refined f0 and score (C, F); the work is each non-empty
    slot's own window, as this run's candidates set it."""
    f0 = ops["f0"]
    F, W = ops["seg"].shape
    C = f0.shape[0]
    isz = ops["seg"].element_size()
    live = f0[f0 > 1e-6].double()
    half = torch.clamp(torch.ceil(3 * ops["afs"] / live / 2), max=ops["max_half"])
    window_samples = float((2 * half + 1).sum())
    return bound((2 * F * W + 3 * C * F + 2 * ops["S"]) * isz,
                 K2_OPS_PER_WINDOW_SAMPLE * window_samples)


def k3_groups(args, out) -> dict:
    """How K3 splits one scan, read off its operands and its output on the
    host (the carry's rule): the flags, the heads (the kernel's rule), the
    most flags in one group, the most frames one group extends through (its
    chain of dependent picks), and the frames extended in all (the work this
    run's data needs), over all rows."""
    _, flags, limits, _, _, backward = args
    flags, limits = flags.cpu().numpy(), limits.cpu().numpy()
    out = out.cpu().numpy()
    n = out.shape[1]
    order = list(range(n - 1, -1, -1) if backward else range(n))
    st = {"flags": 0, "heads": 0, "largest_group": 0, "longest_chain": 0,
          "extended": 0}
    for b in range(out.shape[0]):
        reach = (n - limits[b]) if backward else limits[b]
        fl = [s for s, p in enumerate(order) if flags[b, p]]
        group, sizes = {}, []
        for i, s in enumerate(fl):
            prev = fl[i - 1] if i else None
            if prev is None or (prev < s - 1 and reach[order[prev]] < s - 1):
                sizes.append(0)
            sizes[-1] += 1
            group[s] = len(sizes) - 1
        chain = [0] * len(sizes)
        active, limit, g = False, 0, None
        for s, p in enumerate(order):
            in_ext = active and (p >= limit - 1 if backward else p <= limit)
            if in_ext:
                chain[g] += 1
            active = in_ext and out[b, p] != 0
            if flags[b, p]:
                active, limit, g = True, int(limits[b, p]), group[s]
        st["flags"] += len(fl)
        st["heads"] += len(sizes)
        st["largest_group"] = max([st["largest_group"]] + sizes)
        st["longest_chain"] = max([st["longest_chain"]] + chain)
        st["extended"] += sum(chain)
    return st


def k3_bound(args, out):
    """K3 reads the contour and the flags at every frame, the int64 limit of
    each flag and the C candidates of each frame an extension runs through,
    and writes the contour; its operations are the carry's at every frame
    and the candidates' search at the frames extended.  The flags and the
    frames extended are this run's (k3_groups)."""
    base, _, _, cands, _, _ = args
    B, n = base.shape
    C = cands.shape[1]
    isz = base.element_size()
    st = k3_groups(args, out)
    return bound(B * n * (2 * isz + 1) + 8 * st["flags"]
                 + st["extended"] * C * isz,
                 K3_OPS_PER_FRAME * B * n + st["extended"]
                 * (K3_OPS_PER_EXTENSION_FRAME + K3_OPS_PER_CANDIDATE * C))


def merge_trace(args, reads: dict = None) -> list:
    """The steps of one K5 launch, replayed on the host: for each kept step
    (batch row, step, branch, frames summed, frames copied).  ``reads``, a
    dict, gets what the launch must read, summed over the utterances: the
    distinct frames of its deciding overlaps where the row and the contour
    differ (``overlap_frames``), the distinct (candidate, frame) scores
    equal to a value there (``score_hits``), the distinct frames whose row
    value it needs (``row_frames``, ``chain_frames`` of them from a chain),
    the frames it writes (``copied_frames``), its kept steps
    (``kept_steps``) and the frames it scores, overlaps repeated
    (``scored_frames``)."""
    (f0, cands, scores, starts, ends, val, act, order, st, ed, keep, f0_m,
     cur_st, cur_ed, started) = (
        a.double().cpu().numpy() if a.dtype.is_floating_point else a.cpu().numpy()
        for a in args)
    B, C, n = cands.shape
    S, n_steps = starts.shape[1], val.shape[2]
    i = np.arange(n)
    counts = dict.fromkeys(("overlap_frames", "score_hits", "row_frames",
                            "chain_frames", "copied_frames", "kept_steps",
                            "scored_frames"), 0)
    trace = []

    def sscore(b, v, a, z):
        eq = cands[b, :, a:z + 1] == v[None, a:z + 1]
        return np.where(eq, scores[b, :, a:z + 1], 0.0).max(axis=0), eq

    for b in range(B):
        m, cs, ce, on = (f0_m[b].copy(), int(cur_st[b]), int(cur_ed[b]),
                         bool(started[b]))
        ov_at = np.zeros(n, bool)
        hits = np.zeros((C, n), bool)
        row_at = np.zeros(n, bool)
        chain_at = np.zeros(n, bool)
        copy_at = np.zeros(n, bool)
        for k in range(order.shape[1]):
            if not keep[b, k]:
                continue
            counts["kept_steps"] += 1
            s2_, e2 = int(st[b, k]), int(ed[b, k])
            sec = int(order[b, k])
            sst, sed = int(starts[b, sec]), int(ends[b, sec])
            kf, kb = i - sed - 1, sst - i - 1
            in_f = (kf >= 0) & (kf < n_steps)
            in_b = (kb >= 0) & (kb < n_steps)
            from_f = in_f & act[b, sec, kf.clip(0, n_steps - 1)]
            from_b = in_b & act[b, S + sec, kb.clip(0, n_steps - 1)]
            row = np.where((i >= sst) & (i <= sed), f0[b], np.where(
                from_f, val[b, sec, kf.clip(0, n_steps - 1)], np.where(
                    from_b, val[b, S + sec, kb.clip(0, n_steps - 1)], 0.0)))
            fresh = not on or s2_ > ce
            extends = fresh or not (cs <= s2_ and ce >= e2)
            lo, summed = s2_, 0
            kind = ("start" if not on else "disjoint" if fresh
                    else "contained" if not extends else None)
            step_at = np.zeros(n, bool)
            if kind is None:
                a, z = max(s2_, 0), min(ce, n - 1)
                summed = max(0, z - a + 1)
                s1 = s2 = 0.0
                if summed:
                    g1, eq1 = sscore(b, m, a, z)
                    g2, eq2 = sscore(b, row, a, z)
                    s1, s2 = g1.sum(), g2.sum()
                    differ = np.zeros(n, bool)
                    differ[a:z + 1] = ~(m[a:z + 1] == row[a:z + 1])
                    ov_at |= differ
                    step_at[a:z + 1] = True
                    hits[:, a:z + 1] |= (eq1 | eq2) & differ[None, a:z + 1]
                    counts["scored_frames"] += int(differ.sum())
                kind = "s1>s2" if s1 > s2 else "s1<s2" if s1 < s2 else "s1=s2"
                lo = ce if s1 > s2 else s2_
            copied = 0
            if extends:
                a, z = max(lo, 0), min(e2, n - 1)
                copied = max(0, z - a + 1)
                m[a:z + 1] = row[a:z + 1]
                step_at[a:z + 1] = copy_at[a:z + 1] = True
            row_at |= step_at
            chain_at |= step_at & (from_f | from_b) & ~((i >= sst) & (i <= sed))
            trace.append((b, k, kind, summed, copied))
            cs, ce, on = (s2_ if fresh else cs), (e2 if extends else ce), True
        counts["overlap_frames"] += int(ov_at.sum())
        counts["score_hits"] += int(hits.sum())
        counts["row_frames"] += int(row_at.sum())
        counts["chain_frames"] += int(chain_at.sum())
        counts["copied_frames"] += int(copy_at.sum())
    if reads is not None:
        reads.update(counts)
    return trace


def k4_bound(args, out):
    """K4 reads the chains' origins, limits and shifts, f0 at each origin and
    the candidates of each frame its chains visit (once), and writes each
    step's position, value and flag and each shifted origin; its operations
    are SelectBestF0's at each active step."""
    f0, origin, _, _, cands, _, n_steps = args
    B, R = origin.shape
    C, isz = cands.shape[1], f0.element_size()
    visited = sum(int(torch.unique(out[0][b].clamp(0, f0.shape[1] - 1)).numel())
                  for b in range(B))
    active = int(out[2].sum())
    return bound(B * R * (8 + 8 + isz) + R * 8 + visited * C * isz
                 + B * R * n_steps * (8 + isz + 1) + B * R * 8,
                 active * (K4_OPS_PER_STEP + K4_OPS_PER_CANDIDATE * C))


def k5_bound(args):
    """K5 reads, once each: the candidates of every frame of its deciding
    overlaps where the row and the contour differ (C items a frame) and the
    scores of those equal to the contour's or the row's value there, the
    contour over those frames, each row value it needs (f0, or a chain's
    value and flag), and each kept step's section, bounds and flag with the
    section's start and end (41 bytes, and the flag of the first step not
    kept); it writes the contour where it copies and the carried state (17
    bytes an utterance, read too).  Its operations: at each such frame of
    each deciding overlap (repeated where overlaps repeat), two comparisons
    a candidate and two float64 additions (merge_trace counts them all).
    ``args`` hold the carried state as it was before the launch."""
    cands = args[1]
    B, C, _ = cands.shape
    isz = cands.element_size()
    r = {}
    merge_trace(args, r)
    n_bytes = (r["overlap_frames"] * (C + 1) * isz + r["score_hits"] * isz
               + r["row_frames"] * isz + r["chain_frames"]
               + r["copied_frames"] * isz + r["kept_steps"] * 41 + B
               + 2 * B * 17)
    return bound(n_bytes, r["scored_frames"] * (K5_OPS_PER_CANDIDATE * C
                                                + K5_OPS_PER_FRAME))


def d4c_window_samples(a: dict) -> float:
    """The window samples inside the mask over all frames (half = floor(2 fs
    / f0 + 0.5), at most max_half)."""
    half = torch.clamp(torch.floor(2.0 * a["fs"] / a["f0"].double() + 0.5),
                       max=a["max_half"])
    return float((2 * half + 1).sum())


def folded_bins(first, width: int, ext: int, N: int) -> int:
    """The distinct half-spectrum bins that the bands [lo - ext, lo + width +
    ext) of the mirrored spectrum (length N, read cyclically) cover."""
    q = np.mod(np.concatenate([np.arange(lo - ext, lo + width + ext)
                               for lo in first]), N)
    return int(np.unique(np.where(q > N // 2, N - q, q)).size)


def d4c_reads(a: dict) -> dict:
    """The values of the operands that K6, K7 and the plain sub-stages need,
    summed over the frames: "k6": the slab samples of K6's two windows
    (inside the mask, each shifted by +-T0/4, their union); "k7": the inner
    slab's 2 half + 1; "bands": the group-delay bins the bands read
    (folded); "k7_centroid": the centroid bins K7's bands depend on through
    the group delay's two smoothings."""
    fs, N, mh, margin = float(a["fs"]), a["fft_size"], a["max_half"], a["margin"]
    f0 = a["f0"].double().cpu().numpy()
    t = a["t"].double().cpu().numpy()
    half = np.minimum(np.floor(2.0 * fs / f0 + 0.5), mh)
    base = np.floor(t * fs + 0.501) + 1.0
    sh = [np.clip(np.floor((t + q) * fs + 0.501) + 1.0 - base + margin, 0,
                  2 * margin) for q in (0.25 / f0, -0.25 / f0)]
    win = 2 * half + 1
    wl = a["window"].shape[0]
    first = band_geometry(fs, N, a["fi"], a["n_ap"], wl)["first"]
    width = 2 * (wl // 2) + 1
    ext = np.ceil(0.75 * f0 / (fs / N)).astype(np.int64) + 2
    e, n = np.unique(ext, return_counts=True)
    return {"k6": float((win + np.minimum(np.abs(sh[0] - sh[1]), win)).sum()),
            "k7": float(win.sum()),
            "bands": f0.shape[0] * folded_bins(first, width, 0, N),
            "k7_centroid": float(sum(c * folded_bins(first, width, int(x), N)
                                     for x, c in zip(e, n)))}


def d4c_bounds(a: dict) -> dict:
    """The least time of K6 (``d4c_centroid``), K7 (``d4c_band_ap``) and
    the plain sub-stages they replace, on one D4C call's operands ({name:
    (ms, what bounds it)}): the values each needs of its inputs
    (:func:`d4c_reads`) read once, each output written once, and the
    operations of the function (a real FFT of N points counted as a complex
    one of N / 2 and its split, 5 (N/2) log2(N/2) + 6 N; K6's two real FFTs
    a shift as one complex FFT of N points)."""
    R = a["slab"].shape[0]
    N, n_ap = a["fft_size"], a["n_ap"]
    nb, kl = N // 2 + 1, min(N // 2 + 1, 256)
    wl = a["window"].shape[0]
    isz = a["slab"].element_size()
    L = 2 * band_geometry(a["fs"], N, a["fi"], n_ap, wl)["span"] + nb + 1
    win = D4C_OPS_PER_WINDOW_SAMPLE * d4c_window_samples(a)
    real_fft = 5 * (N // 2) * np.log2(N // 2) + 6 * N
    smooth = D4C_OPS_PER_SUM * (L + 2 * nb)
    ops = {"d4c_centroid": 2 * win + R * (2 * 5 * N * np.log2(N)
                                          + D4C_OPS_PER_BIN * (2 * nb + kl)),
           "smoothed_power_spectrum_half": win + R * (
               real_fft + D4C_OPS_PER_BIN * (nb + kl) + smooth),
           "static_group_delay_half": R * (D4C_OPS_PER_BIN * nb + 2 * smooth),
           "coarse_aperiodicity": R * n_ap * (wl + real_fft + D4C_OPS_PER_SUM * nb)}
    reads = d4c_reads(a)
    nbytes = {"d4c_centroid": (reads["k6"] + R * (1 + nb) + N) * isz + 8 * R,
              "smoothed_power_spectrum_half": (reads["k7"] + R * (1 + nb)) * isz
              + 8 * R,
              "static_group_delay_half": R * (3 * nb + 1) * isz,
              "coarse_aperiodicity": (reads["bands"] + R * n_ap + wl) * isz}
    ops["d4c_band_ap"] = sum(ops[k] for k in ("smoothed_power_spectrum_half",
                                              "static_group_delay_half",
                                              "coarse_aperiodicity"))
    nbytes["d4c_band_ap"] = ((reads["k7"] + reads["k7_centroid"]
                              + R * (1 + n_ap) + wl + N) * isz + 8 * R
                             + 4 * n_ap)
    return {k: bound(nbytes[k], ops[k]) for k in ops}
