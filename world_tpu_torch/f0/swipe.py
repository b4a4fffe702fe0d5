"""SWIPE' pitch estimator (port of world_tpu/f0/swipe.py), batched over
utterances of one length.

Everything that does not depend on the signal is built on the host in
float64: the cubic-spline resampling of each octave's spectrum onto the ERB
grid as a linear operator, the prime-harmonic kernels as a matrix, the
octave blending weights, and the time interpolation's indices and weights.
On the device each octave is a framed ``torch.fft.rfft``, two matrix
products and one gather; the parabolic refinement is a closed form on the
log-spaced candidate grid.
"""
import functools
import math

import numpy as np
import torch

from .._backend import F64_EPS, resolve_device
from ..dsp.windows import np_hanning_matlab
from ..tables import cached, device_key, table

DLOG2P, DERBS, K_WINDOW = 1 / 96, 0.1, 2


def _hz2erbs(hz):
    return 21.4 * np.log10(1 + hz / 229.0)


def _erbs2hz(erbs):
    return (10 ** (erbs / 21.4) - 1) * 229.0


def _primes(n):
    if n < 2:
        return []
    sieve = np.ones(n + 1, bool)
    sieve[:2] = False
    for p in range(2, int(n ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p::p] = False
    return list(np.nonzero(sieve)[0])


def _kernel_matrix(fERBs, pc):
    """pitchStrengthOneCandidate for all candidates (swipe.py:126-145)."""
    K = np.zeros((len(pc), len(fERBs)))
    for j, p in enumerate(pc):
        n = int(np.fix(fERBs[-1] / p - 0.75))
        k = np.zeros(len(fERBs))
        q = fERBs / p
        for i in [1] + _primes(n):
            a = np.abs(q - i)
            pk = a < 0.25
            k[pk] = np.cos(2 * np.pi * q[pk])
            v = (0.25 < a) & (a < 0.75)
            k[v] += np.cos(2 * np.pi * q[v]) / 2
        k *= np.sqrt(1.0 / fERBs)
        k /= np.linalg.norm(k[k > 0])
        K[j] = k
    return K


@functools.lru_cache(maxsize=4)
def _static_config(fs: int, plim: tuple, dlog2p: float, dERBs: float, K: int):
    """The candidate grid and, per octave (window size), the spline operator
    A (bins, nERB), the candidate range j, the blending weights mu, the
    kernel matrix K and the analysis window, all numpy float64."""
    from scipy.interpolate import interp1d

    log2pc = np.arange(np.log2(plim[0]) * 96, np.log2(plim[-1]) * 96) * dlog2p
    pc = 2.0 ** log2pc
    logWs = [int(math.floor(v + 0.5)) for v in np.log2(4 * K * fs / np.asarray(plim))]
    ws = (2 ** np.arange(logWs[0], logWs[1] - 1, -1)).astype(int)
    p0 = 4 * K * fs / ws
    d = 1 + log2pc - np.log2(4 * K * fs / ws[0])
    fERBs = _erbs2hz(np.arange(_hz2erbs(pc[0] / 4), _hz2erbs(fs / 2), dERBs))

    per_octave = []
    for i, w in enumerate(ws):
        freqs = np.arange(w // 2 + 1) * fs / w
        # cubic-spline resampling fERBs <- freqs is linear in the samples
        A = interp1d(freqs, np.eye(len(freqs)), kind="cubic", axis=-1)(fERBs)
        # candidate selection (swipe.py:45-62): d is static
        if i == len(ws) - 1:
            j = np.nonzero(d - (i + 1) > -1)[0]
            kk = np.nonzero(d[j] - (i + 1) < 0)[0]
        elif i == 0:
            j = np.nonzero(d - (i + 1) < 1)[0]
            kk = np.nonzero(d[j] - (i + 1) > 0)[0]
        else:
            j = np.nonzero(np.abs(d - (i + 1)) < 1)[0]
            kk = np.arange(len(j))
        mu = np.ones(len(j))
        mu[kk] = 1 - np.abs(d[j[kk]] - (i + 1))
        per_octave.append(dict(ws=int(w), dn=int(math.floor(4 * fs / p0[i] + 0.5)),
                               A=A, j=j, mu=mu, K=_kernel_matrix(fERBs, pc[j]),
                               win=np_hanning_matlab(w)))
    return dict(pc=pc, log2pc=log2pc, per_octave=per_octave, fERBs=fERBs)


def static_config(fs: int, plim) -> dict:
    return _static_config(int(fs), tuple(float(p) for p in plim), DLOG2P, DERBS,
                          K_WINDOW)


def swipe_tables(fs: int, plim, dtype: torch.dtype, device) -> dict:
    """SWIPE's static tables as tensors: ``pc`` and ``log2pc`` (candidates,)
    and, for octave i, ``A{i}`` (bins, nERB), ``K{i}`` (its candidates, nERB),
    ``mu{i}`` and ``win{i}``.  Built once per (fs, range, type, device) and
    kept (:mod:`..tables`)."""
    device = device_key(device)
    plim = tuple(float(p) for p in plim)

    def build():
        cfg = static_config(fs, plim)
        as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)   # noqa: E731
        tables = {"pc": as_t(cfg["pc"]), "log2pc": as_t(cfg["log2pc"])}
        for i, oc in enumerate(cfg["per_octave"]):
            for name in ("A", "K", "mu", "win"):
                tables[f"{name}{i}"] = as_t(oc[name])
        return tables

    return dict(cached(("swipe_tables", int(fs), plim, dtype, device), build))


def frame_times(n_samples: int, fs: int, dt: float) -> np.ndarray:
    return np.arange(int(1000 * n_samples / fs / (dt * 1000) + 1)) * dt


def time_interpolation(n_frames: int, w: int, dn: int, fs: float, t: np.ndarray):
    """Host float64 geometry of the linear interpolation from an octave's
    frame times ti = [0, (k*dn + w/2)/fs] to the output times t: the left
    frame, its weight, and where t lies outside ti (swipe.py:37-39).  In
    float32 the end comparison and the ties of the search could fall either
    way, and an outside frame is NaN in every candidate of the octave."""
    ti = np.r_[0.0, (np.arange(n_frames - 1) * dn + w / 2) / fs]
    pos = np.clip(np.searchsorted(ti, t, side="right") - 1, 0, n_frames - 2)
    frac = (t - ti[pos]) / (ti[pos + 1] - ti[pos])
    return pos, frac, (t < ti[0]) | (t > ti[-1])


def swipe_core(x: torch.Tensor, fs: int, plim=(71.0, 800.0), dt: float = 0.005,
               sTHR: float = float("-inf"), tables: dict = None) -> dict:
    """SWIPE' on rows x (B, n): f0 and vuv (B, T) and temporal_positions
    (T,).  ``tables``: :func:`swipe_tables`' dict (built when None)."""
    B, n = x.shape
    dtype, dev = x.dtype, x.device
    cfg = static_config(fs, plim)
    if tables is None:
        tables = swipe_tables(fs, plim, dtype, dev)
    n_cand = len(cfg["pc"])
    t = frame_times(n, fs, dt)
    # the host geometry of this length, kept as the tables are
    geo = (int(fs), tuple(float(p) for p in plim), int(n), float(dt))
    as_t = lambda name, key, build, dt=dtype: table(   # noqa: E731
        f"swipe_{name}", key, build, dt, dev)
    S = torch.zeros((B, n_cand, t.shape[0]), dtype=dtype, device=dev)
    nan = torch.full((), float("nan"), dtype=dtype, device=dev)

    for i, oc in enumerate(cfg["per_octave"]):
        w, dn = oc["ws"], oc["dn"]
        xzp = torch.nn.functional.pad(x, (w // 2, dn + w // 2))
        n_frames = (xzp.shape[1] - w) // dn + 1
        frames = xzp.unfold(1, w, dn)[:, :n_frames] * tables[f"win{i}"]
        X = torch.abs(torch.fft.rfft(frames, dim=-1))         # (B, frames, bins)
        L = torch.sqrt(torch.clamp(X @ tables[f"A{i}"], min=0.0))   # ERB grid
        den = torch.sqrt(torch.sum(L * L, dim=-1, keepdim=True))
        den = torch.where(den == 0, torch.full_like(den, F64_EPS), den)
        Si = (L / den) @ tables[f"K{i}"].T                     # (B, frames, cands_i)

        interp = lambda k: lambda: time_interpolation(   # noqa: E731
            n_frames, w, dn, float(fs), t)[k]
        pos = as_t("pos", geo + (i,), interp(0), torch.int64)
        frac = as_t("frac", geo + (i,), interp(1))[:, None]
        outside = as_t("outside", geo + (i,), interp(2), torch.bool)
        Si_t = Si[:, pos] * (1 - frac) + Si[:, pos + 1] * frac
        Si_t = torch.where(outside[:, None], nan, Si_t)

        # the candidate subsets are contiguous ranges (interval conditions
        # on the monotone octave distance d, swipe.py:45-62)
        j = np.asarray(oc["j"])
        assert np.array_equal(j, np.arange(j[0], j[0] + len(j))), j
        S[:, int(j[0]):int(j[0]) + len(j)] += (tables[f"mu{i}"][:, None]
                                               * Si_t.transpose(1, 2))

    # parabolic fine-tuning on the log-spaced grid (swipe.py:64-93); a NaN
    # in a frame's column makes its maximum NaN, and the frame unvoiced
    s_max, imax = torch.max(S, dim=1)                          # (B, T)
    i_c = imax.clamp(1, n_cand - 2)
    y0 = torch.gather(S, 1, (i_c - 1)[:, None])[:, 0]
    y1 = torch.gather(S, 1, i_c[:, None])[:, 0]
    y2 = torch.gather(S, 1, (i_c + 1)[:, None])[:, 0]

    # abscissae ntc = (tc/tc[1] - 1) 2 pi with tc = 1/pc: constant ratios
    r = 2.0 ** (1.0 / 96)
    x0_, x1_, x2_ = as_t("parabola", (), lambda: [(r - 1) * 2 * np.pi, 0.0,
                                                  (1 / r - 1) * 2 * np.pi])
    denom = (x0_ - x1_) * (x0_ - x2_) * (x1_ - x2_)
    a_c = (x2_ * (y1 - y0) + x1_ * (y0 - y2) + x0_ * (y2 - y1)) / denom
    b_c = (x2_ ** 2 * (y0 - y1) + x1_ ** 2 * (y2 - y0) + x0_ ** 2 * (y1 - y2)) / denom

    # fine grid over [log2 pc[i-1], log2 pc[i+1]] in steps of 1/12/64 (17 points)
    step = 1.0 / 12 / 64
    n_fine = int(np.floor((2.0 / 96) / step)) + 1
    klog = as_t("fine_grid", (), lambda: np.arange(n_fine) * step)
    nftc = (torch.pow(2.0, 1.0 / 96 - klog) - 1.0) * 2 * np.pi
    pval = (a_c[..., None] * nftc ** 2 + b_c[..., None] * nftc + y1[..., None])
    kbest = torch.argmax(pval, dim=-1)
    p_fine = torch.pow(2.0, tables["log2pc"][i_c - 1] + kbest.to(dtype) * step)

    at_edge = (imax == 0) | (imax == n_cand - 1)
    p = torch.where(at_edge, tables["pc"][0], p_fine)
    ok = ~(s_max < sTHR) & torch.isfinite(p) & ~torch.isnan(s_max)
    zero = torch.zeros((), dtype=dtype, device=dev)
    f0 = torch.where(ok, p, zero)
    f0 = torch.where(torch.isnan(f0), zero, f0)
    return {"temporal_positions": as_t("times", geo, lambda: t), "f0": f0,
            "vuv": (f0 > 0).to(dtype)}


def swipe(fs: int, x, plim=(71, 800), dt: float = 0.005,
          sTHR: float = float("-inf"), dtype=None, device=None) -> dict:
    """SWIPE' F0 estimation of one utterance x (n,) or a batch (B, n), a
    tensor or a numpy array (API of world_tpu.f0.swipe.swipe).  A tensor
    stays on its device; a numpy array goes to ``device`` (the GPU unless
    the CPU is asked for).  Outputs keep the input's batch shape."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    if dtype is not None:
        x = x.to(dtype)
    single = x.dim() == 1
    out = swipe_core(x[None] if single else x, int(fs), plim, float(dt),
                     float(sTHR))
    if single:
        out = {k: (v if k == "temporal_positions" else v[0])
               for k, v in out.items()}
    return out
