"""Harvest's decimator: cheby1 filtfilt as a truncated causal FIR.

world_tpu/dsp/iir.py:139-158 shows the form is exact: every IIR here has
its poles well inside the unit circle, so its impulse response falls below
float64 eps within a few hundred taps, and convolution with that truncated
response (computed on the host in float64) equals the recurrence.  Each
filtfilt pass starts from scipy's ``zi = lfilter_zi * x0`` state, which is
the filter's response to a constant ``x0`` prehistory.
"""
import functools

import numpy as np
import torch

from .fir import fir_causal


@functools.lru_cache(maxsize=None)
def cheby1_sos(order: int, rp: float, wn: float):
    from scipy import signal as _ss

    bb, aa = _ss.cheby1(order, rp, wn)
    return tuple(bb.tolist()), tuple(aa.tolist())


@functools.lru_cache(maxsize=None)
def _trunc_impulse_cached(b: tuple, a: tuple) -> np.ndarray:
    from scipy import signal as _ss

    imp = np.zeros(4096)
    imp[0] = 1.0
    h = _ss.lfilter(np.asarray(b, np.float64), np.asarray(a, np.float64), imp)
    mag = np.abs(h)
    if mag.max() == 0.0:
        return h[:1].copy()
    nz = np.nonzero(mag > mag.max() * 1e-17)[0]
    h = h[: int(nz[-1]) + 1].copy()
    h.setflags(write=False)
    return h


def trunc_impulse(b, a) -> np.ndarray:
    """Truncated causal impulse response (host float64) of lfilter(b, a)."""
    return _trunc_impulse_cached(tuple(np.atleast_1d(b).tolist()),
                                 tuple(np.atleast_1d(a).tolist()))


def filtfilt(h: torch.Tensor, x: torch.Tensor, padlen: int) -> torch.Tensor:
    """scipy ``filtfilt(method='pad', padtype='odd')`` for rows x (R, n),
    with the filter given by its truncated impulse response ``h``."""
    left = 2.0 * x[:, :1] - torch.flip(x[:, 1:padlen + 1], dims=(-1,))
    right = 2.0 * x[:, -1:] - torch.flip(x[:, -padlen - 1:-1], dims=(-1,))
    ext = torch.cat([left, x, right], dim=-1)
    y = fir_causal(ext, h, ext[:, :1])
    y = torch.flip(y, dims=(-1,))
    y = fir_causal(y, h, y[:, :1])
    y = torch.flip(y, dims=(-1,))
    return y[:, padlen:-padlen]


def decimator_impulse(q: int, order: int = 3) -> np.ndarray:
    """Truncated impulse response of the cheby1(order, 0.05, 0.8/q) decimator."""
    return trunc_impulse(*cheby1_sos(order, 0.05, 0.8 / q))


def decimate_matlab(x: torch.Tensor, q: int, order: int = 3,
                    h: torch.Tensor = None) -> torch.Tensor:
    """MATLAB-style decimate of rows x (R, n): cheby1(order, 0.05, 0.8/q)
    filtfilt (padlen 3*(ntaps-1)) then phase-aligned downsampling.  ``h``
    is the filter's truncated impulse response (computed when None)."""
    b, a = cheby1_sos(order, 0.05, 0.8 / q)
    padlen = 3 * (max(len(a), len(b)) - 1)
    if h is None:
        h = torch.as_tensor(decimator_impulse(q, order), dtype=x.dtype,
                            device=x.device)
    y = filtfilt(h, x, padlen)
    nd = y.shape[-1]
    n_out = int(np.ceil(nd / q))
    n_beg = int(q - (q * n_out - nd))
    return y[:, n_beg - 1::q]
