"""Harvest's and DIO's decimators, as truncated causal FIRs.

Harvest's is a cheby1 filtfilt; DIO's is WORLD's own zero-phase recursive
low-pass (dio.py:359-476).  world_tpu/dsp/iir.py:139-158 shows the form is
exact: every IIR here has its poles well inside the unit circle, so its
impulse response falls below float64 eps within a few hundred taps, and
convolution with that truncated response (computed on the host in float64)
equals the recurrence.  Each filtfilt pass starts from scipy's
``zi = lfilter_zi * x0`` state, which is the filter's response to a
constant ``x0`` prehistory; DIO's passes start from zero state.
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


# WORLD's decimation filter for each integer ratio (dio.py:359-446):
# (a0, a1, a2) of the recursion and (b0, b1) of the symmetric numerator.
_DECIMATE_COEFFS = {
    11: ((2.450743295230728, -2.06794904601978, 0.59574774438332101),
         (0.0026822508007163792, 0.0080467524021491377)),
    12: ((2.4981398605924205, -2.1368928194784025, 0.62187513816221485),
         (0.0021097275904709001, 0.0063291827714127002)),
    10: ((2.3936475118069387, -1.9873904075111861, 0.5658879979027055),
         (0.0034818622251927556, 0.010445586675578267)),
    9: ((2.3236003491759578, -1.8921545617463598, 0.53148928133729068),
        (0.0046331164041389372, 0.013899349212416812)),
    8: ((2.2357462340187593, -1.7780899984041358, 0.49152555365968692),
        (0.0063522763407111993, 0.019056829022133598)),
    7: ((2.1225239019534703, -1.6395144861046302, 0.44469707800587366),
        (0.0090366882681608418, 0.027110064804482525)),
    6: ((1.9715352749512141, -1.4686795689225347, 0.3893908434965701),
        (0.013469181309343825, 0.040407543928031475)),
    5: ((1.7610939654280557, -1.2554914843859768, 0.3237186507788215),
        (0.021334858522387423, 0.06400457556716227)),
    4: ((1.4499664446880227, -0.98943497080950582, 0.24578252340690215),
        (0.036710750339322612, 0.11013225101796784)),
    3: ((0.95039378983237421, -0.67429146741526791, 0.15412211621346475),
        (0.071221945171178636, 0.21366583551353591)),
    2: ((0.041156734567757189, -0.42599112459189636, 0.041037215479961225),
        (0.16797464681802227, 0.50392394045406674)),
}


def world_decimator_impulse(r: int) -> np.ndarray:
    """Truncated impulse response of one pass of DIO's decimation filter,
    (b0 + b1 z^-1 + b1 z^-2 + b0 z^-3) / (1 - a0 z^-1 - a1 z^-2 - a2 z^-3).
    A ratio without coefficients gives the zero filter, as in the JAX
    package."""
    a, b = _DECIMATE_COEFFS.get(r, ((0.0, 0.0, 0.0), (0.0, 0.0)))
    b0, b1 = b
    return trunc_impulse((b0, b1, b1, b0), (1.0, -a[0], -a[1], -a[2]))


def decimate_world(x: torch.Tensor, r: int, h: torch.Tensor = None) -> torch.Tensor:
    """DIO's downsampler (dio.py:451-476) for rows x (R, n): reflect-pad 9
    samples, filter forward and backward from zero state, keep every r-th
    sample.  ``h`` is :func:`world_decimator_impulse` (computed when None)."""
    kn = 9
    x_len = x.shape[-1]
    if h is None:
        h = torch.tensor(world_decimator_impulse(r), dtype=x.dtype,
                         device=x.device)
    # 2*x0 - rev is two rounded operations, never a fused multiply-add
    left = 2.0 * x[:, :1] - torch.flip(x[:, 1:kn + 1], dims=(-1,))
    right = 2.0 * x[:, -1:] - torch.flip(x[:, -kn - 1:-1], dims=(-1,))
    tmp = torch.cat([left, x, right], dim=-1)
    zero = torch.zeros_like(tmp[:, :1])
    tmp = torch.flip(fir_causal(tmp, h, zero), dims=(-1,))
    tmp = torch.flip(fir_causal(tmp, h, zero), dims=(-1,))
    nout = int(np.ceil(x_len / r + 1))
    nbeg = int(r - r * nout + x_len)
    start = nbeg + kn - 1
    count = int(np.ceil((x_len + kn - nbeg) / r))
    return tmp[:, start:start + (count - 1) * r + 1:r]
