"""The WORLD low-frequency mirror fill (world_tpu/dsp/dcfill.py).

CheapTrick and D4C add a mirrored low-frequency replica to bins below f0:
replica(f) = the spectrum at (f0 - f), linearly interpolated with
end-segment extrapolation.  On the uniform bin grid the read positions are
k + alpha with a per-frame constant alpha, i.e. a per-row shift of the
reversed low band, done here with one gather.
"""
import torch
import torch.nn.functional as F

from .scanops import shift_rows


def dc_fill_add(signal_half: torch.Tensor, f0: torch.Tensor, fs: float,
                fft_size: int, boundary_factor: float, KL: int) -> torch.Tensor:
    """signal_half (F, kmax) + the replica on bins below f0.

    Bins in the low set (freq < f0 + df for ``boundary_factor`` 1.0, else
    freq < boundary_factor * f0) are the replica's source; KL is the static
    width of the low band."""
    dtype, dev = signal_half.dtype, signal_half.device
    df = fs / fft_size
    kmax = signal_half.shape[-1]
    KL = min(kmax, KL)
    k = torch.arange(KL, dtype=dtype, device=dev)[None, :]
    freqs = k * df
    f0c = f0[:, None]
    boundary = f0c + df if boundary_factor == 1.0 else boundary_factor * f0c
    in_low = freqs < boundary
    m = torch.clamp(in_low.sum(dim=1), max=KL)                 # (F,)
    y_src = torch.where(in_low, signal_half[:, :KL], torch.zeros((), dtype=dtype, device=dev))

    alpha = (m - 1).to(dtype) - f0 / df
    a_f = torch.floor(alpha).to(torch.int64)
    # y_asc[j] = y_src[m-1-j]; z[k] = y_asc[k + a_f] = g[(KL-m) + k + a_f]
    g = torch.flip(y_src, dims=(-1,))
    gpad = F.pad(g, (0, KL + KL // 2 + 4))
    sh = torch.clamp(KL - m + a_f, 0, KL + KL // 2)
    z = shift_rows(gpad, sh, KL + 1)
    y0u = z[:, :KL]
    y1u = z[:, 1:KL + 1]

    base_u = torch.arange(KL, device=dev)[None, :] + a_f[:, None]
    hi = (m - 2)[:, None]
    clipped = base_u > hi
    # y_asc[m-2] == y_src[1], y_asc[m-1] == y_src[0]
    y0 = torch.where(clipped, y_src[:, 1:2], y0u)
    y1 = torch.where(clipped, y_src[:, 0:1], y1u)
    pos = k + alpha[:, None]
    frac = pos - torch.minimum(base_u, hi).to(dtype)
    replica = y0 + (y1 - y0) * frac
    add = torch.where(freqs < f0c, replica, torch.zeros((), dtype=dtype, device=dev))
    return signal_half + F.pad(add, (0, kmax - KL))
