"""Feature codecs: mel filterbanks, log-filterbank energies, MCEP, context
(port of world_tpu/features/codecs.py).

Tensors in, tensors out, on the caller's device; a numpy array goes to
``device`` (the GPU unless the CPU is asked for).  The mel scale and the
filterbank are static and built on the host in float64.
"""
import numpy as np
import torch

from .._backend import F64_EPS, resolve_device
from ..dsp.interp import interp_rows


def _tensor(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(resolve_device(device))
    return torch.tensor(np.asarray(a), device=resolve_device(device))


def _np_hz2mel(hz):
    return 2595 * np.log10(1 + np.asarray(hz, dtype=np.float64) / 700.0)


def _np_mel2hz(mel):
    return 700 * (10 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1)


def hz2mel(hz, device=None) -> torch.Tensor:
    return 2595 * torch.log10(1 + _tensor(hz, device) / 700.0)


def mel2hz(mel, device=None) -> torch.Tensor:
    return 700 * (10 ** (_tensor(mel, device) / 2595.0) - 1)


def filterbank_matrix(nfilt=20, nfft=512, samplerate=16000, lowfreq=0,
                      highfreq=None) -> np.ndarray:
    """Triangular mel filterbank (nfilt, nfft//2+1) (main.py:275-303), numpy
    float64."""
    highfreq = highfreq or samplerate / 2
    assert highfreq <= samplerate / 2, "highfreq is greater than samplerate/2"
    melpoints = np.linspace(float(_np_hz2mel(lowfreq)), float(_np_hz2mel(highfreq)),
                            nfilt + 2)
    bin_edges = np.floor((nfft + 1) * _np_mel2hz(melpoints) / samplerate)
    k = np.arange(nfft // 2 + 1)
    lo = bin_edges[:-2][:, None]
    mid = bin_edges[1:-1][:, None]
    hi = bin_edges[2:][:, None]
    rising = (k[None, :] - lo) / np.maximum(mid - lo, 1e-12)
    falling = (hi - k[None, :]) / np.maximum(hi - mid, 1e-12)
    return np.where((k >= lo) & (k < mid), rising,
                    np.where((k >= mid) & (k < hi), falling, 0.0))


def get_filterbanks(nfilt=20, nfft=512, samplerate=16000, lowfreq=0,
                    highfreq=None, device=None) -> torch.Tensor:
    return torch.as_tensor(filterbank_matrix(nfilt, nfft, samplerate, lowfreq,
                                             highfreq),
                           device=resolve_device(device))


def encode_lfbank(spec, prefac=0.97, fs=16000, nfilt=32, lowfreq=0,
                  highfreq=None, device=None) -> torch.Tensor:
    """Log mel-filterbank energies (N, nfilt) from a magnitude spectrogram
    (N, D)."""
    spec = _tensor(spec, device)
    D = spec.shape[1]
    nfft = (D - 1) * 2
    # pre-emphasis response |1 - p e^{-jw}| on D points in [0, pi)
    w = torch.arange(D, dtype=spec.dtype, device=spec.device) * (np.pi / D)
    h = torch.abs(1.0 - prefac * torch.polar(torch.ones_like(w), -w))
    pspec = torch.square(spec * h) / nfft
    fb = torch.as_tensor(filterbank_matrix(nfilt, nfft, fs, lowfreq, highfreq),
                         dtype=spec.dtype, device=spec.device)
    feat = pspec @ fb.T
    return torch.log(torch.where(feat == 0, torch.full_like(feat, F64_EPS), feat))


def _mel_bins(n_points: int, scale: float, fs, lowhz, highhz, like: torch.Tensor):
    melpoints = np.linspace(float(_np_hz2mel(lowhz)), float(_np_hz2mel(highhz)),
                            n_points)
    return torch.as_tensor(np.floor(scale * _np_mel2hz(melpoints) / fs),
                           dtype=like.dtype, device=like.device)


def encode_mcep(spec, n0=12, fs=16000, lowhz=0, highhz=8000,
                device=None) -> torch.Tensor:
    """Mel-warped cepstrum (N, n0) of a magnitude spectrogram (N, D)
    (main.py:324-341)."""
    spec = _tensor(spec, device)
    D = spec.shape[1]
    bins = _mel_bins(D, (D - 1) * 2 + 1, fs, lowhz, highhz, spec)
    grid = torch.arange(D, dtype=spec.dtype, device=spec.device)
    Xml = interp_rows(bins, grid, torch.log(spec))
    return torch.fft.irfft(Xml, dim=-1)[:, :n0]


def decode_mcep(cepstrum, fft_size, fs=16000, lowhz=0, highhz=8000,
                device=None) -> torch.Tensor:
    """Magnitude spectrum (N, fft_size//2+1) from MCEP (N, n0)
    (main.py:343-358).  The reference fixes fs at 16000 there; the default
    keeps that, and ``fs`` overrides it."""
    cepstrum = _tensor(cepstrum, device)
    N, n0 = cepstrum.shape
    Yc = torch.zeros((N, fft_size), dtype=cepstrum.dtype, device=cepstrum.device)
    Yc[:, :n0] = cepstrum
    if n0 > 1:
        # the mirrored half: Yc[:, -1], Yc[:, -2], ... = cepstrum[:, 1], [:, 2], ...
        Yc[:, fft_size - n0 + 1:] = torch.flip(cepstrum[:, 1:n0], dims=(1,))
    Yl = torch.fft.rfft(Yc, dim=-1).real
    D = int(fft_size // 2 + 1)
    bins = _mel_bins(D, fft_size, fs, lowhz, highhz, cepstrum)
    grid = torch.arange(D, dtype=cepstrum.dtype, device=cepstrum.device)
    return torch.exp(interp_rows(grid, bins, Yl))


def get_context(X, w=5, device=None) -> torch.Tensor:
    """Stack +-w frames of context, edges repeated (main.py:360-365):
    (N, D) -> (N, (2w+1) D)."""
    X = _tensor(X, device)
    N, D = X.shape
    pad = torch.cat([X[:1].expand(w, D), X, X[-1:].expand(w, D)])
    idx = (torch.arange(N, device=X.device)[:, None]
           + torch.arange(2 * w + 1, device=X.device)[None, :])
    return pad[idx].reshape(N, (2 * w + 1) * D)


def encode_vae(Xc, energy, encoder, decoder, window, n0, batch_size, mean,
               device=None):
    """Voice-conversion latent round trip through encoder/decoder models
    (main.py:367-384): any objects with a Keras-like ``.predict`` (numpy in
    and out), such as :class:`..features.vae.MLP`.  Returns (latents,
    cepstra (N, n0) with ``energy`` in column 0), numpy arrays."""
    Xc = np.asarray(Xc)
    assert Xc.shape[1] == n0 - 1
    Xc = Xc - mean
    Xc = get_context(Xc, w=window, device=device).cpu().numpy()
    Zc = encoder.predict(Xc, batch_size=batch_size)
    Yc = decoder.predict(Zc)
    Yc = Yc[:, window * (n0 - 1):(window + 1) * (n0 - 1)]
    out = np.zeros((Yc.shape[0], n0))
    out[:, 0] = energy
    out[:, 1:n0] = Yc + mean
    return Zc, out
