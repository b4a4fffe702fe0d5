"""Minimum-phase spectra via the real cepstrum (world_tpu/dsp/minphase.py)."""
import torch


def mirror_full(half: torch.Tensor) -> torch.Tensor:
    """(..., n//2+1) half spectrum -> (..., n) even-symmetric full spectrum."""
    return torch.cat([half, torch.flip(half[..., 1:-1], dims=(-1,))], dim=-1)


def minimum_phase_spectrum(amplitude_full: torch.Tensor) -> torch.Tensor:
    """exp(complex cepstrum): the minimum-phase spectrum whose magnitude is
    ``amplitude_full`` (..., fft_size), strictly positive and even."""
    fft_size = amplitude_full.shape[-1]
    cep = torch.fft.fft(torch.log(amplitude_full) / 2.0).real
    idx = torch.arange(fft_size, device=amplitude_full.device)
    complex_cep = torch.where(idx >= fft_size // 2, cep * 2.0,
                              torch.zeros_like(cep))
    complex_cep[..., 0] = cep[..., 0]
    return torch.exp(torch.fft.ifft(complex_cep))
