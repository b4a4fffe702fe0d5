"""Excitation seed banks (port of world_tpu/synth/seeds.py).

Built on the host in numpy float64 with numpy's ``RandomState``, so the
banks match the JAX package's bit for bit for the same seed.
"""
import functools

import numpy as np

from ..dsp.windows import np_hanning_matlab
from ..tables import table


def _short_velvet_noise(n: int, rng: np.random.RandomState) -> np.ndarray:
    out = np.zeros(n)
    td = 4
    r = int(n // td + 0.5)
    safety_rand = np.ones(r)
    safety_rand[r // 2:] *= -1
    safety_rand *= 2
    for i in range(r):
        j = rng.randint(0, r)
        safety_rand[j], safety_rand[i] = safety_rand[i], safety_rand[j]
    out[td * np.arange(r) + rng.randint(td, size=r)] = safety_rand
    return out


def _modified_velvet_noise(n: int, fs: int, rng: np.random.RandomState) -> np.ndarray:
    base_period = np.array([8, 30, 60])
    short_period = 8 * (base_period * fs / 48000 + 0.5)
    buf = np.zeros(n + int(np.max(short_period)) + 1)
    index = 0
    while True:
        v_len = rng.randint(0, len(short_period))
        L = int(short_period[v_len])
        buf[index:index + L] = _short_velvet_noise(L, rng)
        index += L
        if index >= n - 1:
            break
    return buf[:n]


@functools.lru_cache(maxsize=8)
def _seeds(fs: int, fft_size: int, noise_length: int, seed: int):
    w = np.arange(fft_size // 2 + 1) * fs / fft_size
    frequency_interval = 3000
    frequency_range = frequency_interval * 2
    upper_limit = 15000
    n_ap = int(2 + np.floor(min(upper_limit, fs / 2 - frequency_interval)
                            / frequency_interval))
    rng = np.random.RandomState(seed)
    velvet = _modified_velvet_noise(noise_length, fs, rng)
    spec_n = np.fft.fft(velvet, noise_length)
    i = np.arange(n_ap)[:, None]
    spec = 0.5 + 0.5 * np.cos(((w[None, :] - frequency_interval * i)
                               / frequency_range) * 2 * np.pi)
    spec = np.where(w[None, :] > frequency_interval * (i + 1), 0.0, spec)
    spec = np.where(w[None, :] < frequency_interval * (i - 1), 0.0, spec)
    spec[-1] = np.where(w > frequency_interval * (n_ap - 1), 1.0, spec[-1])
    full = np.concatenate([spec, spec[:, -2:0:-1]], axis=1)
    pulse = np.fft.fftshift(np.fft.ifft(full, axis=1).real, axes=1).T
    noise = np.fft.ifft(spec_n[None, :] * np.fft.fft(pulse.T, noise_length, axis=1),
                        axis=1).real.T
    h = np_hanning_matlab(fft_size)
    pulse[:, 0] = pulse[:, 0] - np.mean(pulse[:, 0]) * h / np.mean(h)
    pulse.setflags(write=False)
    noise.setflags(write=False)
    return pulse, noise


def get_seeds_signals(fs: int, fft_size: int = None, noise_length: int = None,
                      seed: int = 0) -> dict:
    """Band-passed pulse bank (fft_size, n_bands) and velvet-noise bank
    (noise_length, n_bands), float64 numpy arrays (read-only, shared)."""
    if fft_size is None:
        fft_size = int(1024 * (2 ** np.ceil(np.log2(fs / 48000))))
    if noise_length is None:
        noise_length = int(2 ** np.ceil(np.log2(fs / 2)))
    pulse, noise = _seeds(int(fs), int(fft_size), int(noise_length), int(seed))
    return {"pulse": pulse, "noise": noise}


def seed_tables(fs: int, seed: int, dtype, device) -> dict:
    """:func:`get_seeds_signals`' two banks at the default sizes as tensors
    of ``dtype`` on ``device``, uploaded once per (fs, seed, type, device)
    and kept (:mod:`..tables`)."""
    return {name: table(f"requiem_{name}_seed", (int(fs), int(seed)),
                        lambda name=name: get_seeds_signals(fs, seed=seed)[name],
                        dtype, device)
            for name in ("pulse", "noise")}
