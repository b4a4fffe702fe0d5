"""Host-side window tables (world_tpu/dsp/windows.py), built in numpy float64."""
import numpy as np


def np_nuttall(n: int) -> np.ndarray:
    """Nuttall window; the argument is arange(n) * 2 * pi / (n-1) in that
    order, so that the two centre samples of an even n tie as in the
    reference."""
    t = np.arange(n) * 2 * np.pi / (n - 1)
    coefs = np.array([0.355768, -0.487396, 0.144232, -0.012604])
    return coefs @ np.cos(np.arange(4)[:, None] * t[None, :])


def np_hanning_matlab(n: int) -> np.ndarray:
    """MATLAB hanning(n): no zero endpoints."""
    i = np.arange(1, n + 1)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n + 1))
