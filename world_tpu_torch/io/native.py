"""ctypes bindings for the native IO library (native/wavio.cc).

Loads ``native/libworldtpu_io.so`` where it has been built (``sh
native/build.sh``); this package builds nothing there.  Without the library
the scipy path (world_tpu_torch.io.wav) is used, and :func:`available` says
which of the two a call takes.
"""
import ctypes
import os
from pathlib import Path

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libworldtpu_io.so"
_lib = None


class _WavInfo(ctypes.Structure):
    _fields_ = [("sample_rate", ctypes.c_int32),
                ("channels", ctypes.c_int32),
                ("bits_per_sample", ctypes.c_int32),
                ("format", ctypes.c_int32),
                ("n_frames", ctypes.c_int64)]


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.wav_read_mono_f64.restype = ctypes.c_int64
    lib.wav_read_mono_f64.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(_WavInfo),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.wav_write_i16.restype = ctypes.c_int
    lib.wav_write_i16.argtypes = [
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    _lib = lib
    return lib


def available() -> bool:
    """True when the native library is loaded, False when read_wav and
    write_wav go through scipy."""
    return _load() is not None


def read_wav(path):
    """Native WAV read -> (fs, mono float64 in [-1, 1))."""
    lib = _load()
    if lib is None:
        from .wav import read_wav as _fallback

        return _fallback(path)
    info = _WavInfo()
    n = lib.wav_read_mono_f64(os.fsencode(str(path)), ctypes.byref(info),
                              None, 0)
    if n < 0:
        raise IOError(f"native wav read failed ({n}) for {path}")
    out = np.empty(int(n), dtype=np.float64)
    got = lib.wav_read_mono_f64(
        os.fsencode(str(path)), ctypes.byref(info),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
    if got < 0:
        raise IOError(f"native wav read failed ({got}) for {path}")
    return int(info.sample_rate), out[:int(got)]


def write_wav(path, fs, y):
    """Native 16-bit PCM write with clipping."""
    lib = _load()
    if lib is None:
        from .wav import write_wav as _fallback

        return _fallback(path, fs, y)
    y = np.ascontiguousarray(np.asarray(y, dtype=np.float64))
    rc = lib.wav_write_i16(os.fsencode(str(path)), int(fs),
                           y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                           y.shape[0])
    if rc != 0:
        raise IOError(f"native wav write failed ({rc}) for {path}")
