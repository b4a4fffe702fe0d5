"""Host-side WAV IO with the reference's normalization convention.

The reference scripts read int16 wavs and scale by 1/(2^15-1)
(example/prosody.py:13); encode/decode operate on float in [-1, 1).
"""
import numpy as np
from scipy.io import wavfile


def read_wav(path):
    fs, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data / (2 ** 15 - 1)
    elif data.dtype == np.int32:
        x = data / (2 ** 31 - 1)
    elif data.dtype == np.uint8:
        x = (data.astype(np.float64) - 128) / 127.0
    else:
        x = np.asarray(data, dtype=np.float64)
    if x.ndim > 1:
        x = x.mean(axis=1)
    return int(fs), np.ascontiguousarray(x, dtype=np.float64)


def write_wav(path, fs, y):
    y = np.asarray(y)
    wavfile.write(path, int(fs), (np.clip(y, -1.0, 1.0) * (2 ** 15 - 1))
                  .astype(np.int16))
