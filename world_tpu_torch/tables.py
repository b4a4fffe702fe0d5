"""Tables built once: the arrays a round trip takes from the host.

A table is built on the host (numpy, float64) and copied to its device the
first time it is asked for, then kept, keyed by what determines it (the
sample rate, the lengths and caps, the type and the device).  A copy from
the host is a synchronous upload, and a CUDA graph cannot capture one, so a
round trip on the card asks for its tables before it is captured and finds
them kept while it is.

The cache is shared by the worker threads of a call over several devices
(:func:`..parallel.batch._on_devices`), so it takes a lock.  It holds at
most ``MAX_ENTRIES`` entries and drops the least recently used: a graph
keeps the tables it was captured with alive itself (:func:`retained`).
"""
import contextlib
import threading
from collections import OrderedDict

import numpy as np
import torch

MAX_ENTRIES = 256

_LOCK = threading.Lock()
_CACHE = OrderedDict()
_LOCAL = threading.local()


def device_key(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def cached(key: tuple, build):
    """``build()``, once per ``key``; the value is kept for later calls."""
    with _LOCK:
        value = _CACHE.get(key)
        if value is not None:
            _CACHE.move_to_end(key)
    if value is None:
        value = build()
        with _LOCK:
            value = _CACHE.setdefault(key, value)
            _CACHE.move_to_end(key)
            while len(_CACHE) > MAX_ENTRIES:
                _CACHE.popitem(last=False)
    kept = getattr(_LOCAL, "kept", None)
    if kept is not None:
        kept.append(value)
    return value


def table(name: str, key: tuple, build, dtype: torch.dtype, device) -> torch.Tensor:
    """The host array ``build()`` as a tensor of ``dtype`` on ``device``,
    uploaded once per (name, key, dtype, device)."""
    device = device_key(device)
    return cached((name, key, dtype, device),
                  lambda: torch.tensor(np.asarray(build()), dtype=dtype,
                                       device=device))


def frame_grid(n_frames: int, frame_period_ms: float, device) -> torch.Tensor:
    """The float64 frame times ``arange(n_frames) * frame_period_ms / 1000``
    (Harvest's 1 ms grid and every stage's output grid)."""
    fp = float(frame_period_ms)
    return table("frame_grid", (int(n_frames), fp),
                 lambda: np.arange(n_frames) * fp / 1000, torch.float64, device)


@contextlib.contextmanager
def retained():
    """Collect every table this thread asks for inside the block into the
    list it yields (a captured graph holds them, so that the cache may drop
    them without freeing memory the graph reads)."""
    outer = getattr(_LOCAL, "kept", None)
    _LOCAL.kept = kept = []
    try:
        yield kept
    finally:
        _LOCAL.kept = outer
        if outer is not None:
            outer.extend(kept)
