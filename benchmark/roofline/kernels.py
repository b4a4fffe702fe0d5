"""The launches of the program's hand-written kernels K1-K7 in one eager
call, with their operands, their least time (:mod:`.bounds`) and their
time on the card.

The wrappers the program launches each kernel through are wrapped for the
call: each launch's tensor operands are cloned before it (K5 updates its
carried state in place) and its outputs kept.  Each launch is then run
again through the same wrapper on fresh clones of its operands, between two
CUDA events on the current stream, behind a spin of the device so that the
host's wrapper time does not open a gap inside the events; the median of
``repeats`` such readings is its time.
"""
import contextlib

import torch

from . import bounds as B

# (module of the program, wrapper, kernel name); K1 is two grids a launch
WRAPPERS = (("world_tpu_torch.ops.edge_interp", "event_engine_cuda", "K1"),
            ("world_tpu_torch.ops.refine_dft", "refine_cuda", "K2"),
            ("world_tpu_torch.ops.extension_scan", "extension_scan_cuda", "K3"),
            ("world_tpu_torch.ops.fix_step3", "extend_chains_cuda", "K4"),
            ("world_tpu_torch.ops.fix_step3", "merge_sections_cuda", "K5"),
            ("world_tpu_torch.ops.d4c_spectra", "centroid_cuda", "K6"),
            ("world_tpu_torch.ops.d4c_spectra", "band_ap_cuda", "K7"))
SPIN_CYCLES = 200_000          # ~0.1 ms of device time ahead of each reading


def _clone(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, tuple):
        return tuple(_clone(v) for v in a)
    return a


@contextlib.contextmanager
def capture_launches(launches: list):
    """Within the block, every K1-K7 launch appends (kernel, wrapper,
    cloned operands, outputs) to ``launches``."""
    import importlib
    saved = []
    for mod_name, attr, kernel in WRAPPERS:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def wrapped(*args, _fn=fn, _k=kernel, **kw):
            operands = _clone(args)
            out = _fn(*args, **kw)
            launches.append({"kernel": _k, "fn": _fn, "args": operands,
                             "kwargs": kw, "out": _clone(out)})
            return out

        setattr(mod, attr, wrapped)
    try:
        yield launches
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def time_launch(launch: dict, repeats: int = 3) -> float:
    """The launch's kernel ms on the card: the median of ``repeats``
    readings on fresh clones of its operands."""
    readings = []
    for _ in range(repeats):
        args = _clone(launch["args"])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        launch["fn"](*args, **launch["kwargs"])
        end.record()
        end.synchronize()
        readings.append(start.elapsed_time(end))
    readings.sort()
    return readings[len(readings) // 2]


def _d4c_operands(args) -> dict:
    """d4c_bounds' dict from K7's operands (slab, margin, centroid, fs, f0,
    t, max_half, fft_size, frequency_interval, n_ap, window)."""
    (slab, margin, _, fs, f0, t, max_half, fft_size, fi, n_ap, window) = args
    return {"slab": slab, "margin": margin, "fs": fs, "f0": f0, "t": t,
            "max_half": max_half, "fft_size": fft_size, "fi": fi,
            "n_ap": n_ap, "window": window}


def launch_bounds(launches: list) -> list:
    """[(kernel, least ms, what bounds it)] for each launch, in order.  K6
    takes the geometry of the K7 launch of its D4C call (the next one)."""
    out = []
    for i, ln in enumerate(launches):
        k, a = ln["kernel"], ln["args"]
        if k == "K1":
            ms, by = B.k1_bound(a[0], a[2])
        elif k == "K2":
            ms, by = B.k2_bound({"seg": a[0], "f0": a[2], "afs": a[3],
                                 "max_half": a[4], "S": a[5]})
        elif k == "K3":
            ms, by = B.k3_bound((a[0], a[1], a[2], a[3], a[4],
                                 a[5] if len(a) > 5 else
                                 ln["kwargs"].get("backward", False)), ln["out"])
        elif k == "K4":
            ms, by = B.k4_bound(a, ln["out"])
        elif k == "K5":
            ms, by = B.k5_bound(a)
        elif k == "K6":
            k7 = next(x for x in launches[i + 1:] if x["kernel"] == "K7")
            ms, by = B.d4c_bounds(_d4c_operands(k7["args"]))["d4c_centroid"]
        else:
            ms, by = B.d4c_bounds(_d4c_operands(a))["d4c_band_ap"]
        out.append((k, ms, by))
    return out
