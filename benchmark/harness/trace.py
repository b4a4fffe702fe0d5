"""What the benchmark reads off the card besides the host clock: CUDA-event
spans around each graph replay of the window, and a short window under
``torch.profiler`` (its device events, busy time, longest operations and
idle gaps).

``torch.profiler`` may not list the kernels launched through ctypes (K1-K7)
in an eager call; the spans do not rely on it.
"""
import contextlib
import importlib
import time

import torch

KERNEL_NAMES = {"K1": ("scan_crossings", "select_intervals"),
                "K2": ("refine_kernel",), "K3": ("extension_scan",),
                "K4": ("extend_chains",), "K5": ("merge_sections",),
                "K6": ("centroid_kernel",), "K7": ("band_ap_kernel",)}
# kernels a launch of each counter starts (K1 is two grids)
GRIDS = {"K1": 2, "K2": 1, "K3": 1, "K4": 1, "K5": 1, "K6": 1, "K7": 1}
COUNTERS = (("K1", "world_tpu_torch.ops.edge_interp", "counter"),
            ("K2", "world_tpu_torch.ops.refine_dft", "counter"),
            ("K3", "world_tpu_torch.ops.extension_scan", "counter"),
            ("K4", "world_tpu_torch.ops.fix_step3", "extend_counter"),
            ("K5", "world_tpu_torch.ops.fix_step3", "merge_counter"),
            ("K6", "world_tpu_torch.ops.d4c_spectra", "centroid_counter"),
            ("K7", "world_tpu_torch.ops.d4c_spectra", "band_ap_counter"))
TOP = 10


def launches() -> dict:
    """The program's launch counters of K1-K7 (replays included)."""
    return {k: getattr(importlib.import_module(m), a).launches
            for k, m, a in COUNTERS}


class ReplaySpans:
    """CUDA events on the current stream before and after each graph replay
    of the program's caches (``parallel.graphs.Graph.replay`` wrapped),
    tagged with the call the benchmark is making."""

    def __init__(self):
        self.events = []            # (call index, start event, end event)
        self.call = None

    @contextlib.contextmanager
    def installed(self):
        from world_tpu_torch.parallel import graphs
        original = graphs.Graph.replay
        spans = self

        def replay(graph, inputs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = original(graph, inputs)
            end.record()
            spans.events.append((spans.call, start, end))
            return out

        graphs.Graph.replay = replay
        try:
            yield self
        finally:
            graphs.Graph.replay = original

    def per_call_ms(self) -> dict:
        """{call index: device ms of its replays}."""
        torch.cuda.synchronize()
        out = {}
        for call, start, end in self.events:
            out[call] = out.get(call, 0.0) + start.elapsed_time(end)
        return out


class TaggingSystem:
    """A system whose calls tell the spans which call they make."""

    def __init__(self, system, spans: ReplaySpans):
        self.system, self.spans = system, spans

    def call(self, call):
        self.spans.call = call.index
        return self.system.call(call)


def _events(prof):
    return prof.profiler.kineto_results.events()


def profile_window(run_window) -> dict:
    """Run ``run_window()`` (which returns the calls it made) under
    torch.profiler and read its trace: busy_s (the union of device
    operations), window_s (the profiled wall time), the kernels a call, the
    names of the program's kernels the trace lists, and the breakdown (the
    device operations that took most time, and the longest idle gaps with
    the host operation open at each gap's middle)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        calls = run_window()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for e in _events(prof):
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        (dev if e.device_type() == DeviceType.CUDA else host).append(span)
    dev.sort()
    busy_ns, gaps, reach = 0, [], None
    for a, b, _ in dev:
        if reach is None or a > reach:
            if reach is not None:
                gaps.append((a - reach, reach, a))
            busy_ns += b - a
            reach = b
        elif b > reach:
            busy_ns += b - reach
            reach = b
    by_name = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0) + (b - a)
    kernels = [s for s in dev if not s[2].startswith(("Memcpy", "Memset"))]
    seen = {k for k, names in KERNEL_NAMES.items()
            if any(any(n in s[2] for n in names) for s in kernels)}
    gaps.sort(reverse=True)

    def host_at(t):
        open_ = [s for s in host if s[0] <= t <= s[1]]
        return min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "idle host"

    return {"busy_s": busy_ns / 1e9, "window_s": window_s, "calls": calls,
            "kernels": len(kernels), "kernels_seen": sorted(seen),
            "device_ops": [[n, t / 1e9] for n, t in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[host_at((a + b) // 2), g / 1e9]
                          for g, a, b in gaps[:TOP]]}
