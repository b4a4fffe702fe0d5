"""Observability: xRT counters and device trace capture (port of
world_tpu/utils/profiling.py): a wall-clock xRT (audio seconds per second)
meter, a timer that waits for the device, and a ``torch.profiler`` trace
context."""
import contextlib
import time
from dataclasses import dataclass, field

import torch


@dataclass
class XrtMeter:
    """Accumulates wall time + audio time across pipeline calls."""
    wall_seconds: float = 0.0
    audio_seconds: float = 0.0
    calls: int = 0
    per_stage: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def measure(self, audio_seconds: float, stage: str = "total"):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.wall_seconds += dt
        self.audio_seconds += audio_seconds
        self.calls += 1
        self.per_stage[stage] = self.per_stage.get(stage, 0.0) + dt

    @property
    def xrt(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def report(self) -> str:
        lines = [f"xRT {self.xrt:.1f} (audio {self.audio_seconds:.2f}s / "
                 f"wall {self.wall_seconds:.3f}s, {self.calls} calls)"]
        for k, v in sorted(self.per_stage.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:24s} {v*1000:9.2f} ms")
        return "\n".join(lines)


def _on_cuda(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_cuda(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return any(_on_cuda(v) for v in out)
    return False


def timed(fn, *args, repeats: int = 3):
    """Median wall time of a computation after one warm-up call; where the
    outputs are on the GPU, each call is waited for with
    ``torch.cuda.synchronize``."""
    def run():
        out = fn(*args)
        if _on_cuda(out):
            torch.cuda.synchronize()
        return out

    out = run()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace of the host and, where there is one,
    the GPU, written to ``logdir`` as a Chrome trace (view in Perfetto or
    TensorBoard)."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
