"""device_idle.serve: the share of a serving window in which no replay ran
on the card, in %: 100 minus the replays' device spans (CUDA events before
and after each replay on its stream) over the window.  It does not rely on
torch.profiler, which may not list the kernels launched through ctypes."""
from metrics._lib import device_idle


def read(run):
    return device_idle(run)
