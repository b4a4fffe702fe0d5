"""What several metric readers share: the shape counts of a window, and the
device spans of its replays."""
import numpy as np


def padding_share(run):
    """1 - true samples / samples computed over the window's calls, as a
    percentage: a call computes its rows (the bucket's, padded to the
    entry's rows) times its padded length."""
    calls = run.record.calls
    if not calls:
        return None
    true = sum(r.n for call, _, _ in calls for r in call.requests)
    computed = sum(call.rows * call.length for call, _, _ in calls)
    return 100.0 * (1.0 - true / computed)


def device_idle(run):
    """100 - the replays' device spans (CUDA events on their stream around
    each replay) as a percentage of the window; None without spans."""
    if not run.spans:
        return None
    busy_ms = sum(run.spans.values())
    return 100.0 * (1.0 - busy_ms / (1e3 * run.record.window_s()))


def host_ms_per_request(run):
    """The mean over the window's calls that replayed of their host wall ms
    minus their replays' device ms."""
    if not run.spans:
        return None
    gaps = [1e3 * (end - start) - run.spans[call.index]
            for call, start, end in run.record.calls if call.index in run.spans]
    return float(np.mean(gaps)) if gaps else None
