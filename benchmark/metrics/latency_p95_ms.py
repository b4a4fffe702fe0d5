"""latency_p95_ms: the 95th percentile over the requests due in the window
of the ms from when a request was due to when its outputs were numpy on
the host."""
import numpy as np


def read(run):
    return float(np.percentile(run.record.latencies_ms(), 95))
