"""latency_p50_ms: the median of latency_p95_ms's latencies."""
import numpy as np


def read(run):
    return float(np.median(run.record.latencies_ms()))
