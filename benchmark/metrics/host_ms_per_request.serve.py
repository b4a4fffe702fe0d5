"""host_ms_per_request.serve: a request's host wall ms minus its replay's
device ms (the benchmark's CUDA events around the replay), the mean over
the window's requests: the host path around one replay (padding, copies,
the key, stripping)."""
from metrics._lib import host_ms_per_request


def read(run):
    return host_ms_per_request(run)
