"""padding_share.serve: the share of the samples a serving cell's calls
compute that are padding (1 s buckets, rows to a power of two), in %."""
from metrics._lib import padding_share


def read(run):
    return padding_share(run)
