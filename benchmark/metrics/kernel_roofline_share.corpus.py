"""kernel_roofline_share.corpus: the sum of the least ms of every K1-K7
launch of each signature's first call through the entry (bounds by
benchmark/roofline) over the sum of their measured ms, in %.  A launch's
ms are CUDA events around its wrapper on fresh copies of its operands
(benchmark/roofline/kernels.py)."""


def read(run):
    launches = run.rooflines or []
    bound = sum(b for _, b, _, _ in launches)
    took = sum(t for _, _, _, t in launches)
    return 100.0 * bound / took if took > 0 else None
