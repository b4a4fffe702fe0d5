#!/usr/bin/env python3
"""The benchmark of world_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints, last on its standard output, one JSON line with ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; the numbers its check compared come last on standard error
and under ``checked``.  Without a card, or with fewer cards than the cell
asks for, it prints no result and exits with 2.  BENCHMARK.json names the
cells; benchmark/harness/core.py says how a run finds the rest.
"""
import os
import sys
import time

T_START = time.perf_counter()

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# every cache of the run inside the checkout, at fixed paths: the program's
# kernels build into world_tpu_torch/_build/ beside its sources
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host side of a run is one Python thread
# driving the card, and the machine's cores are shared
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]

from harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T_START))
