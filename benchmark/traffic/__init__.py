"""Traffic: the cuts of x16 (:mod:`.cuts`), what drivers share
(:mod:`.common`) and one module a driver (``closed_batch``,
``closed_single``, ``open_poisson``), each found by its name in a mix file
(benchmark/mixes/<traffic>.json)."""
