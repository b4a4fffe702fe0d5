"""Traffic: the cuts of a configuration's audio (:mod:`.cuts`), what drivers share
(:mod:`.common`) and one module a driver (``closed_batch``,
``closed_single``, ``open_poisson``), each found by its name in a mix file
(benchmark/mixes/<traffic>.json)."""
