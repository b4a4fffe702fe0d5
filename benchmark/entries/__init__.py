"""The program's entry points as the benchmark drives them, one module each,
found by the name a configuration gives in ``entry``.  A module exposes
``System(cfg, x32, device)`` with ``call(call) -> [outputs a request]`` (f0,
vuv, sp (frames, bins), ap (frames, bands or bins), y as numpy, the arrays
the user gets), ``caches()`` (the program's graph caches it fills),
and ``close()``."""
