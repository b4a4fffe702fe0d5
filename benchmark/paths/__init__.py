"""The reference paths, one module a path, found by file by the name a
configuration gives in ``references`` (harness/judge.py's ``path_of``).  A
module exposes ``outputs(cfg, x, items, dtype, device, gots)``: the plain
reference's outputs of the sampled requests ``items`` (request, call, row,
...) on the cell's audio ``x``, and for each of ``gots`` (each request's
outputs: the program's, a control's) the reference's synthesis of that
analysis, in ``y_syn``; and ``CONTROL``, the precision one below the
configuration's that its control computes in (``tf32`` or ``bf16``, one of
``judge.CONTROLS``).  A path imports the plain reference and nothing of the
program."""
