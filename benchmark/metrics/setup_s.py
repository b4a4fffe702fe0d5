"""setup_s: seconds from the process's start to the first timed request:
imports, the kernels' build or load, tables, modules and the warm-up of
every signature the cell sends (eager call and capture)."""


def read(run):
    return run.setup_s
