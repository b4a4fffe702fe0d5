"""One reader a metric, found by the metric's name: ``read(run)`` returns the
value, or None where the run has nothing to read (harness/core.py's Run)."""
