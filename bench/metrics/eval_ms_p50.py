"""Median wall time of one value_multi call with its read-back."""
from bench.readers import percentile_ms


def read(run):
    return percentile_ms(run, "eval", 50)
