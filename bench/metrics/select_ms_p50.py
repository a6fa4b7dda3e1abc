"""Median wall time of one selection, construction included."""
from bench.readers import percentile_ms


def read(run):
    return percentile_ms(run, "select", 50)
