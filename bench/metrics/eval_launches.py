"""Kernel launches of the program (ops.LAUNCHES) per multiset call."""
from bench.readers import launches_per


def read(run):
    return launches_per(run, "calls")
