"""Kernel launches of the program (ops.LAUNCHES) per selection."""
from bench.readers import launches_per


def read(run):
    return launches_per(run, "selections")
