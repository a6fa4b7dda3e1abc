"""Sets evaluated per second: all sets of the window over all its seconds."""
from bench.readers import rate


def read(run):
    return rate(run, "sets")
