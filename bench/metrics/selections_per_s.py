"""Selections completed per second: all of the window over all its seconds."""
from bench.readers import rate


def read(run):
    return rate(run, "selections")
