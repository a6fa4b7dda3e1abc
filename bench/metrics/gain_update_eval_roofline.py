"""Roofline share of the selections: the bound of the window's work over
the device time of every operation that the construction and the strategy
launched (``csrc/marginal_gain.cu``'s kernels, and anything else they run)."""
from bench.readers import roofline_pct


def read(run):
    return roofline_pct(run)
