"""Roofline share of the multiset calls: the bound of the window's work
over the device time of every operation that ``value_multi`` launched
(``csrc/exemplar_eval.cu``'s kernels, and anything else it runs)."""
from bench.readers import roofline_pct


def read(run):
    return roofline_pct(run)
