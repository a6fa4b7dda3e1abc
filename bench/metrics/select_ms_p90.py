"""90th percentile of one selection's wall time to its picks on the host."""
from bench.readers import percentile_ms


def read(run):
    return percentile_ms(run, "select", 90)
