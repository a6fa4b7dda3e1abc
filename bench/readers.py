"""What the metric readers of ``bench/metrics/`` share. Each returns None
where the run holds nothing to read."""
from __future__ import annotations

import numpy as np

from bench import work


def rate(run, unit: str):
    done = run.units.get(unit)
    if done is None or not run.window_s:
        return None
    return done / run.window_s


def percentile_ms(run, span: str, q: float):
    durs = run.durations_s.get(span)
    if not durs:
        return None
    return float(np.percentile(durs, q)) * 1e3


def launches_per(run, unit: str):
    done = run.units.get(unit)
    if not done:
        return None
    return sum(run.launches.values()) / done


def idle_pct(run):
    t = run.device_trace
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(run):
    """The least time the card could take for the window's work over the
    device time of every operation that the program's calls launched."""
    t = run.device_trace
    if t is None or run.work is None or not t["calls_s"]:
        return None
    if t["unlaunched_s"] > 0:
        raise RuntimeError(
            f"{t['unlaunched_s']} s of device operations have no launch in "
            f"the trace: the program's device time is not known")
    bound = work.bound_s(run.work, run.device_kind)
    if bound is None:
        return None
    return 100.0 * bound / t["calls_s"]
