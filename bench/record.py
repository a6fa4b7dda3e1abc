"""What one run of a cell leaves for the metric readers."""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

from bench.work import Work


@dataclasses.dataclass
class RunRecord:
    workload: str
    config: dict
    traffic: dict
    device_kind: str
    #: process start (the first line of run.py) to the window's start
    setup_s: Optional[float] = None
    #: host clock from the window's start to its last answer on the host
    window_s: Optional[float] = None
    #: units of work completed in the window, by kind ("sets", "calls",
    #: "selections")
    units: dict = dataclasses.field(default_factory=dict)
    #: host-clock seconds of each call the benchmark spans, by span name
    durations_s: dict = dataclasses.field(default_factory=dict)
    #: kernel launches over the window (repro_torch.kernels.ops.LAUNCHES)
    launches: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    #: the work of every call completed in the window
    work: Optional[Work] = None
    #: devtrace.summarize of the window (``--trace 1``)
    device_trace: Optional[dict] = None
