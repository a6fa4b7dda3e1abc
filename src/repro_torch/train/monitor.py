"""Straggler detection and step-time accounting.

At pod scale a single slow host gates every synchronous collective. The
monitor keeps an EWMA + variance of step wall times, flags steps beyond
``mean + k·σ``, and exposes the hook the launcher uses to decide hot-spare
substitution (at real scale: re-slicing the job onto a spare pod; here the
policy and bookkeeping are implemented and tested with an injected slowdown).

The JAX package's ``train/monitor.py``, copied as it is (it uses no JAX).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    mean_s: float
    threshold_s: float


class StepMonitor:
    def __init__(self, k_sigma: float = 3.0, min_samples: int = 8,
                 alpha: float = 0.1,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None):
        self.k = k_sigma
        self.min_samples = min_samples
        self.alpha = alpha
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.events: list[StragglerEvent] = []
        self.on_straggler = on_straggler
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> Optional[StragglerEvent]:
        dt = time.perf_counter() - self._t0
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> Optional[StragglerEvent]:
        ev = None
        if self.n >= self.min_samples:
            thresh = self.mean + self.k * math.sqrt(max(self.var, 1e-12))
            if dt > thresh:
                ev = StragglerEvent(step, dt, self.mean, thresh)
                self.events.append(ev)
                if self.on_straggler:
                    self.on_straggler(ev)
        # EWMA update (straggler steps update slowly so one hiccup doesn't
        # poison the baseline)
        a = self.alpha if ev is None else self.alpha * 0.1
        delta = dt - self.mean
        self.mean += a * delta
        self.var = (1 - a) * (self.var + a * delta * delta)
        self.n += 1
        return ev

    @property
    def straggler_fraction(self) -> float:
        return len(self.events) / max(self.n, 1)
