"""The device trace of a run's window: torch.profiler over the window, then
the device's busy time, each kernel's device time, the device time of the
program's calls, and the idle gaps by what the host was doing.

Each span the benchmark opens is a ``record_function`` of the name
``bench.<what>``; a span around a call into the program is
``bench.call.<what>``, and every device operation launched inside one is
the program's work, whatever its name. An idle gap of the device is named
by the innermost host event that covers its middle.
"""
from __future__ import annotations

import bisect
import collections
import contextlib

import torch

WINDOW = "bench.window"
CALL = "bench.call."
TOP = 10


def span(name: str):
    """A span of the benchmark; it shows in the trace as ``bench.<name>``."""
    return torch.profiler.record_function(f"bench.{name}")


def call(name: str):
    """A span around a call into the program: ``bench.call.<name>``."""
    return span(f"call.{name}")


@contextlib.contextmanager
def profiled(enabled: bool):
    """Profile the block on the host and the device when ``enabled``;
    yields the profiler (or None)."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof) -> dict:
    """busy_s, window_s (the ``bench.window`` span), device seconds by
    kernel name, ``calls_s`` (device seconds of the operations launched
    inside the program's calls), ``unlaunched_s`` (device seconds of
    operations whose launch the trace lacks), and the top device operations
    and idle gaps."""
    events = prof.profiler.kineto_results.events()
    dev, host, calls, launched = [], [], [], {}
    window = None
    for e in events:
        s, name = e.start_ns(), e.name()
        t = s + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a kernel, copy or fill; not the device's shadow of a span
            if not name.startswith("bench."):
                dev.append((s, t, name, e.correlation_id()))
        elif name == WINDOW:
            window = (s, t)
        else:
            host.append((s, t, name))
            if name.startswith(CALL):
                calls.append((s, t))
            elif name.startswith("cu"):
                # a launch: the runtime's or the driver's call on the host,
                # which shares its correlation id with what it launched
                launched[e.correlation_id()] = s
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = window
    calls = _merge(calls)
    starts = [s for s, _ in calls]
    inside = [(max(s, w0), min(t, w1), name, corr)
              for s, t, name, corr in dev if t > w0 and s < w1]
    kernels = collections.Counter()
    calls_ns = unlaunched_ns = 0
    for s, t, name, corr in inside:
        kernels[name.split("(")[0]] += (t - s) / 1e9
        at = launched.get(corr)
        if at is None:
            unlaunched_ns += t - s
            continue
        j = bisect.bisect_right(starts, at) - 1
        if j >= 0 and at <= calls[j][1]:
            calls_ns += t - s
    busy = _merge([(s, t) for s, t, _, _ in inside])
    busy_s = sum(t - s for s, t in busy) / 1e9
    gaps = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    mids = sorted(((a + b) // 2, b - a) for a, b in zip(edges[0::2], edges[1::2])
                  if b > a)
    for name, ns in zip(_hosts_at(host, [m for m, _ in mids]), mids):
        gaps[name] += ns[1] / 1e9
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) / 1e9,
        "kernels": dict(kernels),
        "calls_s": calls_ns / 1e9,
        "unlaunched_s": unlaunched_ns / 1e9,
        "breakdown": {
            "device_ops": [[n, s] for n, s in kernels.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(TOP)],
        },
    }


def _hosts_at(host, times):
    """For each of the ascending ``times``, the innermost host event that
    covers it: a sweep over the events in order of their start, whose stack
    holds the events still open (host events nest on a thread)."""
    host = sorted(host)
    stack, out, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host: untraced")
    return out
