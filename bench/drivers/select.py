"""Selection: closed loop, one caller. Selection i takes a fresh ground set
drawn from the seed on a stream of its own while selection i - 1 ran, then
builds ``ExemplarClustering`` on it and runs the strategy to its k picks on
the host; its time is that.

Traffic parameters: ``strategy`` (``greedy``, ``lazy_greedy`` or
``stochastic_greedy`` of ``repro_torch.core.optimizers``), ``mode``, ``k``,
``options`` (further keyword arguments of the strategy), ``warmup``
(selections before the window), ``check_selections`` (judged after the
window besides the first and the last).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import data, reference, work
from bench.devtrace import call, span

GROUND, WARMUP, SAMPLE = 2, 3, 4
#: Strategies whose picks are the greedy argmax (CELF's are too): their
#: picks are judged against the best gain of each round.
EXACT = ("greedy", "lazy_greedy")


def setup(config, traffic, seed, device):
    from repro_torch.core import optimizers
    from repro_torch.core.evaluator import EvalConfig

    st = {"config": config, "traffic": traffic, "seed": seed,
          "device": device, "ahead": data.Ahead(device),
          "cfg": EvalConfig(backend="cuda", mode="fused",
                            policy=config["policy"]),
          "strategy": getattr(optimizers, traffic["strategy"])}
    for w in range(traffic["warmup"]):
        _select(st, st["ahead"].take(st["ahead"].put(_ground, st, WARMUP, w)))
    return st


def _ground(st, *path):
    return data.ground_set(st["config"],
                           data.generator(st["device"], st["seed"], *path))


def _select(st, V):
    from repro_torch.core.functions import ExemplarClustering

    tr = st["traffic"]
    t0 = time.perf_counter()
    with call("construct"):
        f = ExemplarClustering(V, st["cfg"])
    with call(tr["strategy"]):
        res = st["strategy"](f, tr["k"], mode=tr["mode"], **tr["options"])
    return (res.indices, res.trajectory), time.perf_counter() - t0


def window(st, seconds, rec):
    """Selections back to back; ground set i + 1 is drawn beside
    selection i."""
    cfg, tr, ahead = st["config"], st["traffic"], st["ahead"]
    outs, durs, failed = [], [], 0
    t0 = time.perf_counter()
    with span("draw"):
        drawn = ahead.put(_ground, st, GROUND, 0)
    while True:
        V = ahead.take(drawn)
        with span("draw"):
            drawn = ahead.put(_ground, st, GROUND, len(outs) + 1)
        try:
            out, dt = _select(st, V)
            durs.append(dt)
        except (RuntimeError, ValueError) as e:
            print(f"selection {len(outs)} failed: {e}", flush=True)
            out, failed = None, failed + 1
        outs.append(out)
        del V
        t1 = time.perf_counter()
        if t1 - t0 >= seconds:
            break
    done = len(outs) - failed
    rec.window_s = t1 - t0
    rec.units = {"attempted": len(outs), "failed": failed,
                 "selections": done}
    rec.durations_s["select"] = durs
    rec.work = work.greedy(cfg["n"], tr["k"], cfg["d"],
                           cfg["policy"]).times(done)
    st["outs"] = outs


def check(st, rec):
    """Widest gap of a judged selection from the reference (see
    ``reference.greedy_gap``), as a share of L(∅); the first and last
    selections and ``check_selections`` drawn from the seed are judged."""
    outs = st.pop("outs")
    if st["device"] == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(data.seed_of(st["seed"], SAMPLE))
    n = len(outs)
    sample = {0, n - 1} | set(
        rng.choice(n, size=min(n, st["traffic"]["check_selections"]),
                   replace=False).tolist())
    gap = 0.0
    for i in sorted(sample):
        if outs[i] is not None:
            picks, values = outs[i]
            gap = max(gap, reference.greedy_gap(
                _ground(st, GROUND, i), picks, values, st["config"]["policy"],
                exact=st["traffic"]["strategy"] in EXACT))
    return {"select_gap": gap}


def control(config, traffic, seed, device, lower):
    """The control's reading on the ground sets of the first
    ``check_selections`` selections, judged as ``check`` judges the
    program. ``lower`` is (``"program"``, policy): the program's strategy
    at that policy; or (``"reference"``, precision): the reference's greedy
    at that precision, in the program's place."""
    path, precision = lower
    st = {"config": config, "traffic": traffic, "seed": seed,
          "device": device}
    if path == "program":
        program = setup(dict(config, policy=precision),
                        dict(traffic, warmup=0), seed, device)
    gap = 0.0
    for i in range(traffic["check_selections"]):
        V = _ground(st, GROUND, i)
        if path == "program":
            (picks, values), _ = _select(program, V)
        else:
            picks, values = reference.greedy_select(V, traffic["k"],
                                                    precision)
        gap = max(gap, reference.greedy_gap(
            V, picks, values, config["policy"],
            exact=traffic["strategy"] in EXACT))
    return {"select_gap": gap}
