"""Multiset evaluation, the paper's headline operation: closed loop, one
caller. Call i evaluates l fresh sets of k distinct points of a ground set
drawn once for the run (``ExemplarClustering.value_multi``) and reads the l
values back to the host, as an optimizer reads them.

Traffic parameters: ``l``, ``k``, ``mode`` (the evaluator's ``fused`` or
``two_pass``), ``warmup_calls``, ``check_calls`` (calls judged after the
window besides the first and the last).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import data, reference, work
from bench.devtrace import call, span

GROUND, CALL, WARMUP, SAMPLE = 0, 1, 3, 4


def setup(config, traffic, seed, device):
    V = data.ground_set(config, data.generator(device, seed, GROUND))
    st = {"config": config, "traffic": traffic, "seed": seed,
          "device": device, "V": V, "ahead": data.Ahead(device),
          "f": _program(V, traffic, config["policy"]),
          "lengths": torch.full((traffic["l"],), traffic["k"],
                                dtype=torch.int32, device=device)}
    for w in range(traffic["warmup_calls"]):
        packed = _pack(st, st["ahead"].take(st["ahead"].put(
            _payload, st, WARMUP, w)))
        st["f"].value_multi(packed).cpu()
    return st


def _program(V, traffic, policy):
    from repro_torch.core.evaluator import EvalConfig
    from repro_torch.core.functions import ExemplarClustering

    return ExemplarClustering(V, EvalConfig(backend="cuda",
                                            mode=traffic["mode"],
                                            policy=policy))


def _sets(st, *path):
    cfg, tr = st["config"], st["traffic"]
    return data.k_subsets(cfg["n"], tr["l"], tr["k"],
                          data.generator(st["device"], st["seed"], *path))


def _payload(st, *path):
    """The (l, k, d) points of the sets drawn at ``path``."""
    return st["V"][_sets(st, *path)]


def _pack(st, payload):
    from repro_torch.core.multiset import PackedMultiset

    return PackedMultiset(payload, st["lengths"])


def window(st, seconds, rec):
    """Calls back to back. Call i + 1's sets are drawn on a stream of their
    own while call i runs, so the benchmark's draw is not the calls' work;
    a call's time runs from ``value_multi`` to its values on the host."""
    cfg, tr, ahead = st["config"], st["traffic"], st["ahead"]
    outs, durs = [], []
    t0 = time.perf_counter()
    with span("draw"):
        drawn = ahead.put(_payload, st, CALL, 0)
    while True:
        i = len(outs)
        ta = time.perf_counter()
        packed, drawn, out = _pack(st, ahead.take(drawn)), None, None
        try:
            with call("value_multi"):
                vals = st["f"].value_multi(packed)
            with span("draw"):
                drawn = ahead.put(_payload, st, CALL, i + 1)
            with span("readback"):
                out = vals.cpu().numpy()
            durs.append(time.perf_counter() - ta)
        except (RuntimeError, ValueError) as e:
            print(f"call {i} failed: {e}", flush=True)
        if drawn is None:
            with span("draw"):
                drawn = ahead.put(_payload, st, CALL, i + 1)
        outs.append(out)
        t1 = time.perf_counter()
        if t1 - t0 >= seconds:
            break
    done = len(durs)
    rec.window_s = t1 - t0
    rec.units = {"attempted": len(outs), "failed": len(outs) - done,
                 "calls": done, "sets": done * tr["l"]}
    rec.durations_s["eval"] = durs
    rec.work = work.multiset(cfg["n"], tr["l"], tr["k"], cfg["d"],
                             cfg["policy"]).times(done)
    st["outs"] = outs


def check(st, rec):
    """Widest gap of a judged call's values from the reference's, as a share
    of L(∅); the first and last calls and ``check_calls`` drawn from the
    seed are judged."""
    outs = st.pop("outs")
    del st["f"]
    if st["device"] == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(data.seed_of(st["seed"], SAMPLE))
    n = len(outs)
    sample = {0, n - 1} | set(
        rng.choice(n, size=min(n, st["traffic"]["check_calls"]),
                   replace=False).tolist())
    gap = 0.0
    for i in sorted(sample):
        if outs[i] is not None:
            gap = max(gap, reference.multiset_gap(
                st["V"], _sets(st, CALL, i), outs[i], st["config"]["policy"]))
    return {"value_gap": gap}


def control(config, traffic, seed, device, lower):
    """The control's reading on the sets of the first ``check_calls`` calls,
    judged as ``check`` judges the program. ``lower`` is (``"program"``,
    policy): the program run at that policy; or (``"reference"``,
    precision): the reference at that precision, in the program's place."""
    path, precision = lower
    st = {"config": config, "traffic": traffic, "seed": seed,
          "device": device,
          "V": data.ground_set(config, data.generator(device, seed, GROUND))}
    if path == "program":
        st["lengths"] = torch.full((traffic["l"],), traffic["k"],
                                   dtype=torch.int32, device=device)
        f = _program(st["V"], traffic, precision)
    gap = 0.0
    for i in range(traffic["check_calls"]):
        idx = _sets(st, CALL, i)
        if path == "program":
            vals = f.value_multi(_pack(st, st["V"][idx])).cpu().numpy()
        else:
            vals = reference.multiset_values(st["V"], idx, precision).tolist()
        gap = max(gap, reference.multiset_gap(st["V"], idx, vals,
                                              config["policy"]))
    return {"value_gap": gap}
