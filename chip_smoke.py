#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. Environment and build: the card's name and power limit, torch/CUDA
   versions, and the build of every CUDA source under
   ``src/repro_torch/csrc`` (one nvcc each, in parallel) with the
   compiler's register/spill report.
2. Every kernel against its plain PyTorch version on the card, and (at
   the float32-accumulating policies) against the math oracle of
   ``kernels/ref.py``, on ragged shapes, for every precision policy, both
   distances, both folds, ``w_valid`` 0 and 1 and both multiset layouts;
   each comparison must also catch a planted 1 % error.
3. The main path at the paper's size (N=50 000, l=5 000, k=10, dim=100):
   multiset evaluation in fused/flat, fused/loop and two_pass against the
   ``torch`` backend; greedy, stochastic and lazy greedy on the device plan
   against the host plan (identical indices and evaluation counts);
   multiset greedy against mincache greedy. Kernel launches are counted
   over this phase only.
4. At the main path's shapes: each kernel against its plain version, then
   timed with CUDA events beside its plain version, the cuBLAS Gram product
   alone (a yardstick the port never calls), and the least time the card
   could take (its bound).

The last three lines are the card's name and power limit, a JSON object
listing each kernel, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: Bands of kernel vs plain (and vs the math oracle of kernels/ref.py) on
#: the card, on max|err| / scale with scale = max(1, max|plain|, g·(max‖v‖² +
#: max‖s‖²)): the Gram identity ‖v‖²+‖s‖²−2⟨v,s⟩ loses eps·(‖v‖²+‖s‖²)
#: absolute however small the distance, and the rbf transform scales that
#: by at most g = 2γ (g = 1 for sqeuclidean). Kernel and plain version round
#: the payload alike and, but for fp16_strict, both accumulate in fp32, so
#: bf16 and fp16 keep the fp32 band; on the H100 the largest reading of the
#: three was 0.18 of it (fused_eval, bf16, d = 1024). fp16_strict accumulates
#: in fp16 in an order that the plain version follows step for step, so its
#: distances agree bit for bit and only the fp32 sum over n and the 1/n
#: scaling differ: its largest reading was 2.9e-8 of the scale, and its band
#: is 1e-6. Every comparison also plants a 1 % error in the kernel's output
#: (and, at the half policies, an unrounded payload) and fails unless the
#: band catches it.
BANDS = {"fp32": 1e-5, "bf16": 1e-5, "fp16": 1e-5, "fp16_strict": 1e-6}
#: Kernel vs plain at the main path's shapes (fp32), relative to max|plain|.
MAIN_REL = 1e-5
POLICIES = ("fp32", "bf16", "fp16", "fp16_strict")

KERNELS = {
    "fused_eval": ("src/repro_torch/csrc/exemplar_eval.cu",
                   "src/repro/kernels/exemplar_eval.py:172"),
    "two_pass_eval": ("src/repro_torch/csrc/exemplar_eval.cu",
                      "src/repro/kernels/exemplar_eval.py:219"),
    "gain_eval": ("src/repro_torch/csrc/marginal_gain.cu",
                  "src/repro/kernels/marginal_gain.py:124"),
    "gain_update_eval": ("src/repro_torch/csrc/marginal_gain.cu",
                         "src/repro/kernels/marginal_gain.py:185"),
}

#: Dense peaks per card (NVIDIA data sheets): fp32 outside the tensor cores,
#: bf16/fp16 on the tensor cores, device memory bandwidth.
PEAKS = {
    "H100 SXM": {"fp32": 67e12, "half": 989e12, "bw": 3.35e12},
    "H100 NVL": {"fp32": 60e12, "half": 835e12, "bw": 3.9e12},
    "H100 PCIe": {"fp32": 51e12, "half": 756e12, "bw": 2.0e12},
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def peaks_for(name: str) -> dict:
    if "PCIe" in name:
        return PEAKS["H100 PCIe"]
    if "NVL" in name:
        return PEAKS["H100 NVL"]
    return PEAKS["H100 SXM"]


class Checker:
    """Kernel-vs-plain comparisons. Remembers, per kernel and policy, the
    largest absolute error, the largest error over its band, and the
    smallest planted fault over its band."""

    def __init__(self, strict: bool = True):
        self.strict = strict
        self.max_err = {}
        self.of_band = {}
        self.fault_over_band = {}
        self.cases = 0

    def __call__(self, name, got, ref, policy, what, scale=1.0, faults=()):
        import torch

        torch.cuda.synchronize()
        got = got.float()
        ref = ref.float()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} [{what}]: shape {tuple(got.shape)} "
                                 f"vs {tuple(ref.shape)} or non-finite values")
        top = float(ref.abs().max()) if ref.numel() else 0.0
        band = BANDS[policy] * max(1.0, scale, top)
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        key = (name, policy)
        if self.strict and not err <= band:
            raise AssertionError(f"{name} [{what}]: max abs err {err:.3e} > "
                                 f"band {band:.3e}")
        for label, bad in (("x0.99", got * 0.99),) + tuple(faults):
            caught = float((bad.float() - ref).abs().max()) / band
            if self.strict and not caught > 1.0:
                raise AssertionError(f"{name} [{what}]: the band {band:.3e} "
                                     f"misses the planted fault {label}")
            if caught < self.fault_over_band.get(key, (float("inf"),))[0]:
                self.fault_over_band[key] = (caught, f"{what}, {label}")
        self.max_err[key] = max(self.max_err.get(key, 0.0), err)
        if err / band >= self.of_band.get(key, (-1.0, ""))[0]:
            self.of_band[key] = (err / band, what)
        self.cases += 1


def phase_kernels(check: Checker):
    import numpy as np
    import torch

    from repro_torch.core.evaluator import e0_distances
    from repro_torch.core.functions import SIM_ALPHA, SIM_BETA
    from repro_torch.core.precision import FP32, resolve
    from repro_torch.kernels import exemplar_eval as ee
    from repro_torch.kernels import marginal_gain as mg
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    affine = (SIM_ALPHA, SIM_BETA)

    def problem(n, l, k, d, m, payload, dist, seed):
        """``wide``: the reference tests' normal+2 payloads, distances
        O(2d) under norms O(5d); ``unit``: distances O(1), where neither the
        similarity relu(α + β·d) of the max fold nor the rbf transform is
        flat."""
        rng = np.random.default_rng(seed)
        sigma, shift = (1.0, 2.0) if payload == "wide" else ((2 * d) ** -0.5,
                                                              0.1)
        V = rng.normal(size=(n, d)) * sigma + shift
        S = rng.normal(size=(l, k, d)) * sigma + shift
        lengths = rng.integers(1, k + 1, size=l)
        C = V[rng.choice(n, size=m, replace=False)]
        w = V[n // 2]
        typical = 2 * d * sigma ** 2
        if dist == "rbf":
            typical = 2 * (1 - np.exp(-typical))
        cmin = rng.uniform(0.5, 1.5, size=n) * typical
        cmax = rng.uniform(0.0, 0.8, size=n)
        g = 2.0 if dist == "rbf" else 1.0
        scale = g * float((V * V).sum(-1).max() + (S * S).sum(-1).max())
        t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=dt, device=dev).contiguous()
        return (t(V), t(S), t(lengths, torch.int32), t(C), t(w), t(cmin),
                t(cmax), scale)

    def synced(out):
        # each kernel launch is followed by a synchronize, so a fault in the
        # kernel surfaces at its own launch
        torch.cuda.synchronize()
        return out

    cases = [(4099, 301, 7, d, 517, payload, dist) for d in (100, 129)
             for payload, dist in (("wide", "sqeuclidean"),
                                   ("unit", "sqeuclidean"), ("unit", "rbf"))]
    for (n, l, k, d, m, payload, dist) in cases:
        V, S, lengths, C, w, cmin, cmax, scale = problem(n, l, k, d, m,
                                                         payload, dist, d)
        chk = functools.partial(check, scale=scale)
        gamma = 1.0 if dist == "rbf" else None
        folds = (("min", None, cmin),) + (
            (("max", affine, cmax),) if payload == "unit" else ())
        for pol in POLICIES:
            p = resolve(pol)
            oracle = pol != "fp16_strict"
            kc = ops.kernel_config(k, d, p).k_chunk
            d_e0 = e0_distances(V, None, dist, p).float().contiguous()
            tag = f"n={n} l={l} k={k} d={d} {payload} {dist} {pol}"
            Sk = S.permute(1, 0, 2).contiguous()
            ev_ref = (ref.exemplar_eval_ref(V, S, lengths, d_e0, p, gamma)
                      if oracle else None)
            for layout, SS in (("flat", Sk), ("loop", S)):
                kw = dict(n_total=n, policy=p, layout=layout, rbf_gamma=gamma)
                got = synced(ee.fused_eval(V, SS, lengths, d_e0, k_chunk=kc,
                                           **kw))
                chk("fused_eval", got,
                    ee.fused_eval_plain(V, SS, lengths, d_e0, **kw), pol,
                    f"{tag} {layout}")
                if oracle:
                    chk("fused_eval", got, ev_ref, pol,
                        f"{tag} {layout} vs oracle")
            kw = dict(n_total=n, policy=p, rbf_gamma=gamma)
            W = synced(ee.two_pass_eval(V, S, lengths, d_e0, k_chunk=kc, **kw))
            Wp = ee.two_pass_eval_plain(V, S, lengths, d_e0, **kw)
            unrounded = () if pol == "fp32" else (("unrounded payload", n * (
                ee.two_pass_eval_plain(V, S, lengths, d_e0, n_total=n,
                                       policy=FP32, rbf_gamma=gamma))),)
            chk("two_pass_eval", W * n, Wp * n, pol, f"{tag} W·n",
                faults=unrounded)
            chk("two_pass_eval", W.sum(1), Wp.sum(1), pol, f"{tag} rowsum")
            if oracle:
                chk("two_pass_eval", W * n,
                    ref.work_matrix_ref(V, S, lengths, d_e0, p, gamma) * n,
                    pol, f"{tag} W·n vs oracle")
            if pol != "fp32":  # payload already in the compute dtype
                Vh = V.to(p.compute_dtype)
                Sh = Sk.to(p.compute_dtype)
                kwf = dict(n_total=n, policy=p, layout="flat", rbf_gamma=gamma)
                chk("fused_eval",
                    synced(ee.fused_eval(Vh, Sh, lengths, d_e0, k_chunk=kc,
                                         **kwf)),
                    ee.fused_eval_plain(Vh, Sh, lengths, d_e0, **kwf), pol,
                    f"{tag} flat, {p.compute_dtype} payload")
            for fold, aff, cache in folds:
                kw = dict(n_total=n, policy=p, rbf_gamma=gamma, fold=fold,
                          affine=aff)
                okw = dict(policy=p, rbf_gamma=gamma, fold=fold, affine=aff)
                got = synced(mg.gain_eval(V, C, cache, **kw))
                chk("gain_eval", got, mg.gain_eval_plain(V, C, cache, **kw),
                    pol, f"{tag} {fold}")
                if oracle:
                    chk("gain_eval", got,
                        ref.marginal_gain_ref(V, C, cache, **okw), pol,
                        f"{tag} {fold} vs oracle")
                for wv in (0.0, 1.0):
                    wvt = torch.tensor(wv, device=dev)
                    g, nc = synced(mg.gain_update_eval(V, C, cache, w, wvt,
                                                       **kw))
                    gp, ncp = mg.gain_update_eval_plain(V, C, cache, w, wvt,
                                                        **kw)
                    what = f"{tag} {fold} w_valid={wv:g}"
                    chk("gain_update_eval", g, gp, pol, what + " gains")
                    chk("gain_update_eval", nc, ncp, pol, what + " cache")
                    if oracle:
                        nco = (ref.fold_winner_ref(V, w, cache, **okw)
                               if wv else cache)
                        chk("gain_update_eval", nc, nco, pol,
                            what + " cache vs oracle")
                        chk("gain_update_eval", g,
                            ref.marginal_gain_ref(V, C, nco, **okw), pol,
                            what + " gains vs oracle")
    # the sweep's deep and wide ends: k=500 stages S in k-chunks; d=1024
    # stages one k slot at a time
    for (n, l, k, d) in ((1031, 40, 500, 100), (1031, 40, 12, 1024)):
        V, S, lengths, _, _, _, _, scale = problem(n, l, k, d, 8, "wide",
                                                   "sqeuclidean", k)
        for pol in POLICIES:
            p = resolve(pol)
            cfg = ops.kernel_config(k, d, p)
            d_e0 = e0_distances(V, None, "sqeuclidean", p).float()
            Sk = S.permute(1, 0, 2).contiguous()
            kw = dict(n_total=n, policy=p, layout="flat")
            check("fused_eval",
                  synced(ee.fused_eval(V, Sk, lengths, d_e0,
                                       k_chunk=cfg.k_chunk, **kw)),
                  ee.fused_eval_plain(V, Sk, lengths, d_e0, **kw), pol,
                  f"n={n} l={l} k={k} d={d} {pol} k_chunk={cfg.k_chunk}",
                  scale=scale)


def report_kernel_checks(check: Checker):
    log(f"    {check.cases} comparisons; per kernel and policy: max abs err, "
        f"largest err / band (case), smallest planted fault / band (case)")
    for name in KERNELS:
        for pol in POLICIES:
            key = (name, pol)
            of_band, what = check.of_band[key]
            fault, fwhat = check.fault_over_band[key]
            log(f"      {name} {pol}: {check.max_err[key]:.3e}, {of_band:.3e} "
                f"({what}), {fault:.3g} ({fwhat})")


def gain_gap(f, sel_a, sel_b, t):
    """Host gains of the two diverging picks at round t."""
    cache = f.init_cache()
    for j in sel_a[:t]:
        cache = f.fold_winner(cache, j)
    g = f.gains_from_cache(cache, [sel_a[t], sel_b[t]]).cpu().tolist()
    return (f"round {t}: {sel_a[t]} gain {g[0]:.9g} vs {sel_b[t]} gain "
            f"{g[1]:.9g} (gap {g[0] - g[1]:.3e})")


def same_selection(what, dev_r, host_r, f, rtol=1e-5):
    import numpy as np

    if dev_r.indices != host_r.indices:
        t = next(i for i, (a, b) in enumerate(zip(dev_r.indices,
                                                  host_r.indices)) if a != b)
        raise AssertionError(f"{what}: device {dev_r.indices} != host "
                             f"{host_r.indices}; {gain_gap(f, host_r.indices, dev_r.indices, t)}")
    if dev_r.evaluations != host_r.evaluations:
        raise AssertionError(f"{what}: evaluations {dev_r.evaluations} != "
                             f"{host_r.evaluations}")
    a, b = np.asarray(dev_r.trajectory), np.asarray(host_r.trajectory)
    err = float(np.max(np.abs(a - b)))
    if not err <= rtol * max(1.0, float(np.max(np.abs(b)))):
        raise AssertionError(f"{what}: trajectories differ by {err:.3e}")
    log(f"  {what}: indices {dev_r.indices} identical, evaluations "
        f"{dev_r.evaluations} identical, trajectory max diff {err:.3e}")


def phase_main_path():
    """The main path at the paper's size; returns wall times (s)."""
    import numpy as np
    import torch

    from repro_torch.core import (EvalConfig, ExemplarClustering,
                                  PackedMultiset, greedy, lazy_greedy,
                                  stochastic_greedy)
    from repro_torch.data.synthetic import blobs, uniform_problem

    dev = torch.device("cuda")
    N, L, K, DIM = 50_000, 5_000, 10, 100
    walls = {}
    V = uniform_problem(N, DIM, seed=0)
    S = uniform_problem(L * K, DIM, seed=1).reshape(L, K, DIM)
    packed = PackedMultiset(torch.as_tensor(S, device=dev),
                            torch.full((L,), K, dtype=torch.int32, device=dev))
    # the torch backend chunks to bound its (n, l·k) block at this size
    ref = ExemplarClustering(V, EvalConfig(memory_budget_bytes=4 << 30)
                             ).loss_multi(packed)
    for mode, variant in (("fused", "flat"), ("fused", "loop"),
                          ("two_pass", "loop")):
        f = ExemplarClustering(V, EvalConfig(backend="cuda", mode=mode,
                                             kernel_variant=variant))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = f.loss_multi(packed)
        torch.cuda.synchronize()
        walls[f"evaluate_multiset {mode}/{variant}"] = time.perf_counter() - t0
        rel = float((got - ref).abs().max() / ref.abs().max())
        if not (got.shape == (L,) and bool(torch.isfinite(got).all())
                and rel <= 1e-4):
            raise AssertionError(f"evaluate_multiset {mode}/{variant}: "
                                 f"relative error {rel:.3e} vs torch")
        log(f"  evaluate_multiset {mode}/{variant} l={L} k={K}: relative "
            f"error vs torch backend {rel:.3e}; "
            f"{walls[f'evaluate_multiset {mode}/{variant}'] * 1e3:.1f} ms")

    X, _ = blobs(N, DIM, centers=16, seed=0)
    f = ExemplarClustering(X, EvalConfig(backend="cuda"))
    for name, run in (
            ("greedy", lambda mode: greedy(f, K, mode=mode)),
            ("stochastic_greedy",
             lambda mode: stochastic_greedy(f, K, seed=0, mode=mode)),
            ("lazy_greedy", lambda mode: lazy_greedy(f, K, mode=mode))):
        res = {}
        for mode in ("device", "host"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[mode] = run(mode)
            torch.cuda.synchronize()
            walls[f"{name} {mode}"] = time.perf_counter() - t0
        same_selection(f"{name} n={N} k={K}", res["device"], res["host"], f)
        log(f"    wall: device {walls[f'{name} device']:.3f} s, host "
            f"{walls[f'{name} host']:.3f} s")

    Xs = X[:8192]
    fs = ExemplarClustering(Xs, EvalConfig(backend="cuda"))
    ms = greedy(fs, K, mode="multiset")
    mc = greedy(fs, K, mode="mincache")
    same_selection(f"greedy multiset vs mincache n={len(Xs)}", ms, mc, fs,
                   rtol=1e-4)
    return walls


def cuda_times(fn, reps: int, warmup: int = 2) -> list:
    """Per-call device times (ms) of ``fn`` by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    return statistics.median(cuda_times(fn, reps, warmup))


def phase_timing(peaks: dict) -> dict:
    """Per-kernel times at the main path's shapes (fp32 policy)."""
    import torch

    from repro_torch.core.distances import fp32_is_ieee
    from repro_torch.core.evaluator import e0_distances
    from repro_torch.core.precision import FP32
    from repro_torch.data.synthetic import blobs, uniform_problem
    from repro_torch.kernels import exemplar_eval as ee
    from repro_torch.kernels import marginal_gain as mg
    from repro_torch.kernels import ops

    fp32_is_ieee()
    dev = torch.device("cuda")
    N, L, K, DIM = 50_000, 5_000, 10, 100
    V = torch.as_tensor(uniform_problem(N, DIM, seed=0), device=dev)
    S = torch.as_tensor(uniform_problem(L * K, DIM, seed=1), device=dev
                        ).reshape(L, K, DIM)
    Sk = S.permute(1, 0, 2).contiguous()
    lengths = torch.full((L,), K, dtype=torch.int32, device=dev)
    d_e0 = e0_distances(V, None, "sqeuclidean", FP32).contiguous()
    kc = ops.kernel_config(K, DIM, FP32).k_chunk
    Sflat = S.reshape(L * K, DIM)

    X, _ = blobs(N, DIM, centers=16, seed=0)
    Vb = torch.as_tensor(X, device=dev)
    cache = e0_distances(Vb, None, "sqeuclidean", FP32).contiguous()
    w = Vb[123].contiguous()
    wv = torch.ones((), device=dev)
    top = Vb[:256].contiguous()
    out_cache = torch.empty_like(cache)

    def bound(flops, nbytes):
        t_ops = flops / peaks["fp32"] * 1e3
        t_bytes = nbytes / peaks["bw"] * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    eval_flops = 2.0 * N * int(lengths.sum()) * DIM
    eval_in = 4 * (N * DIM + L * K * DIM + L + N)
    gain_flops = 2.0 * N * N * DIM
    gain_in = 4 * (N * DIM + N * DIM + N)
    R = 7
    rows = {}

    def kernel_ms(fn):
        ts = cuda_times(fn, R)
        q1, _, q3 = statistics.quantiles(ts, n=4)
        return dict(ms=statistics.median(ts), ms_q1=q1, ms_q3=q3)

    kw = dict(n_total=N, policy=FP32)
    rel = {}

    def agree(name, got, ref, what):
        """The kernel against its plain version at the main path's shapes:
        fp32 sums of 50 000 terms in another order, relative 1e-5."""
        torch.cuda.synchronize()
        err = float((got - ref).abs().max() / ref.abs().max())
        if not (got.shape == ref.shape and bool(torch.isfinite(got).all())
                and err <= MAIN_REL):
            raise AssertionError(f"{name} [{what}] at the main path's shapes: "
                                 f"relative error {err:.3e} > {MAIN_REL:.0e}")
        rel[name] = max(rel.get(name, 0.0), err)
        log(f"    {name} [{what}]: relative error vs plain {err:.3e}")

    for layout, SS in (("flat", Sk), ("loop", S)):
        agree("fused_eval",
              ee.fused_eval(V, SS, lengths, d_e0, k_chunk=kc, layout=layout,
                            **kw),
              ee.fused_eval_plain(V, SS, lengths, d_e0, layout=layout, **kw),
              f"l={L} {layout}")
    agree("two_pass_eval", ee.two_pass_eval(V, S, lengths, d_e0, k_chunk=kc,
                                            **kw),
          ee.two_pass_eval_plain(V, S, lengths, d_e0, **kw), f"W ({L}, {N})")
    for C in (Vb, top):
        agree("gain_eval", mg.gain_eval(Vb, C, cache, **kw),
              mg.gain_eval_plain(Vb, C, cache, **kw), f"m={C.shape[0]}")
    g, nc = mg.gain_update_eval(Vb, Vb, cache, w, wv, **kw)
    gp, ncp = mg.gain_update_eval_plain(Vb, Vb, cache, w, wv, **kw)
    agree("gain_update_eval", g, gp, f"gains m={N}")
    agree("gain_update_eval", nc, ncp, f"cache n={N}")
    del g, nc, gp, ncp

    rows["fused_eval"] = dict(
        **kernel_ms(lambda: ee.fused_eval(V, Sk, lengths, d_e0, k_chunk=kc,
                                          layout="flat", **kw)),
        plain_ms=cuda_ms(lambda: ee.fused_eval_plain(V, Sk, lengths, d_e0,
                                                     layout="flat", **kw), R),
        library_ms=cuda_ms(lambda: V @ Sflat.T, R),
        bound=bound(eval_flops, eval_in + 4 * L))
    rows["fused_eval"]["loop_ms"] = cuda_ms(
        lambda: ee.fused_eval(V, S, lengths, d_e0, k_chunk=kc, layout="loop",
                              **kw), R)
    rows["two_pass_eval"] = dict(
        **kernel_ms(lambda: ee.two_pass_eval(V, S, lengths, d_e0,
                                             k_chunk=kc, **kw)),
        plain_ms=cuda_ms(lambda: ee.two_pass_eval_plain(V, S, lengths, d_e0,
                                                        **kw), R),
        library_ms=cuda_ms(lambda: V @ Sflat.T, R),
        bound=bound(eval_flops, eval_in + 4 * L * N))
    rows["gain_eval"] = dict(
        **kernel_ms(lambda: mg.gain_eval(Vb, Vb, cache, **kw)),
        plain_ms=cuda_ms(lambda: mg.gain_eval_plain(Vb, Vb, cache, **kw), R),
        library_ms=cuda_ms(lambda: Vb @ Vb.T, R),
        bound=bound(gain_flops, gain_in + 4 * N))
    rows["gain_eval"]["top256_ms"] = cuda_ms(
        lambda: mg.gain_eval(Vb, top, cache, **kw), 20)
    rows["gain_eval"]["top256_plain_ms"] = cuda_ms(
        lambda: mg.gain_eval_plain(Vb, top, cache, **kw), 20)
    rows["gain_eval"]["top256_library_ms"] = cuda_ms(lambda: Vb @ top.T, 20)
    rows["gain_eval"]["top256_bound_ms"] = bound(
        2.0 * N * 256 * DIM, 4 * (N * DIM + 256 * DIM + N + 256))[0]
    rows["gain_update_eval"] = dict(
        **kernel_ms(lambda: mg.gain_update_eval(Vb, Vb, cache, w, wv,
                                                cache_out=out_cache, **kw)),
        plain_ms=cuda_ms(lambda: mg.gain_update_eval_plain(Vb, Vb, cache, w,
                                                           wv, **kw), R),
        library_ms=cuda_ms(lambda: Vb @ Vb.T, R),
        bound=bound(gain_flops + 2.0 * N * DIM,
                    gain_in + 4 * (DIM + 1) + 4 * (N + N)))
    for name, r in rows.items():
        r["main_rel_err"] = rel[name]
    return rows


def phase_end_to_end() -> dict:
    """Steady-state wall times of the main path's user calls (median of 3
    after a warm-up call), and a profile of one device greedy: device busy
    time by kernel against the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (EvalConfig, ExemplarClustering,
                                  PackedMultiset, greedy, lazy_greedy)
    from repro_torch.data.synthetic import blobs, uniform_problem

    N, L, K, DIM = 50_000, 5_000, 10, 100
    dev = torch.device("cuda")
    f = ExemplarClustering(blobs(N, DIM, centers=16, seed=0)[0],
                           EvalConfig(backend="cuda"))
    fe = ExemplarClustering(uniform_problem(N, DIM, seed=0),
                            EvalConfig(backend="cuda"))
    S = uniform_problem(L * K, DIM, seed=1).reshape(L, K, DIM)
    packed = PackedMultiset(torch.as_tensor(S, device=dev),
                            torch.full((L,), K, dtype=torch.int32, device=dev))

    def wall(fn, reps=3):
        fn()
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[reps // 2]

    out = {
        "evaluate_multiset_s": wall(lambda: fe.loss_multi(packed)),
        "greedy_device_s": wall(lambda: greedy(f, K, mode="device")),
        "greedy_host_s": wall(lambda: greedy(f, K, mode="host")),
        "lazy_greedy_device_s": wall(lambda: lazy_greedy(f, K, mode="device")),
        "lazy_greedy_host_s": wall(lambda: lazy_greedy(f, K, mode="host")),
    }
    for mode in ("device", "host"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            greedy(f, K, mode=mode)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel = sorted(((e.self_device_time_total / 1e3, e.key)
                            for e in prof.key_averages()
                            if e.self_device_time_total > 0), reverse=True)
        busy = sum(t for t, _ in by_kernel)
        out[f"greedy_{mode}_profiled_wall_ms"] = wall_ms
        out[f"greedy_{mode}_device_busy_ms"] = busy
        log(f"    profile greedy k={K} {mode}: wall {wall_ms:.1f} ms (profiler "
            f"on), device busy {busy:.1f} ms" + (
                "" if busy else " (no device time in the trace: not measured)"))
        for t, key in by_kernel[:4]:
            log(f"      {t:9.3f} ms  {key[:90]}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build, ops
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    info = _build.build_all()
    log(f"    built {sorted(info)} in {time.perf_counter() - t0:.1f} s")
    for nm, rec in sorted(info.items()):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", rec["log"])]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", rec["log"]))
        log(f"    {nm}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes {spills}")

    log("[2] kernels vs plain versions (and the math oracle) on the card")
    check = Checker()
    phase_kernels(check)
    report_kernel_checks(check)

    log("[3] main path at the paper's size")
    ops.LAUNCHES.clear()
    walls = phase_main_path()
    launches = dict(ops.LAUNCHES)
    log(f"    launches: {json.dumps(launches)}")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")

    log("[4] timing at the main path's shapes (fp32, CUDA events)")
    peaks = peaks_for(torch.cuda.get_device_name(0))
    rows = phase_timing(peaks)
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = rows[name]
        bound_ms, bound_by = r["bound"]
        extra = {k: v for k, v in r.items()
                 if k not in ("ms", "plain_ms", "library_ms", "bound")}
        log(f"    {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
            f"ms, cuBLAS Gram {r['library_ms']:.3f} ms, bound {bound_ms:.3f} "
            f"ms ({bound_by}) {json.dumps(extra)}")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            # at the main path's policy (fp32) on phase 2's ragged shapes;
            # the log above has the others
            "max_abs_err": check.max_err[(name, "fp32")],
            "main_rel_err": r["main_rel_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r["library_ms"]})
    log(f"    main-path first-call wall times (s): {json.dumps(walls)}")
    log("[5] end to end at the paper's size (steady state)")
    log(f"    {json.dumps(phase_end_to_end())}")
    log(f"    total {time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
