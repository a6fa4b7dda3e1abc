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
   each comparison must also catch a planted 1 % error. The batched gain
   kernels at B = 1, 3 and 8 with a ``w_valid`` that mixes 0 and 1, and
   each request of a batched launch bit for bit equal to its own unbatched
   launch. The sieve kernels at r ∈ {1, 35, 65} rows and n at the edges
   of their split of n (1, 3, a block's span at small n and one past it,
   8 spans + 1, 257, 4 097, 4 099, 50 000, and 8 load groups and one
   past), both templates, with and without the seed as its
   own operand; bit for bit, a row's gain at r = 1 and 35 (wherever it
   sits in the table, 16-byte aligned or not) against the r = 65 launch,
   and the ``seed=`` launch against the launch on the concatenated table;
   the batched one at P ∈ {1, 3, 16}, each partition bit for bit its
   unbatched launch on its own slice (off 16 bytes at n = 4 099) and on an
   aligned copy. The gain and exemplar-eval
   kernels at n on either side of their segment edges (SEG − 1, SEG,
   SEG + 1, 2·SEG + 1) and at n = 50 000, all four policies; then their
   column invariance, bit for bit: ``gain_eval`` / ``gain_update_eval`` at
   m ∈ {1, 33, 256, 257} against the same candidates of the m = 50 000
   launch, ``fused_eval`` on 97 sets against the l = 5 000 launch, at fp32
   and fp16_strict.
3. The main path at the paper's size (N=50 000, l=5 000, k=10, dim=100):
   multiset evaluation in fused/flat, fused/loop and two_pass against the
   ``torch`` backend; greedy, stochastic and lazy greedy on the device plan
   against the host plan (identical indices and evaluation counts);
   multiset greedy against mincache greedy. Kernel launches are counted
   over this phase only.
   Then the serving path: 64 tenants of (8 192, 100) through
   ``SelectionService`` (64 dense requests with ragged k, 16 lazy, 16
   stochastic) and one paper-size bucket (``run_selection_batch``, four
   tenants of (50 000, 100), k = 10), every served result identical to the
   tenant's unbatched call; launches, and the shapes each batched kernel
   was launched at, are counted over this phase only.
   Then streaming (phase 3c) at the paper's size: ground set
   ``blobs(50 000, 100, centers=16)``, k = 10, ε = 0.1, backend ``cuda``.
   ``sieve_streaming(mode="device")`` over the whole shuffled stream;
   host mirror against device plan for sieve, pp and salsa on its first
   8 192 elements (identical members and evaluations, values within
   1e-6); the ``cuda`` backend against ``torch`` on that prefix (reported,
   not gated); ``StreamIngestionService`` fed the prefix, equal to the
   optimizer; ``MultiStreamIngestionService`` with 16 partitions of 2 048
   noisy vectors, each partition of its batched engine bit for bit a
   standalone engine fed the same sub-stream, and a certified merge.
   Launches of the two sieve kernels are counted over this phase only.
   Then, reported and not gated: whether the whole stream's members equal
   those of the sieve kernel's previous order of additions and, if not,
   the first element whose accept decision that order flips, with the two
   orders' gains (``previous_order_gains`` replays the old order in plain
   PyTorch).
   Then the contracts on the card (phase 3e): ``repro_torch.analysis.audit``
   in-process, ``--device cuda --quick`` (one case per contract and kind
   on the ``cuda`` backend, so the gain and sieve kernels launch; the
   runtime checks; the lint), then the census at the paper's size of
   ``engine.select_scan`` (dense, stochastic, lazy; fp32 and bf16),
   ``select_scan_batched`` on the four-tenant bucket of phase 3b and the
   device sieve's ``offer_scan`` on the stream's first 2 048 elements, each
   at k, k + 1 and k + 2 rounds (elements): host syncs, launches and
   collectives per round, new cache buffers per round, the peak device
   memory of the call against the kernel route's working-set bound
   (``registry.kernel_bound``), every sync-free case under
   ``torch.cuda.set_sync_debug_mode("error")``. Every kernel call of the
   phase is a launch and no plain version runs. Launches are counted over
   this phase only (``audit_launches``).
   Then the mesh plans (phase 3d) at the same size: ``MESH_P`` = 4 gloo
   ranks on ``cuda:0`` (``spawn_local``: a ``FileStore`` under ``build/``,
   a timeout, every rank killed on a failure), each running greedy,
   stochastic and lazy greedy under ``device_sharded`` and
   ``device_sharded_pool``, ``greedi``, a bucket of four paper-size
   tenants under both batched mesh plans with the tenants' unbatched calls,
   and sieve / pp / salsa under ``device_sharded`` on the first 8 192
   stream elements. Gates: every rank returns the same results; selections
   and evaluations equal the device plan of phases 3 and 3c exactly,
   trajectories and sieve values within 1e-5 of max(1, |value|); GreeDi at
   least (1 − 1/e)² of device greedy with exact accounting; each bucket
   request bit for bit its unbatched call; on every shard, at the mesh
   path's shapes with the global n, the outputs of ``gain_eval``,
   ``gain_update_eval`` and ``sieve_gain_eval`` within phase 2's fp32 band
   of their plain versions on the same slice and bit for bit the kernel
   launched alone on that slice, and their sum over the four shards within
   that band of one launch, and ``gain_eval_batched`` /
   ``gain_update_eval_batched`` at the bucket's (4, n/4, n, d) within the
   band of their plain versions (each comparison catching a planted 1 %
   error); on every rank, each kernel of the mesh path launched and no
   plain version run. Launches are counted per rank over the mesh path
   only. Rank 0 also reports the census of one ``device_sharded`` greedy
   run at k, k + 1, k + 2 (every rank runs it): collectives per round and
   their largest operand. Then one NCCL rank runs greedy under ``device_sharded`` (= the
   device plan). Each rank's wall per plan and launches per kernel are
   printed beside the card's line; four ranks share one card, so the walls
   are not a scaling figure.
   Then LM serving (phase 3f): ``qwen3-0.6b``, ``gemma3-1b``,
   ``granite-moe-3b-a800m``, ``whisper-small`` (encoder-decoder over 1 500
   seeded random frames), ``xlstm-1.3b`` (mLSTM and sLSTM) and
   ``hymba-1.5b`` (attention and Mamba heads) through ``init_model``,
   ``make_prefill_step`` and ``make_serve_step``, random weights from a
   seed. Gate 1: each cut to one period of its layer pattern
   (``LM_CUT``) at full width in fp32, 16 greedy tokens after a 40-token
   prompt on the card and on the CPU with the same weights: identical
   tokens, logits within ``LM_CARD_CPU_REL`` of their max (reported beside
   it: each side's gap to the same steps replayed in float64 on the CPU).
   Gate 2: the same cut models (MoE at capacity 8.0, which drops
   nothing), each decoded position's logits against the train-mode
   forward's within ``LM_DECODE_BOUND`` (also at ``LM_GATE2_PROMPTS``:
   gemma3 and hymba across their windows, xlstm over a padded second
   chunk). Gate 3: the full models in bf16 (``LM_SERVE``), the decode
   loop under ``torch.cuda.set_sync_debug_mode("error")`` with every cache
   leaf (recurrent state tuples and whisper's ``enc_out`` included)
   keeping its storage. Each gate also catches a planted fault: logits
   off by 1 %, a decode one position off (not for xlstm, which has no
   positions), a decode that skips the in-place write of an ``ssm`` leaf
   (xlstm, hymba), a host read in the loop and a reallocated cache leaf.
   Reported, not gated: the bf16 tokens, prefill and decode times,
   tokens/s, peak memory, a profile of four decode steps (device busy
   time, its share of the step, kernels per step) and, for xlstm, the
   share of prefill in the sLSTM's sequential loop. The LM path launches
   none of the port's kernels.
4. At the main path's shapes: each kernel against its plain version
   (the batched kernels at every (B, n, m, d) the serving phase launched
   them at, and at B = 64, n = m = 8 192, d = 100), then timed with CUDA
   events (the µs-scale sieve kernels by their device time from the
   profiler, the event times beside) beside its plain version, a yardstick the port never calls (the
   cuBLAS Gram product alone; for the sieve kernels ``torch.sum`` over
   the same table), and the least time the card could take (its bound).
   The batched gain kernels are timed at B = 64, n = m = 8 192, d = 100;
   the sieve kernels at the streaming phase's tables: (35, 50 000),
   (65, 50 000) and (16, 35, 50 000), each twice: warm (back-to-back
   launches, the table in the 50 MB L2 where it fits) and cold (128 MB
   read through the L2 before each launch, left out of the time); the
   HBM bound is a bound on the cold time. ``fused_eval``, ``gain_eval`` and
   ``gain_update_eval`` are also timed at bf16 and fp16 (``bf16_ms``,
   ``fp16_ms``).

5. Steady-state wall times of the main path's calls, and profiles (device
   busy time by kernel against wall time) of greedy in both plans and of a
   2 048-element window of the device sieve, with each top kernel's
   launches and time per launch.

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
    "gain_eval_batched": ("src/repro_torch/csrc/marginal_gain.cu",
                          "src/repro/kernels/marginal_gain.py:249"),
    "gain_update_eval_batched": ("src/repro_torch/csrc/marginal_gain.cu",
                                 "src/repro/kernels/marginal_gain.py:326"),
    "sieve_gain_eval": ("src/repro_torch/csrc/sieve_gain.cu",
                        "src/repro/kernels/marginal_gain.py:395"),
    "sieve_gain_eval_batched": ("src/repro_torch/csrc/sieve_gain.cu",
                                "src/repro/kernels/marginal_gain.py:451"),
}
#: Kernels of the main path (phase 3); the batched two run on the serving
#: path (phase 3b), the sieve two on the streaming path (phase 3c).
MAIN_KERNELS = ("fused_eval", "two_pass_eval", "gain_eval", "gain_update_eval")
SERVING_KERNELS = ("gain_eval_batched", "gain_update_eval_batched")
STREAM_KERNELS = ("sieve_gain_eval", "sieve_gain_eval_batched")
#: Each kernel's time before its split of n (the earlier times of PERF.md's
#: kernel table: this script on an H100 80GB HBM3 at 700 W; the Gram
#: kernels before their segments, the sieve kernels before their
#: clusters), printed beside this run's; ``gain_eval`` also has its m = 256
#: re-score (``top256``).
EARLIER_MS = {"fused_eval": 100.33, "two_pass_eval": 100.17,
              "gain_eval": 35.88, "gain_eval top256": 5.73,
              "gain_update_eval": 38.57, "gain_eval_batched": 61.01,
              "gain_update_eval_batched": 64.31,
              "sieve_gain_eval": 0.00767, "sieve_gain_eval_batched": 0.0449}
#: The whole stream's members (``sieve_streaming(mode="device")`` over
#: ``blobs(50 000, 100, centers=16)``, k = 10, ε = 0.1, seed 0) under the
#: sieve kernel's previous order of additions (H100): reported beside
#: this run's, not gated, since another order of fp32 additions may flip a
#: tie.
EARLIER_STREAM_MEMBERS = [10377, 49155, 34451, 15123, 7707, 34486, 12954,
                          26023, 24607, 29329]
#: The yardstick each kernel is timed beside (``library_ms``).
LIBRARY = {name: "cuBLAS Gram" for name in MAIN_KERNELS + SERVING_KERNELS}
LIBRARY.update({name: "torch.sum yardstick" for name in STREAM_KERNELS})

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
                                     f"misses the planted fault {label} "
                                     f"({caught:.3g} of the band)")
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


def phase_kernels_batched(check: Checker) -> int:
    """The batched gain kernels against their plain versions, and each
    request's outputs against its own unbatched launch (bit for bit).
    Returns the number of requests compared bit for bit."""
    import numpy as np
    import torch

    from repro_torch.core.functions import SIM_ALPHA, SIM_BETA
    from repro_torch.core.precision import FP32, resolve
    from repro_torch.kernels import marginal_gain as mg

    dev = torch.device("cuda")
    affine = (SIM_ALPHA, SIM_BETA)
    identical = 0
    for B, n, m, d in ((1, 4099, 517, 100), (3, 1031, 101, 45),
                       (8, 2053, 257, 129)):
        for payload, dist in (("wide", "sqeuclidean"), ("unit", "sqeuclidean"),
                              ("unit", "rbf")):
            rng = np.random.default_rng(B * 1000 + d)
            sigma, shift = (1.0, 2.0) if payload == "wide" \
                else ((2 * d) ** -0.5, 0.1)
            V = rng.normal(size=(B, n, d)) * sigma + shift
            C = np.stack([V[b, rng.choice(n, size=m, replace=False)]
                          for b in range(B)])
            typical = 2 * d * sigma ** 2
            if dist == "rbf":
                typical = 2 * (1 - np.exp(-typical))
            g = 2.0 if dist == "rbf" else 1.0
            scale = g * 2 * float((V * V).sum(-1).max())
            t = lambda a: torch.as_tensor(  # noqa: E731
                np.asarray(a), dtype=torch.float32, device=dev).contiguous()
            V, C, w = t(V), t(C), t(V[:, n // 2])
            wv = t([(b + 1) % 2 for b in range(B)])  # mixes 0 and 1 (B > 1)
            gamma = 1.0 if dist == "rbf" else None
            folds = [("min", None, t(rng.uniform(0.5, 1.5, (B, n)) * typical))]
            if payload == "unit":
                folds.append(("max", affine, t(rng.uniform(0.0, 0.8, (B, n)))))
            for pol in POLICIES:
                p = resolve(pol)
                for fold, aff, cache in folds:
                    kw = dict(n_total=n, policy=p, rbf_gamma=gamma, fold=fold,
                              affine=aff)
                    tag = (f"B={B} n={n} m={m} d={d} {payload} {dist} {pol} "
                           f"{fold}")
                    got = mg.gain_eval_batched(V, C, cache, **kw)
                    check("gain_eval_batched", got,
                          mg.gain_eval_batched_plain(V, C, cache, **kw), pol,
                          tag, scale=scale)
                    gu, nc = mg.gain_update_eval_batched(V, C, cache, w, wv,
                                                         **kw)
                    gp, ncp = mg.gain_update_eval_batched_plain(
                        V, C, cache, w, wv, **kw)
                    check("gain_update_eval_batched", gu, gp, pol,
                          tag + " gains", scale=scale)
                    # at the half policies the min-folded cache must also
                    # catch the plain version on the unrounded (fp32)
                    # payload, as two_pass_eval's W does: both hold one
                    # distance per row. On the H100 at fp16 an unrounded
                    # payload moved the gains (which average n rounding
                    # errors) by 0.87 of the band and the max-folded rbf
                    # cache (a similarity) by 0.97; there the bit-identity
                    # below with the unbatched launch shows the rounding.
                    unrounded = () if pol == "fp32" or fold != "min" else ((
                        "unrounded payload",
                        mg.gain_update_eval_batched_plain(
                            V, C, cache, w, wv, **dict(kw, policy=FP32))[1]),)
                    check("gain_update_eval_batched", nc, ncp, pol,
                          tag + " cache", scale=scale, faults=unrounded)
                    for b in range(B):
                        one = mg.gain_eval(V[b], C[b], cache[b], **kw)
                        g1, nc1 = mg.gain_update_eval(
                            V[b], C[b], cache[b], w[b], wv[b], **kw)
                        torch.cuda.synchronize()
                        if not (torch.equal(one, got[b]) and
                                torch.equal(g1, gu[b]) and
                                torch.equal(nc1, nc[b])):
                            raise AssertionError(
                                f"batched kernels [{tag}]: request {b} differs "
                                f"from its unbatched launch")
                        identical += 1
    return identical


def sieve_operands(lead, r, n, fold, seed):
    """A sieve table and distance rows (float32, on the card) on which the
    relu clips some terms and not others; column 0 scores > 0 in every
    row, so no case's gains are all zero."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 2.0, size=(*lead, n))
    if fold == "min":
        T = d[..., None, :] + rng.uniform(-0.3, 1.0, size=(*lead, r, n))
        T[..., 0] = d[..., None, 0] + 0.5
    else:
        T = rng.uniform(0.0, 0.8, size=(*lead, r, n))
        d[..., 0], T[..., 0] = 0.5, 0.0    # α + β·0.5 − 0 = 0.75
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device="cuda").contiguous()
    return t(T), t(d)


def phase_kernels_sieve(check: Checker) -> None:
    """The sieve kernels against their plain versions (fp32 operands, both
    templates) at n on the edges of their split of n, with and without the
    seed operand; then bit for bit: a row's gain at r = 1 and 35 against
    the r = 65 launch, wherever the row sits and whatever its alignment;
    the ``seed=`` launch against the launch on ``cat([seed, T])``; each
    partition of a batched launch against its unbatched launch on its own
    slice and on an aligned copy."""
    import torch

    from repro_torch.core.functions import SIM_ALPHA, SIM_BETA
    from repro_torch.kernels import marginal_gain as mg

    affine = {"min": None, "max": (SIM_ALPHA, SIM_BETA)}
    S, G = mg.sieve_span(1), mg.SIEVE_GROUP
    same = {"rows": 0, "seed": 0, "partitions": 0}

    def equal(key, what, got, ref):
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = int((got != ref).sum())
            raise AssertionError(f"sieve kernel [{what}]: {bad} of "
                                 f"{got.numel()} gains differ")
        same[key] += got.numel()

    # a block's span S at small n, the first n whose span grows a step, and
    # where a block loads its span in two groups of G columns
    for n in sorted({1, 3, S - 1, S, S + 1, 8 * S + 1, 257, 4097, 4099,
                     50_000, 8 * G, 8 * G + 1}):
        for fold, aff in affine.items():
            T, d = sieve_operands((), 65, n, fold, seed=n)
            kw = dict(n_total=n, fold=fold, affine=aff)
            full = mg.sieve_gain_eval(T, d, **kw)
            check("sieve_gain_eval", full,
                  mg.sieve_gain_eval_plain(T, d, **kw), "fp32",
                  f"r=65 n={n} {fold}")
            for r in (1, 35):
                got = mg.sieve_gain_eval(T[:r], d, **kw)
                check("sieve_gain_eval", got,
                      mg.sieve_gain_eval_plain(T[:r], d, **kw), "fp32",
                      f"r={r} n={n} {fold}")
                equal("rows", f"r={r} n={n} {fold}", got, full[:r])
            for j in (1, 3, 64):   # off 16 bytes where n % 4 != 0, and a copy
                for row in (T[j:j + 1], T[j:j + 1].clone()):
                    equal("rows", f"row {j} alone n={n} {fold}",
                          mg.sieve_gain_eval(row, d, **kw), full[j:j + 1])
            equal("rows", f"rows 30..64 n={n} {fold}",
                  mg.sieve_gain_eval(T[30:], d, **kw), full[30:])
            seed = T[7].clone()
            got = mg.sieve_gain_eval(T[:34], d, seed=seed, **kw)
            check("sieve_gain_eval", got,
                  mg.sieve_gain_eval_plain(T[:34], d, seed=seed, **kw), "fp32",
                  f"seed + 34 rows n={n} {fold}")
            equal("seed", f"seed + 34 rows n={n} {fold}", got,
                  mg.sieve_gain_eval(torch.cat([seed[None], T[:34]]), d, **kw))
    for P in (1, 3, 16):
        for n in (4099, 50_000):
            for fold, aff in affine.items():
                T, d = sieve_operands((P,), 35, n, fold, seed=P * n)
                kw = dict(n_total=n, fold=fold, affine=aff)
                tag = f"P={P} r=35 n={n} {fold}"
                got = mg.sieve_gain_eval_batched(T, d, **kw)
                check("sieve_gain_eval_batched", got,
                      mg.sieve_gain_eval_batched_plain(T, d, **kw), "fp32",
                      tag)
                for p in range(P):  # T[p] is off 16 bytes for odd p at 4 099
                    for Tp in (T[p], T[p].clone()):
                        equal("partitions", f"{tag} partition {p}",
                              mg.sieve_gain_eval(Tp, d[p], **kw), got[p])
                seed, caches = T[0, 0].clone(), T[:, 1:].contiguous()
                gots = mg.sieve_gain_eval_batched(caches, d, seed=seed, **kw)
                check("sieve_gain_eval_batched", gots,
                      mg.sieve_gain_eval_batched_plain(caches, d, seed=seed,
                                                       **kw), "fp32",
                      f"{tag} seed")
                equal("seed", f"{tag} seed", gots, mg.sieve_gain_eval_batched(
                    torch.cat([seed.expand(P, 1, n), caches], dim=1), d, **kw))
                for p in range(P):
                    equal("partitions", f"{tag} seed partition {p}",
                          mg.sieve_gain_eval(caches[p], d[p], seed=seed, **kw),
                          gots[p])
    log(f"    sieve kernels: n at the split's edges (span {S} up to n = "
        f"{8 * S}, load groups of {G} columns) in band, both templates, "
        f"with and without seed=; bit for "
        f"bit: {same['rows']} row gains against the r = 65 launch, "
        f"{same['seed']} seed= gains against the concatenated launch, "
        f"{same['partitions']} batched gains against unbatched launches")


def phase_invariance(N=50_000, L=5_000, K=10, DIM=100) -> dict:
    """The gain and exemplar-eval kernels split n into fixed segments, so a
    column's bits depend on n and its own inputs only: a ``gain_eval`` /
    ``gain_update_eval`` launch at m ∈ {1, 33, 256, 257} must give the same
    candidates' columns of the m = N launch bit for bit, and ``fused_eval``
    on 97 of the sets the same sets' values of the l = L launch, at fp32 and
    fp16_strict. Returns the number of columns compared per kernel."""
    import numpy as np
    import torch

    from repro_torch.core.evaluator import e0_distances
    from repro_torch.core.precision import resolve
    from repro_torch.data.synthetic import uniform_problem
    from repro_torch.kernels import exemplar_eval as ee
    from repro_torch.kernels import marginal_gain as mg
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    V = torch.as_tensor(uniform_problem(N, DIM, seed=0), device=dev)
    S = torch.as_tensor(uniform_problem(L * K, DIM, seed=1), device=dev
                        ).reshape(L, K, DIM)
    lengths = torch.as_tensor(rng.integers(1, K + 1, size=L), dtype=torch.int32,
                              device=dev)
    w = V[123].contiguous()
    wv = torch.ones((), device=dev)
    compared = {"gain_eval": 0, "gain_update_eval": 0, "fused_eval": 0}

    def same(name, what, got, ref):
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = int((got != ref).sum())
            raise AssertionError(f"{name} [{what}]: {bad} of {got.numel()} "
                                 f"columns differ from the full launch")
        compared[name] += got.numel()

    for pol in ("fp32", "fp16_strict"):
        p = resolve(pol)
        cache = e0_distances(V, None, "sqeuclidean", p).float().contiguous()
        kw = dict(n_total=N, policy=p)
        full = mg.gain_eval(V, V, cache, **kw)
        fullu, _ = mg.gain_update_eval(V, V, cache, w, wv, **kw)
        for m in (1, 33, 256, 257):
            idx = torch.as_tensor(np.sort(rng.choice(N, size=m, replace=False)),
                                  device=dev)
            C = V[idx].contiguous()
            same("gain_eval", f"{pol} m={m}", mg.gain_eval(V, C, cache, **kw),
                 full[idx])
            same("gain_update_eval", f"{pol} m={m}",
                 mg.gain_update_eval(V, C, cache, w, wv, **kw)[0], fullu[idx])
        d_e0 = e0_distances(V, None, "sqeuclidean", p).float().contiguous()
        kc = ops.kernel_config(K, DIM, p).k_chunk
        fkw = dict(n_total=N, policy=p, k_chunk=kc, layout="flat")
        full = ee.fused_eval(V, S.permute(1, 0, 2).contiguous(), lengths, d_e0,
                             **fkw)
        idx = torch.as_tensor(np.sort(rng.choice(L, size=97, replace=False)),
                              device=dev)
        same("fused_eval", f"{pol} 97 of {L} sets",
             ee.fused_eval(V, S[idx].permute(1, 0, 2).contiguous(),
                           lengths[idx].contiguous(), d_e0, **fkw), full[idx])
    log(f"    column invariance: every column bit for bit its full launch's "
        f"({json.dumps(compared)} columns; gains at m in (1, 33, 256, 257) "
        f"against m={N}, fused_eval on 97 sets against l={L}; fp32 and "
        f"fp16_strict)")
    return compared


def phase_segment_edges(check: Checker):
    """The gain and exemplar-eval kernels against their plain versions at
    n on either side of the segment edges (SEG − 1, SEG, SEG + 1,
    2·SEG + 1) and at the paper's n, for all four policies, through the
    checker (each comparison must also catch the planted fault)."""
    import numpy as np
    import torch

    from repro_torch.core.evaluator import e0_distances
    from repro_torch.core.precision import resolve
    from repro_torch.kernels import exemplar_eval as ee
    from repro_torch.kernels import marginal_gain as mg
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    SEG = ops.SEG
    l, k, d, m = 67, 7, 100, 257
    for n in (SEG - 1, SEG, SEG + 1, 2 * SEG + 1, 50_000):
        rng = np.random.default_rng(n)
        t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=dt, device=dev).contiguous()
        V = t(rng.normal(size=(n, d)) + 2.0)
        S = t(rng.normal(size=(l, k, d)) + 2.0)
        lengths = t(rng.integers(1, k + 1, size=l), torch.int32)
        C = t(rng.normal(size=(m, d)) + 2.0)
        w = V[n // 2].contiguous()
        cache = t(rng.uniform(0.5, 1.5, size=n) * 2 * d)
        scale = float((V * V).sum(-1).max() + (S * S).sum(-1).max())
        for pol in POLICIES:
            p = resolve(pol)
            tag = f"segment edge n={n} {pol}"
            kc = ops.kernel_config(k, d, p).k_chunk
            d_e0 = e0_distances(V, None, "sqeuclidean", p).float().contiguous()
            Sk = S.permute(1, 0, 2).contiguous()
            kw = dict(n_total=n, policy=p)
            check("fused_eval",
                  ee.fused_eval(V, Sk, lengths, d_e0, k_chunk=kc, **kw),
                  ee.fused_eval_plain(V, Sk, lengths, d_e0, **kw), pol, tag,
                  scale=scale)
            check("two_pass_eval",
                  ee.two_pass_eval(V, S, lengths, d_e0, k_chunk=kc, **kw) * n,
                  ee.two_pass_eval_plain(V, S, lengths, d_e0, **kw) * n, pol,
                  tag + " W·n", scale=scale)
            check("gain_eval", mg.gain_eval(V, C, cache, **kw),
                  mg.gain_eval_plain(V, C, cache, **kw), pol, tag, scale=scale)
            wv = torch.ones((), device=dev)
            g, nc = mg.gain_update_eval(V, C, cache, w, wv, **kw)
            gp, ncp = mg.gain_update_eval_plain(V, C, cache, w, wv, **kw)
            check("gain_update_eval", g, gp, pol, tag + " gains", scale=scale)
            check("gain_update_eval", nc, ncp, pol, tag + " cache",
                  scale=scale)
    log(f"    segment edges: n in ({SEG - 1}, {SEG}, {SEG + 1}, "
        f"{2 * SEG + 1}, 50000) x 4 policies within band of the plain "
        f"versions (fused_eval, two_pass_eval, gain_eval, gain_update_eval)")


def report_kernel_checks(check: Checker):
    log(f"    {check.cases} comparisons; per kernel and policy: max abs err, "
        f"largest err / band (case), smallest planted fault / band (case)")
    for name in KERNELS:
        for pol in POLICIES:
            key = (name, pol)
            if key not in check.max_err:  # the sieve kernels are fp32 only
                continue
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
        DEVICE_REFS[name] = res["device"]
        log(f"    wall: device {walls[f'{name} device']:.3f} s, host "
            f"{walls[f'{name} host']:.3f} s")

    Xs = X[:8192]
    fs = ExemplarClustering(Xs, EvalConfig(backend="cuda"))
    ms = greedy(fs, K, mode="multiset")
    mc = greedy(fs, K, mode="mincache")
    same_selection(f"greedy multiset vs mincache n={len(Xs)}", ms, mc, fs,
                   rtol=1e-4)
    return walls


def same_result(what, got, ref):
    """A served (batched) result against its unbatched call: identical
    indices, evaluations and trajectory."""
    if got != ref:
        raise AssertionError(f"{what}: served {got} != unbatched {ref}")


def phase_serving(T=64, N=8192, DIM=100, N_PAPER=50_000):
    """Multi-tenant serving on the card: T tenants of (N, DIM) and a bucket
    of four (N_PAPER, DIM) ones. Returns ``(walls, stacked V of the T
    tenants, stacked V of the four, launches of the served run, the
    (B, n, m, d) shapes each batched kernel was launched at)``."""
    import asyncio

    import numpy as np
    import torch

    from repro_torch.core import (EvalConfig, ExemplarClustering,
                                  SelectionService, run_selection,
                                  run_selection_batch, stochastic_greedy)
    from repro_torch.core.service import _SelectionRequest
    from repro_torch.data.synthetic import blobs
    from repro_torch.kernels import marginal_gain as mg
    from repro_torch.kernels import ops

    K = 10
    cfg = EvalConfig(backend="cuda")
    Xs = [blobs(N, DIM, centers=16, seed=100 + t)[0] for t in range(T)]
    dense_ks = [4 + t % 7 for t in range(T)]            # ragged, 4..10
    jobs = {
        "dense": [dict(X=Xs[t], k=dense_ks[t]) for t in range(T)],
        "lazy": [dict(X=Xs[t], k=K, kind="lazy") for t in range(16)],
        "stochastic": [dict(X=Xs[t], k=K, kind="stochastic", eps=0.05,
                            seed=t) for t in range(16)],
    }

    def buckets(reqs):
        return len({_SelectionRequest(
            X=r["X"], k=r["k"], fn="exemplar", params=(),
            kind=r.get("kind", "dense"), seed=r.get("seed", 0),
            eps=r.get("eps", 0.05), top_b=0, future=None).signature()
            for r in reqs})

    async def serve():
        out, walls = {}, {}
        async with SelectionService(cfg, max_batch=64, linger_s=0.01) as svc:
            for name, reqs in jobs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                # a failed future raises here, and fails the script
                out[name] = await asyncio.gather(*[
                    svc.submit(r["X"], r["k"], kind=r.get("kind", "dense"),
                               eps=r.get("eps", 0.05), seed=r.get("seed", 0))
                    for r in reqs])
                torch.cuda.synchronize()
                walls[f"serve {name}"] = time.perf_counter() - t0
            return out, walls, dict(svc.stats)

    Xp = [blobs(N_PAPER, DIM, centers=16, seed=t)[0] for t in range(4)]
    fp = [ExemplarClustering(X, cfg) for X in Xp]
    # the (B, n, m, d) each batched kernel is launched at, for phase 4
    shapes = {name: set() for name in SERVING_KERNELS}
    real = {name: getattr(mg, name) for name in SERVING_KERNELS}

    def recorded(name):
        def launch(V, C, *a, **kw):
            shapes[name].add((*V.shape[:2], C.shape[1], V.shape[2]))
            return real[name](V, C, *a, **kw)
        return launch

    ops.LAUNCHES.clear()
    try:
        for name in SERVING_KERNELS:
            setattr(mg, name, recorded(name))
        served, walls, stats = asyncio.run(serve())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bucket = run_selection_batch(fp, kind="dense", k=K)
        walls[f"run_selection_batch 4 x {N_PAPER}"] = time.perf_counter() - t0
    finally:
        for name in SERVING_KERNELS:
            setattr(mg, name, real[name])
    launches = dict(ops.LAUNCHES)
    want = sum(buckets(reqs) for reqs in jobs.values())
    log(f"    service stats {json.dumps(stats)}; signature buckets {want}")
    if stats["dispatches"] != want or stats["batched_requests"] != T + 32:
        raise AssertionError(f"expected one dispatch per signature bucket "
                             f"({want}), got {stats}")
    log(f"    launches (service + paper-size bucket): {json.dumps(launches)}")
    log("    launch shapes (B, n, m, d): " + json.dumps(
        {name: sorted(v) for name, v in shapes.items()}))

    # the unbatched calls each served result is held against (their
    # launches are not counted above)
    fs, refs = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for X, kb in zip(Xs, dense_ks):  # from numpy, as the service starts
        fs.append(ExemplarClustering(X, cfg))
        refs.append(run_selection(fs[-1], kind="dense", k=kb,
                                  cand_rounds=np.arange(N)[None, :]))
    torch.cuda.synchronize()
    walls["sequential dense"] = time.perf_counter() - t0
    for t, (got, ref) in enumerate(zip(served["dense"], refs)):
        same_result(f"served dense tenant {t} k={dense_ks[t]}", got, ref)
    for t, got in enumerate(served["lazy"]):
        same_result(f"served lazy tenant {t}", got,
                    run_selection(fs[t], kind="lazy", k=K))
    for t, got in enumerate(served["stochastic"]):
        same_result(f"served stochastic tenant {t}", got,
                    stochastic_greedy(fs[t], K, eps=0.05, seed=t,
                                      mode="device"))
    for t, (got, f) in enumerate(zip(bucket, fp)):
        same_result(f"paper-size bucket tenant {t}", got,
                    run_selection(f, kind="dense", k=K,
                                  cand_rounds=np.arange(N_PAPER)[None, :]))
    log(f"  served {T} dense (k 4..10), 16 lazy, 16 stochastic requests at "
        f"n={N} d={DIM} and a 4 x {N_PAPER} dense bucket: every result "
        f"identical "
        f"to its unbatched call (indices, evaluations, trajectory)")
    log(f"    service requests/s (dense, {T} tenants): "
        f"{T / walls['serve dense']:.2f}; {T} sequential unbatched "
        f"run_selection calls: {T / walls['sequential dense']:.2f} "
        f"requests/s")
    log(f"    lazy {16 / walls['serve lazy']:.2f} requests/s, stochastic "
        f"{16 / walls['serve stochastic']:.2f} requests/s")
    V = torch.stack([f.V for f in fs])
    return walls, V, torch.stack([f.V for f in fp]), launches, shapes


def same_stream_result(what, got, ref, atol=1e-6):
    """Two sieve runs on the same stream: identical members and
    evaluations, values within ``atol``."""
    if got.indices != ref.indices or got.evaluations != ref.evaluations \
            or not abs(got.value - ref.value) <= atol:
        raise AssertionError(
            f"{what}: {got.indices} / {got.evaluations} / {got.value!r} != "
            f"{ref.indices} / {ref.evaluations} / {ref.value!r}")


def phase_streaming(N=50_000, DIM=100, K=10, EPS=0.1, PREFIX=8192, P=16,
                    PER=2048):
    """Streaming at the paper's size (ground set ``blobs(N, DIM,
    centers=16)``, k = K, ε = EPS, backend ``cuda``). Returns ``(walls,
    the function, the whole stream's result)``; the caller reads
    ``ops.LAUNCHES`` over the whole phase."""
    import asyncio

    import numpy as np
    import torch

    from repro_torch.core import (EvalConfig, ExemplarClustering,
                                  MultiStreamIngestionService,
                                  StreamIngestionService, salsa,
                                  sieve_streaming, sieve_streaming_pp)
    from repro_torch.core.optimizers import _stream
    from repro_torch.core.streaming import make_sieve_engine
    from repro_torch.data.synthetic import blobs
    from repro_torch.kernels import ops

    X, _ = blobs(N, DIM, centers=16, seed=0)
    f = ExemplarClustering(X, EvalConfig(backend="cuda"))
    walls, sub = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        sub[name] = {k: v - before.get(k, 0) for k, v in ops.LAUNCHES.items()
                     if v != before.get(k, 0)}
        return out

    full = timed("sieve_streaming device, whole stream", lambda: sieve_streaming(
        f, K, eps=EPS, seed=0, mode="device", block_size=64))
    w = walls["sieve_streaming device, whole stream"]
    if not (1 <= len(full.indices) <= K and np.isfinite(full.value)
            and full.value > 0 and full.evaluations > 0):
        raise AssertionError(f"sieve_streaming over the whole stream: {full}")
    log(f"  sieve_streaming mode=device n={N} k={K} eps={EPS} over the whole "
        f"{N}-element stream (block_size=64): members {full.indices}, "
        f"value {full.value:.6f}, evaluations {full.evaluations}; wall "
        f"{w:.3f} s, {N / w:.1f} elements/s, launches "
        f"{json.dumps(sub['sieve_streaming device, whole stream'])}")

    prefix = _stream(f, None, 0)[:PREFIX]
    DEVICE_REFS["prefix"] = prefix
    algs = {"sieve": sieve_streaming, "pp": sieve_streaming_pp, "salsa": salsa}
    runs = {}
    for name, alg in algs.items():
        for mode in ("device", "host"):
            runs[name, mode] = timed(f"{name} {mode}, prefix", lambda: alg(
                f, K, eps=EPS, order=prefix, mode=mode, block_size=64))
        same_stream_result(f"{name} host vs device", runs[name, "host"],
                           runs[name, "device"])
        DEVICE_REFS[name] = runs[name, "device"]
        dv, hs = (walls[f"{name} {m}, prefix"] for m in ("device", "host"))
        log(f"  {name} on the first {PREFIX} elements: host mirror = device "
            f"plan (members {runs[name, 'device'].indices}, evaluations "
            f"{runs[name, 'device'].evaluations}, value diff "
            f"{abs(runs[name, 'host'].value - runs[name, 'device'].value):.3e}"
            f"); wall device {dv:.3f} s ({PREFIX / dv:.1f} elements/s), host "
            f"{hs:.3f} s ({PREFIX / hs:.1f} elements/s)")

    ft = ExemplarClustering(f.V, EvalConfig(backend="torch"))
    for name, alg in algs.items():
        tr = timed(f"{name} device torch backend, prefix", lambda: alg(
            ft, K, eps=EPS, order=prefix, mode="device", block_size=64))
        cu = runs[name, "device"]
        log(f"  {name} backend cuda vs torch on the prefix (reported, not "
            f"gated): members agree {cu.indices == tr.indices}, evaluations "
            f"{cu.evaluations} vs {tr.evaluations}, value gap "
            f"{cu.value - tr.value:.3e}; torch-backend wall "
            f"{walls[f'{name} device torch backend, prefix']:.3f} s")

    Xp = X[prefix]

    async def ingest():
        async with StreamIngestionService(f, k=K, eps=EPS, mode="device",
                                          block_size=64) as svc:
            await svc.offer_batch(Xp)
            await svc.drain()
            return await svc.snapshot()

    snap = timed("StreamIngestionService, prefix", lambda: asyncio.run(ingest()))
    ref = runs["sieve", "device"]
    got = [int(prefix[i]) for i in snap.indices]
    if got != ref.indices or snap.evaluations != ref.evaluations \
            or not abs(snap.value - ref.value) <= 1e-6 \
            or snap.n_ingested != PREFIX \
            or not np.array_equal(snap.exemplars, Xp[snap.indices]):
        raise AssertionError(f"StreamIngestionService {got} / "
                             f"{snap.evaluations} / {snap.value!r} != "
                             f"sieve_streaming {ref.indices} / "
                             f"{ref.evaluations} / {ref.value!r}")
    sw = walls["StreamIngestionService, prefix"]
    log(f"  StreamIngestionService fed the prefix: snapshot = "
        f"sieve_streaming(mode='device') on the same order (members, "
        f"evaluations, value diff {abs(snap.value - ref.value):.3e}); wall "
        f"{sw:.3f} s, {PREFIX / sw:.1f} elements/s")

    # P partitions of PER noisy ground-set vectors, round robin
    rng = np.random.default_rng(9)
    base = X[rng.choice(N, size=P * PER)]
    stream = (base + 0.03 * rng.normal(size=base.shape)).astype(np.float32)
    masks = [[] for _ in range(P)]
    svc = MultiStreamIngestionService(f, k=K, n_streams=P, eps=EPS,
                                      block_size=32, max_pending=P * PER)
    real_offer = svc._engine.offer

    def recording(idxs, Xs):    # the per-partition accept masks, in order
        out = real_offer(idxs, Xs)
        for p in range(P):
            masks[p].append(out[p])
        return out

    svc._engine.offer = recording

    async def multi():
        async with svc:
            for j, x in enumerate(stream):
                await svc.offer(x, stream=j % P)
            await svc.drain()
            return await svc.snapshot()

    msnap = timed("MultiStreamIngestionService", lambda: asyncio.run(multi()))
    mw = walls["MultiStreamIngestionService"]
    if not (msnap.certified and msnap.n_ingested == P * PER):
        raise AssertionError(f"multi-stream merge not certified: value "
                             f"{msnap.value!r} < bound {msnap.bound!r}")
    bests = svc._engine.best_all()
    ids = np.arange(P * PER)
    for p in range(P):
        eng = make_sieve_engine(f, K, EPS, mode="device", block_size=32)
        mask = eng.offer(ids[p::P], stream[p::P])
        if not (np.array_equal(mask, np.concatenate(masks[p]))
                and eng.best() == bests[p]
                and eng.evaluations() == svc._engine.evaluations(p)):
            raise AssertionError(
                f"stream partition {p}: batched {bests[p]} / "
                f"{svc._engine.evaluations(p)} != standalone {eng.best()} / "
                f"{eng.evaluations()}")
    log(f"  MultiStreamIngestionService P={P} x {PER} (block_size=32): every "
        f"partition bit for bit its standalone DeviceSieveEngine (accept "
        f"masks, members, values, evaluations); merge certified (value "
        f"{msnap.value:.6f} >= bound {msnap.bound:.6f}); wall {mw:.3f} s, "
        f"{P * PER / mw:.1f} elements/s")

    # what computing each partition's distance rows at the standalone shape
    # costs against one product over all P·B rows, and whether the one
    # product would give the same bits here
    Xb = torch.as_tensor(stream[:P * 32], device="cuda")
    one = f.point_distances_block(Xb)
    per = torch.cat([f.point_distances_block(Xb[p * 32:(p + 1) * 32])
                     for p in range(P)])
    one_ms = cuda_ms(lambda: f.point_distances_block(Xb), 20)
    per_ms = cuda_ms(lambda: [f.point_distances_block(Xb[p * 32:(p + 1) * 32])
                              for p in range(P)], 20)
    log(f"    distance rows of one block row: {P} products of (32, {N}) "
        f"{per_ms:.3f} ms against one ({P * 32}, {N}) product {one_ms:.3f} "
        f"ms; same bits: {torch.equal(one, per)}")
    log(f"    launches per sub-phase: {json.dumps(sub)}")
    return walls, f, full


#: Kernels of the contract phase (3e): the audit's grid and paper-size
#: cases launch the gain and sieve kernels (the multiset kernels have no
#: contract).
AUDIT_KERNELS = ("gain_eval", "gain_update_eval", "gain_eval_batched",
                 "gain_update_eval_batched", "sieve_gain_eval",
                 "sieve_gain_eval_batched")


def _contract_line(r) -> str:
    m = r.metrics
    mem = "" if m["peak_bytes"] is None else (
        f"; peak {m['peak_bytes']} B <= bound {m['memory_bound']} B")
    return (f"syncs/round {m['syncs_per_round']} (CELF iterations "
            f"{m['celf_iterations']}), launches/round "
            f"{json.dumps(m['launches_per_round'])}, collectives/round "
            f"{json.dumps(m['collectives_per_round'])} (largest "
            f"{m['max_collective_bytes']} B), new cache buffers/round "
            f"{m['cache_allocs_per_round']}{mem}; {m['seconds']:.2f} s")


def phase_contracts(N=50_000, DIM=100, K=10, PREFIX=2048) -> dict:
    """The contract audit on the card (phase 3e). Raises on any violation;
    returns the launches per kernel over the phase."""
    import collections

    import numpy as np
    import torch

    from repro_torch.analysis import audit, registry, report
    from repro_torch.data.synthetic import blobs
    from repro_torch.kernels import marginal_gain as mg
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    plain = collections.Counter()
    real = {name: getattr(mg, name) for name in PLAIN_VERSIONS}
    for name in PLAIN_VERSIONS:
        setattr(mg, name, _counting(plain, name, real[name]))
    calls0 = collections.Counter(ops.CALLS)
    launches0 = collections.Counter(ops.LAUNCHES)
    teardown = audit._ensure_group()
    try:
        t0 = time.perf_counter()
        results, rt, uncovered, _ = audit.run_audit("cuda", quick=True,
                                                    log=log)
        findings = audit.run_lint(log=log)
        bad = [r.label for r in results if not r.ok] + \
            [r["name"] for r in rt if not r["ok"]]
        if bad or uncovered or findings:
            raise AssertionError(f"contract audit on the card: failed "
                                 f"{bad}, uncovered {uncovered}, lint "
                                 f"{[str(f) for f in findings]}")
        log(f"  grid (--device cuda --quick): {len(results)} cases and "
            f"{len(rt)} runtime checks pass, lint clean, every contract "
            f"covered; {time.perf_counter() - t0:.1f} s")
        for name, m in sorted(report.contract_metrics(results).items()):
            log(f"    {name}: {json.dumps(m)}")
        X = blobs(N, DIM, centers=16, seed=0)[0]
        Xp = [X] + [blobs(N, DIM, centers=16, seed=t)[0] for t in (1, 2, 3)]
        order = np.random.default_rng(0).permutation(N)
        cases = [registry.paper_selection_case(kind, pol, X, dev, k=K)
                 for kind in ("dense", "stochastic", "lazy")
                 for pol in ("fp32", "bf16")]
        cases.append(registry.paper_selection_case("dense", "fp32", Xp, dev,
                                                   k=K, batch=4))
        cases.append(registry.paper_sieve_case(X, X[order[:PREFIX]], dev,
                                               k=K))
        for case in cases:
            torch.cuda.empty_cache()
            r = report.evaluate_case(case, card=True)
            if not r.ok:
                raise AssertionError(f"{r.label}: "
                                     + "; ".join(map(str, r.violations)))
            log(f"  {r.label} ({r.contract}, n={N} d={DIM} k={K}, sync "
                f"debug mode {'on' if case.expect.syncs_total == 0 else 'off: CELF'}"
                f"): {_contract_line(r)}")
    finally:
        teardown()
        for name in PLAIN_VERSIONS:
            setattr(mg, name, real[name])
    calls = collections.Counter(ops.CALLS) - calls0
    launches = collections.Counter(ops.LAUNCHES) - launches0
    missing = [k for k in AUDIT_KERNELS if not launches.get(k)]
    if calls != launches or plain or missing:
        raise AssertionError(f"contract phase: calls {dict(calls)} != "
                             f"launches {dict(launches)}, plain versions "
                             f"{dict(plain)}, or no launch of {missing}")
    log(f"  every kernel call a launch ({json.dumps(dict(launches))}), no "
        f"plain version run; card: {card_line()}")
    return dict(launches)


#: The mesh phase's (3d) references, from the single-device device plan on
#: the same card: greedy / stochastic_greedy / lazy_greedy at the paper's
#: size (phase 3) and the sieve family on the stream prefix (phase 3c).
DEVICE_REFS: dict = {}
#: Ranks of the mesh phase: gloo ranks sharing the one card.
MESH_P = 4
#: Kernels of the mesh path: the gain kernels and the sieve kernel on each
#: rank's rows (``sieve_gain_eval_batched`` has no mesh form).
MESH_KERNELS = ("gain_eval", "gain_update_eval", "gain_eval_batched",
                "gain_update_eval_batched", "sieve_gain_eval")
#: The plain versions and the torch scoring path a CUDA rank must not run.
PLAIN_VERSIONS = ("gain_eval_plain", "gain_update_eval_plain",
                  "gain_eval_batched_plain", "gain_update_eval_batched_plain",
                  "sieve_gain_eval_plain", "sieve_gain_eval_batched_plain")


def _counting(counter, name, real):
    def call(*a, **kw):
        counter[name] += 1
        return real(*a, **kw)
    return call


def mesh_kernel_checks(f, fp, sh, N):
    """On every rank, at the mesh path's shapes (the sums are collectives;
    rank 0 reports): the outputs of ``gain_eval``, ``gain_update_eval``
    (m = n, a dense round) and ``sieve_gain_eval`` (the seed and 34 sieve
    rows) on this rank's shard, with the global n, against their plain
    versions on the same slice (phase 2's fp32 band, a planted 1 % error
    caught), and bit for bit against the same kernel launched alone on that
    slice of the single-device operands; their sum in shard order against
    one launch on the whole operands (the same band). Then the batched
    kernels at the bucket's shapes, (4, n/p, n, d) with the global n,
    against their plain versions."""
    import torch

    from repro_torch.core import distributed
    from repro_torch.core.precision import FP32
    from repro_torch.kernels import marginal_gain as mg
    from repro_torch.kernels import ops

    entry = distributed._placed_sharded(f, sh)
    V_loc, seed_loc = entry["V_sh"], entry["seed_sh"]
    n_loc = V_loc.shape[0]
    lo, hi = sh.index * n_loc, min((sh.index + 1) * n_loc, N)
    if hi - lo != n_loc:
        raise AssertionError("the kernel checks need n divisible by p")
    seed = f.cache_seed
    C = f.V
    w = f.V[N // 4 + 1]
    ok = torch.ones((), device=f.V.device)
    # a (34, N) table of sieve caches: the seed folded with 1..34 elements
    D = f.point_distances_block(f.V[N // 2:N // 2 + 34]).to(torch.float32)
    T = torch.minimum(seed[None, :], torch.cummin(D, dim=0).values)
    dvec = f.point_distances_block(f.V[3 * N // 4:3 * N // 4 + 1])[0].to(
        torch.float32)
    T_loc, dvec_loc = T[:, lo:hi].contiguous(), dvec[lo:hi].contiguous()

    def norms(*xs):
        return sum(float((x * x).sum(-1).max()) for x in xs)

    scale = {"gain_eval": norms(V_loc, C), "gain_update_eval": norms(V_loc, C),
             "sieve_gain_eval": 1.0}
    gkw = dict(n_total=N, policy=FP32)
    shard = {
        "gain_eval": lambda: ops.marginal_gain(V_loc, C, seed_loc,
                                               n_total=N),
        "gain_update_eval": lambda: ops.fused_gain_update(
            V_loc, C, seed_loc, w, n_total=N, w_valid=ok),
        "sieve_gain_eval": lambda: ops.sieve_gains(
            T_loc, dvec_loc, seed=seed_loc, n_total=N),
    }
    plain = {
        "gain_eval": lambda: mg.gain_eval_plain(V_loc, C, seed_loc, **gkw),
        "gain_update_eval": lambda: mg.gain_update_eval_plain(
            V_loc, C, seed_loc, w, ok, **gkw),
        "sieve_gain_eval": lambda: mg.sieve_gain_eval_plain(
            T_loc, dvec_loc, seed=seed_loc, n_total=N),
    }
    alone = {
        "gain_eval": lambda: ops.marginal_gain(f.V[lo:hi], C, seed[lo:hi],
                                               n_total=N),
        "gain_update_eval": lambda: ops.fused_gain_update(
            f.V[lo:hi], C, seed[lo:hi], w, n_total=N, w_valid=ok),
        "sieve_gain_eval": lambda: ops.sieve_gains(
            T[:, lo:hi], dvec[lo:hi], seed=seed[lo:hi], n_total=N),
    }
    whole = {
        "gain_eval": lambda: ops.marginal_gain(f.V, C, seed),
        "gain_update_eval": lambda: ops.fused_gain_update(
            f.V, C, seed, w, w_valid=ok),
        "sieve_gain_eval": lambda: ops.sieve_gains(T, dvec, seed=seed),
    }

    def outputs(x):
        return x if isinstance(x, tuple) else (x,)

    vs_plain, vs_whole = Checker(), Checker()
    tag = f"shard {sh.index} of {sh.p}, n_loc={n_loc}, n_total={N}"
    out = {}
    for name in shard:
        got, ref = outputs(shard[name]()), outputs(plain[name]())
        for what, a, b in zip(("gains", "cache"), got, ref):
            vs_plain(name, a, b, "fp32", f"{tag} {what} vs plain",
                     scale=scale[name])
        same = all(torch.equal(a, b)
                   for a, b in zip(got, outputs(alone[name]())))
        if not same:
            raise AssertionError(f"{name}: shard {sh.index}'s output differs "
                                 f"from the kernel launched alone on its "
                                 f"slice")
        total = distributed.ordered_sum(sh, got[0])
        # the rows' distances are the same bits in both launches: only the
        # order of the fp32 sum over n differs, so the band scales with
        # the output alone
        vs_whole(name, total, outputs(whole[name]())[0], "fp32",
                 f"sum of {sh.p} shards vs one launch, n={N}")
        key = (name, "fp32")
        out[name] = {"shard_bit_for_bit": same,
                     "plain_max_abs_err": vs_plain.max_err[key],
                     "plain_fault_over_band": vs_plain.fault_over_band[key][0],
                     "sum_max_abs_err": vs_whole.max_err[key],
                     "planted_fault_over_band":
                         vs_whole.fault_over_band[key][0]}
    # the bucket: four tenants' shards against their whole candidate pools
    Vb = torch.stack([g.V[lo:hi] for g in fp]).contiguous()
    Cb = torch.stack([g.V for g in fp]).contiguous()
    cb = torch.stack([g.cache_seed[lo:hi].float() for g in fp]).contiguous()
    wb = torch.stack([g.V[N // 4 + 1] for g in fp]).contiguous()
    wv = torch.tensor([1.0, 0.0, 1.0, 1.0], device=f.V.device)
    bscale = norms(Vb, Cb)
    btag = f"B={len(fp)} {tag}"
    vs_plain("gain_eval_batched", ops.marginal_gain(Vb, Cb, cb, n_total=N),
             mg.gain_eval_batched_plain(Vb, Cb, cb, **gkw), "fp32",
             f"{btag} vs plain", scale=bscale)
    got = ops.fused_gain_update(Vb, Cb, cb, wb, n_total=N, w_valid=wv)
    ref = mg.gain_update_eval_batched_plain(Vb, Cb, cb, wb, wv, **gkw)
    for what, a, b in zip(("gains", "cache"), got, ref):
        vs_plain("gain_update_eval_batched", a, b, "fp32",
                 f"{btag} {what} vs plain", scale=bscale)
    for name in ("gain_eval_batched", "gain_update_eval_batched"):
        key = (name, "fp32")
        out[name] = {"plain_max_abs_err": vs_plain.max_err[key],
                     "plain_fault_over_band":
                         vs_plain.fault_over_band[key][0]}
    return out


def mesh_rank(rank, world, prefix, N):
    """One gloo rank of the mesh phase, on the one card."""
    import collections

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import (EvalConfig, ExemplarClustering, greedy,
                                  lazy_greedy, run_selection,
                                  run_selection_batch, salsa, sieve_streaming,
                                  sieve_streaming_pp, stochastic_greedy)
    from repro_torch.core import distributed
    from repro_torch.data.synthetic import blobs
    from repro_torch.kernels import marginal_gain as mg
    from repro_torch.kernels import ops

    torch.cuda.set_device(0)
    DIM, K = 100, 10
    plain = collections.Counter()
    for name in PLAIN_VERSIONS:
        setattr(mg, name, _counting(plain, name, getattr(mg, name)))
    distributed._score_blocked = _counting(plain, "_score_blocked",
                                           distributed._score_blocked)
    cfg = EvalConfig(backend="cuda")
    f = ExemplarClustering(blobs(N, DIM, centers=16, seed=0)[0], cfg)
    fp = [ExemplarClustering(blobs(N, DIM, centers=16, seed=t)[0], cfg)
          for t in range(4)]
    greedy(f, 2, mode="device_sharded")        # warm-up: mesh, libraries
    results, walls = {}, {}

    def timed(key, fn):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        results[key] = fn()
        torch.cuda.synchronize()
        walls[" ".join(key) if isinstance(key, tuple) else key] = \
            time.perf_counter() - t0

    ops.LAUNCHES.clear()
    plain.clear()
    for plan in ("device_sharded", "device_sharded_pool"):
        timed(("greedy", plan), lambda: greedy(f, K, mode=plan))
        timed(("stochastic_greedy", plan),
              lambda: stochastic_greedy(f, K, seed=0, mode=plan))
        timed(("lazy_greedy", plan), lambda: lazy_greedy(f, K, mode=plan))
    timed("greedi", lambda: greedy(f, K, mode="greedi"))
    for plan in ("device_sharded", "device_sharded_pool"):
        timed(("bucket", plan), lambda: run_selection_batch(
            fp, kind="dense", k=K, plan=plan))
        timed(("unbatched", plan), lambda: [run_selection(
            g, kind="dense", k=K, cand_rounds=np.arange(N)[None, :],
            plan=plan) for g in fp])
    for name, alg in (("sieve", sieve_streaming), ("pp", sieve_streaming_pp),
                      ("salsa", salsa)):
        timed(name, lambda: alg(f, K, eps=0.1, order=prefix,
                                mode="device_sharded", block_size=64))
    torch.cuda.synchronize()
    launches, plain_calls = dict(ops.LAUNCHES), dict(plain)
    sh = distributed.resolve_mesh(None, ("data",))
    kernels = mesh_kernel_checks(f, fp, sh, N)
    # the census of one device_sharded greedy at k, k + 1, k + 2 (every
    # rank runs it: its collectives pair up across the ranks)
    from repro_torch.analysis import registry, report

    census = report.evaluate_case(registry.paper_sharded_case(
        f.V, f.device, k=K), card=True)
    return {"results": results, "walls": walls, "launches": launches,
            "plain": plain_calls, "kernels": kernels, "shard": sh.index,
            "tiles_per_memory": sh.tiles_per_memory(f.device),
            "census": {"violations": [str(v) for v in census.violations],
                       "metrics": census.metrics}}


def nccl_rank(rank, world, N):
    """The one-rank NCCL run: greedy under ``device_sharded``."""
    import torch

    from repro_torch.core import EvalConfig, ExemplarClustering, greedy
    from repro_torch.data.synthetic import blobs
    from repro_torch.kernels import ops

    torch.cuda.set_device(0)
    f = ExemplarClustering(blobs(N, 100, centers=16, seed=0)[0],
                           EvalConfig(backend="cuda"))
    greedy(f, 2, mode="device_sharded")
    ops.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = greedy(f, 10, mode="device_sharded")
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(ops.LAUNCHES)


def same_as_device(what, got, ref, rtol=1e-5):
    """A mesh plan's result against the device plan's: identical indices
    and evaluations, trajectories within ``rtol`` of max(1, |ref|)."""
    import numpy as np

    a, b = np.asarray(got.trajectory), np.asarray(ref.trajectory)
    err = float(np.max(np.abs(a - b))) if len(a) == len(b) else float("inf")
    if got.indices != ref.indices or got.evaluations != ref.evaluations \
            or not err <= rtol * max(1.0, float(np.max(np.abs(b)))):
        raise AssertionError(f"{what}: {got.indices} / {got.evaluations} != "
                             f"device plan {ref.indices} / {ref.evaluations} "
                             f"(trajectory diff {err:.3e})")
    return err


def phase_mesh(refs: dict, K=10, N=50_000):
    """The mesh plans on the card: MESH_P gloo ranks on cuda:0, then one
    NCCL rank. Returns the per-rank launches and walls."""
    import math

    from repro_torch.core.distributed import spawn_local

    store = ROOT / "build" / "mesh"
    store.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ranks = spawn_local(mesh_rank, MESH_P, store_dir=store, backend="gloo",
                        args=(refs["prefix"], N), timeout=900)
    log(f"  {MESH_P} gloo ranks on cuda:0 (tiles per memory "
        f"{ranks[0]['tiles_per_memory']}): {time.perf_counter() - t0:.1f} s "
        f"with their start")
    r0 = ranks[0]["results"]
    for q, r in enumerate(ranks[1:], 1):
        if r["results"] != r0:
            diff = [k for k in r0 if r["results"].get(k) != r0[k]]
            raise AssertionError(f"rank {q}'s results differ from rank 0's "
                                 f"in {diff}")
    log(f"  every rank returned the same result ({len(r0)} runs)")
    for name in ("greedy", "stochastic_greedy", "lazy_greedy"):
        for plan in ("device_sharded", "device_sharded_pool"):
            err = same_as_device(f"{name} {plan} p={MESH_P}", r0[name, plan],
                                 refs[name])
            log(f"  {name} {plan} p={MESH_P} n={N} k={K}: indices and "
                f"evaluations {r0[name, plan].evaluations} = device plan; "
                f"trajectory max diff {err:.3e}")
    gd, base = r0["greedi"], refs["greedy"]
    n_loc = N // MESH_P
    expect = MESH_P * sum(n_loc - t for t in range(K)) \
        + sum(MESH_P * K - t for t in range(K)) + MESH_P * K
    floor = (1.0 - 1.0 / math.e) ** 2 * base.value
    if not (len(set(gd.indices)) == K and gd.value >= floor
            and gd.evaluations == expect):
        raise AssertionError(f"greedi: {gd} (floor {floor:.6f}, evaluations "
                             f"expected {expect})")
    log(f"  greedi p={MESH_P}: value {gd.value:.6f} >= (1-1/e)^2 x device "
        f"greedy {base.value:.6f} = {floor:.6f}; evaluations {expect} exact")
    for plan in ("device_sharded", "device_sharded_pool"):
        for t, (got, ref) in enumerate(zip(r0["bucket", plan],
                                           r0["unbatched", plan])):
            same_result(f"{plan} bucket tenant {t}", got, ref)
        log(f"  {plan}: a bucket of four {N}-row tenants = their unbatched "
            f"{plan} calls, bit for bit")
    for name in ("sieve", "pp", "salsa"):
        # an element's gains and values are sums over n in another order
        # (shards, then shard order), so values agree to the selections'
        # 1e-5 of max(1, |value|)
        same_stream_result(f"{name} device_sharded p={MESH_P}", r0[name],
                           refs[name],
                           atol=1e-5 * max(1.0, abs(refs[name].value)))
        log(f"  {name} device_sharded p={MESH_P} on the first "
            f"{len(refs['prefix'])} elements = device plan (members "
            f"{r0[name].indices}, evaluations {r0[name].evaluations}, value "
            f"diff {abs(r0[name].value - refs[name].value):.3e})")
    for q, r in enumerate(ranks):
        if r["census"]["violations"]:
            raise AssertionError(f"rank {q}: device_sharded greedy census: "
                                 f"{r['census']['violations']}")
    m = ranks[0]["census"]["metrics"]
    log(f"  census of device_sharded greedy on rank 0 (every rank runs it, "
        f"p={MESH_P}, n={N} k={K}): syncs/round {m['syncs_per_round']}, "
        f"launches/round {json.dumps(m['launches_per_round'])}, "
        f"collectives/round {json.dumps(m['collectives_per_round'])}, "
        f"largest operand {m['max_collective_bytes']} B (bound "
        f"{(N + 1) * 4} B: the (n + 1) gains and stat sum), new cache "
        f"buffers/round {m['cache_allocs_per_round']}; "
        f"{m['seconds']:.2f} s")
    kern = ranks[0]["kernels"]
    log(f"  kernels on shard 0 (against their plain versions on the slice "
        f"with the global n; bit for bit their launch alone on the slice; "
        f"the sum of the {MESH_P} shards against one launch): "
        f"{json.dumps(kern)}")
    for q, r in enumerate(ranks):
        missing = [k for k in MESH_KERNELS if r["launches"].get(k, 0) == 0]
        if missing or r["plain"]:
            raise AssertionError(f"rank {q}: no launch of {missing} or plain "
                                 f"versions run {r['plain']}")
        log(f"  rank {q} (shard {r['shard']}): launches "
            f"{json.dumps(r['launches'])}; plain versions 0; walls (s) "
            f"{json.dumps({k: round(v, 4) for k, v in r['walls'].items()})}")
    t0 = time.perf_counter()
    (res, wall, nccl_launches), = spawn_local(
        nccl_rank, 1, store_dir=store, backend="nccl", args=(N,),
        timeout=300)
    err = same_as_device("greedy device_sharded over NCCL", res,
                         refs["greedy"])
    if not nccl_launches.get("gain_update_eval"):
        raise AssertionError(f"NCCL rank launched {nccl_launches}")
    log(f"  1 NCCL rank: greedy device_sharded = device plan (trajectory "
        f"max diff {err:.3e}); wall {wall:.4f} s; launches "
        f"{json.dumps(nccl_launches)}; {time.perf_counter() - t0:.1f} s with "
        f"its start")
    log(f"  card: {card_line()} (walls of {MESH_P} ranks sharing one card: "
        f"not a scaling figure)")
    return {q: r["launches"] for q, r in enumerate(ranks)}


#: The LM serving phase (3f): each configuration at its published widths
#: and depth in bf16, random weights from seed 0: (batch, prompt tokens,
#: greedy tokens). gemma3's 600-token prompt is past its 512 window and not
#: a multiple of it, so prefill rolls the ring, and decode wraps it;
#: hymba's 1 100 does the same to its 1 024 window. whisper's 8 requests
#: are 30-second audio windows (1 500 encoder frames each, seeded random)
#: with a short decoder prompt, inside its 448-token decoder context.
LM_SERVE = {"qwen3-0.6b": (8, 512, 64), "gemma3-1b": (4, 600, 64),
            "granite-moe-3b-a800m": (8, 512, 64),
            "whisper-small": (8, 32, 96), "xlstm-1.3b": (8, 512, 64),
            "hymba-1.5b": (4, 1100, 64)}
#: Gates 1–2's models: one period of the layer pattern (gemma3's five
#: local layers and its global one; xlstm's seven mLSTM and one sLSTM;
#: hymba's full-attention layer and a sliding one; whisper's two encoder
#: and two decoder layers).
LM_CUT = {"qwen3-0.6b": dict(num_layers=2), "gemma3-1b": dict(num_layers=6),
          "granite-moe-3b-a800m": dict(num_layers=2),
          "whisper-small": dict(num_layers=2, encoder_layers=2),
          "xlstm-1.3b": dict(num_layers=8),
          "hymba-1.5b": dict(num_layers=2, full_attn_layers=(0,))}
#: Gate 2's prompts beyond the first (40 tokens, 16 decoded): gemma3's
#: window − 7 (decode wraps the ring) and window + 88 (prefill rolls it);
#: xlstm's 100, two mLSTM chunks of which 28 steps are padding; hymba's
#: 1 030, past its window.
LM_GATE2_PROMPTS = {"gemma3-1b": (505, 600), "xlstm-1.3b": (100,),
                    "hymba-1.5b": (1030,)}
#: Gate 1, card against the CPU port (fp32, the same weights): logits
#: within 1e-4 of their max |value|. Both add in fp32 in their own orders
#: (cuBLAS against the CPU's BLAS, TF32 off) over two to eight layers of
#: widths up to 6 912; on the H100 runs the gap was 0.007–0.18 of the band,
#: each side as far from a float64 replay as from the other.
LM_CARD_CPU_REL = 1e-4
#: Gate 2, decode against the train-mode forward on the card (fp32):
#: the reference's own bound (``tests/test_models.py``: 5e-4 on logits
#: of at most 3.6), scaled by the logits' max |value| where it passes 1.
LM_DECODE_BOUND = 5e-4


class _LogitsTap:
    """Keeps the last position's logits of every ``forward`` the port's
    steps call (they call ``model.forward`` through the module), on the
    device, for the gates; the steps themselves return tokens only."""

    def __init__(self):
        from repro_torch.models import model as M

        self.M, self.real, self.rows = M, M.forward, []

    def __enter__(self):
        def tapped(*a, **kw):
            logits, caches = self.real(*a, **kw)
            self.rows.append(logits[:, -1].float().clone())
            return logits, caches

        self.M.forward = tapped
        return self

    def __exit__(self, *exc):
        self.M.forward = self.real


class _SkippedStateWrite:
    """A planted fault for gate 2: decode leaves the ``ssm`` state of each
    recurrent group's first layer as prefill wrote it (the blocks write
    their states through ``ssm._store``)."""

    def __enter__(self):
        from repro_torch.models import ssm as S

        self.S, self.real = S, S._store

        def store(cache, name, new):
            dst = cache[name]
            first = dst[0] if isinstance(dst, tuple) else dst
            if not (name == "ssm" and first.storage_offset() == 0):
                self.real(cache, name, new)

        S._store = store
        return self

    def __exit__(self, *exc):
        self.S._store = self.real


def lm_frontend(cfg, B, gen, device, dtype) -> dict:
    """whisper's encoder frames (B, frontend_len, d_model), seeded random;
    nothing for a decoder-only family."""
    import torch

    if cfg.family != "encdec":
        return {}
    return {"frontend": torch.randn((B, cfg.frontend_len, cfg.d_model),
                                    generator=gen, device=device,
                                    dtype=torch.float32).to(dtype)}


def lm_greedy(model, prompts, n, extra=None):
    """``n`` greedy tokens through the port's steps (prefill, then
    ``n − 1`` serve steps); ``extra``: the prefill batch's ``frontend``.
    Returns (tokens (B, n) on the host, logits (B, n, V) fp32 on the
    model's device, caches)."""
    import torch

    from repro_torch.train.step import make_prefill_step, make_serve_step

    cfg = model.cfg
    S = prompts.shape[1]
    prefill = make_prefill_step(cfg, cache_len=S + n)
    decode = make_serve_step(cfg)
    with _LogitsTap() as tap:
        tok, caches = prefill(model, {"tokens": prompts, **(extra or {})})
        out = [tok]
        for i in range(n - 1):
            tok, caches = decode(model, {"tokens": tok, "caches": caches,
                                         "pos": S + i})
            out.append(tok)
    return torch.cat(out, 1).cpu(), torch.stack(tap.rows, 1), caches


def lm_teacher_forced(model, tokens, pre, pos_shift=0, extra=None,
                      skip_write=False):
    """Prefill ``tokens[:, :pre]`` (with ``extra``, the frontend), then
    decode the rest of ``tokens`` one at a time through the serve step;
    each decoded position's logits (B, S − pre, V) fp32. ``pos_shift`` and
    ``skip_write`` plant gate 2's faults."""
    import contextlib

    import torch

    from repro_torch.train.step import make_prefill_step, make_serve_step

    cfg = model.cfg
    S = tokens.shape[1]
    prefill = make_prefill_step(cfg, cache_len=S + pos_shift)
    decode = make_serve_step(cfg)
    _, caches = prefill(model, {"tokens": tokens[:, :pre], **(extra or {})})
    fault = _SkippedStateWrite() if skip_write else contextlib.nullcontext()
    with _LogitsTap() as tap, fault:
        for pos in range(pre, S):
            _, caches = decode(model, {"tokens": tokens[:, pos:pos + 1],
                                       "caches": caches,
                                       "pos": pos + pos_shift})
    return torch.stack(tap.rows, 1)


def _cache_leaves(caches) -> list:
    from repro_torch.models.model import tree_leaves

    return [t for _, t in tree_leaves(caches)]


def _storages(leaves) -> list:
    return [t.untyped_storage().data_ptr() for t in leaves]


def lm_gate_card_vs_cpu(cut, B=2, S=40, N=16) -> str:
    """Gate 1: the cut model in fp32 on the card and, with the same
    weights, on the CPU; identical greedy tokens, logits within
    ``LM_CARD_CPU_REL`` of their max. Also catches a planted 1 % error."""
    import copy

    import torch

    from repro_torch.configs import replace
    from repro_torch.models.model import init_model

    model = init_model(cut, 0, device="cuda")
    cpu = copy.deepcopy(model).to("cpu")
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cut.vocab_size, (B, S), generator=gen,
                            dtype=torch.int32)
    extra = lm_frontend(cut, B, gen, "cpu", torch.float32)
    t0 = time.perf_counter()
    tok_c, lg_c, _ = lm_greedy(cpu, prompts, N, extra)
    t_cpu = time.perf_counter() - t0
    tok_g, lg_g, _ = lm_greedy(model, prompts.cuda(), N,
                               {k: v.cuda() for k, v in extra.items()})
    lg_g = lg_g.cpu()
    if not torch.equal(tok_g, tok_c):
        first = int((tok_g != tok_c).any(0).int().argmax())
        raise AssertionError(f"{cut.name}: card tokens differ from the CPU "
                             f"port's from step {first}")
    band = LM_CARD_CPU_REL * float(lg_c.abs().max())
    err = float((lg_g - lg_c).abs().max())
    caught = float((lg_g * 0.99 - lg_c).abs().max())
    if not err <= band:
        raise AssertionError(f"{cut.name}: card logits {err:.3e} from the "
                             f"CPU port's > {band:.3e}")
    if not caught > band:
        raise AssertionError(f"{cut.name}: the card-vs-CPU band {band:.3e} "
                             f"misses a planted 1 % error ({caught:.3e})")
    # which side moved (reported): both against the same steps on the CPU
    # in float64 (its norms, RoPE angles, scores and router still round to
    # fp32, so it is a finer reference, not an exact one; a
    # forward over the whole sequence would not do for MoE, whose
    # capacity follows each call's token count)
    cpu.double()
    cpu.cfg = replace(cut, dtype="float64")
    tok_d, lg_d, _ = lm_greedy(cpu, prompts, N, extra)
    if torch.equal(tok_d, tok_c):
        e_g, e_c = (float((lg.double() - lg_d).abs().max()) / band
                    for lg in (lg_g, lg_c))
        finer = f"card {e_g:.3f}, CPU {e_c:.3f} of it"
    else:
        finer = "its tokens differ"
    return (f"{N} tokens x {B} identical, logits err {err:.3e} = "
            f"{err / band:.3f} of the band (planted 1 %: {caught / band:.1f}x;"
            f" against float64 on the CPU: {finer}; CPU {t_cpu:.1f} s)")


def lm_gate_decode_vs_forward(cut, B=2, S=40, N=16) -> str:
    """Gate 2: each decoded position's logits on the card against the
    train-mode forward's, within ``LM_DECODE_BOUND`` (scaled), at 40
    prompt tokens and at ``LM_GATE2_PROMPTS``. Each planted fault must
    fail it: a decode one position off (where positions matter: not for
    xlstm) and, for the recurrent families, a decode that skips the
    in-place write of an ``ssm`` leaf."""
    import torch

    from repro_torch.models.model import forward, init_model

    model = init_model(cut, 0, device="cuda")
    runs = [(S, N)] + [(p, N) for p in LM_GATE2_PROMPTS.get(cut.name, ())]
    faults = []
    if cut.family != "ssm":
        faults.append(("one off", dict(pos_shift=1)))
    if cut.family in ("ssm", "hybrid"):
        faults.append(("ssm write skipped", dict(skip_write=True)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    extra = lm_frontend(cut, B, gen, "cuda", torch.float32)
    parts = []
    for pre, n in runs:
        tokens = torch.randint(0, cut.vocab_size, (B, pre + n), generator=gen,
                               device="cuda", dtype=torch.int32)
        with torch.no_grad():
            full, _ = forward(model, {"tokens": tokens, **extra})
        want = full[:, pre:].float()
        bound = LM_DECODE_BOUND * max(1.0, float(want.abs().max()))
        got = lm_teacher_forced(model, tokens, pre, extra=extra)
        err = float((got - want).abs().max())
        if not err <= bound:
            raise AssertionError(f"{cut.name}: decode at {pre}..{pre + n} "
                                 f"is {err:.3e} from the forward > {bound:.3e}")
        caught = []
        for what, kw in faults:
            off = float((lm_teacher_forced(model, tokens, pre, extra=extra,
                                           **kw) - want).abs().max())
            if not off > bound:
                raise AssertionError(f"{cut.name}: the decode bound "
                                     f"{bound:.3e} misses a planted fault, "
                                     f"{what} ({off:.3e})")
            caught.append(f"{what}: {off / bound:.0f}x")
        parts.append(f"positions {pre}..{pre + n - 1}: err {err:.3e} = "
                     f"{err / bound:.3f} of {bound:.3e} ({', '.join(caught)})")
    return "; ".join(parts)


def _slstm_share(model, prefill, batch) -> tuple:
    """One more prefill with every sLSTM block timed between two
    synchronizes: (its sLSTM blocks' ms, the whole prefill's ms)."""
    import torch

    from repro_torch.models import ssm as S

    real, spent = S.slstm_block, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    S.slstm_block = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(model, batch)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        S.slstm_block = real
    return sum(spent) * 1e3, total * 1e3


def lm_serve_full(cfg, B, S, N) -> dict:
    """Gate 3 and the report: the full model in bf16, prefill of B × S,
    then N − 1 greedy steps under ``set_sync_debug_mode("error")``; every
    cache leaf (tuples' leaves and whisper's ``enc_out`` too) keeps its
    storage. A planted host read in the loop must raise, and a planted
    reallocated leaf must fail the storage check. Times follow a warm-up
    (a prefill and two steps); a profile of four more steps gives each
    step's device busy time. For xlstm, the share of prefill in its sLSTM
    blocks' sequential loop."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import init_model
    from repro_torch.models.params import count_params
    from repro_torch.train.step import make_prefill_step, make_serve_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()    # earlier phases' tensors
    t0 = time.perf_counter()
    model = init_model(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device="cuda", dtype=torch.int32)
    batch = {"tokens": prompts,
             **lm_frontend(cfg, B, gen, "cuda", torch.bfloat16)}
    prefill = make_prefill_step(cfg, cache_len=S + N)
    decode = make_serve_step(cfg)
    tok, caches = prefill(model, batch)                   # warm-up
    for i in range(2):
        tok, caches = decode(model, {"tokens": tok, "caches": caches,
                                     "pos": S + i})
    del caches
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    tok, caches = prefill(model, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    leaves = _cache_leaves(caches)
    storages = _storages(leaves)
    out = [tok]
    prev = torch.cuda.get_sync_debug_mode()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(N - 1):
            tok, new = decode(model, {"tokens": tok, "caches": caches,
                                      "pos": S + i})
            if new is not caches:
                raise AssertionError(f"{cfg.name}: decode returned a new "
                                     f"cache tree")
            out.append(tok)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    if _storages(_cache_leaves(caches)) != storages:
        raise AssertionError(f"{cfg.name}: a cache leaf changed its storage")
    # the two planted faults
    torch.cuda.set_sync_debug_mode("error")
    try:
        int(tok[0, 0])
        raised = False
    except RuntimeError:
        raised = True
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    planted = [leaves[0].clone()] + leaves[1:]
    if not raised or _storages(planted) == storages:
        raise AssertionError(f"{cfg.name}: the sync debug mode or the "
                             f"storage check misses its planted fault")
    del planted, leaves
    gen_tok = torch.cat(out, 1).cpu()
    peak = torch.cuda.max_memory_allocated()
    # where a decode step's time goes: 4 steps under the profiler (at the
    # first positions again), device-side events only
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(4):
            tok, caches = decode(model, {"tokens": tok, "caches": caches,
                                         "pos": S + i})
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 4
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3 / 4
    kernels = sum(e.count for e in dev_events) / 4
    r = {"params": count_params(model), "batch": B, "prompt": S,
         "new_tokens": N, "init_s": t_init, "prefill_ms": t_prefill * 1e3,
         "prefill_tokens_per_s": B * S / t_prefill,
         "decode_ms_per_token": t_decode / (N - 1) * 1e3,
         "decode_tokens_per_s": B * (N - 1) / t_decode,
         "max_memory_allocated": peak, "memory_allocated_before": before,
         "profiled_step_wall_ms": wall, "profiled_step_device_busy_ms": busy,
         "profiled_step_busy_share": busy / wall,
         "device_kernels_per_step": kernels,
         "tokens": [gen_tok[b, :8].tolist() for b in range(2)]}
    if cfg.family == "ssm":
        del caches
        r["slstm_prefill_ms"], r["slstm_timed_prefill_ms"] = _slstm_share(
            model, prefill, batch)
        r["slstm_prefill_share"] = (r["slstm_prefill_ms"]
                                    / r["slstm_timed_prefill_ms"])
    del model
    torch.cuda.empty_cache()
    return r


def phase_lm_serving() -> dict:
    """Phase 3f: gates 1–3 and the report per configuration."""
    from repro_torch.configs import get_config, replace

    out = {}
    for arch, (B, S, N) in LM_SERVE.items():
        t0 = time.perf_counter()
        cfg = get_config(arch)
        cut = replace(cfg, dtype="float32", **LM_CUT[arch])
        enc = (f", {cfg.encoder_layers} encoder layers over "
               f"{cfg.frontend_len} frames" if cfg.encoder_layers else "")
        log(f"  {arch}: {cfg.num_layers} layers{enc}, d {cfg.d_model}, "
            f"heads {cfg.num_heads}/{cfg.num_kv_heads}, vocab "
            f"{cfg.vocab_size}")
        log(f"    gate 1, card = CPU port ({cut.num_layers} layers, fp32): "
            f"{lm_gate_card_vs_cpu(cut)}")
        dcut = replace(cut, moe_capacity=8.0) if cut.family == "moe" else cut
        log(f"    gate 2, decode = forward ({dcut.num_layers} layers, fp32"
            f"{', capacity 8.0' if cut.family == 'moe' else ''}): "
            f"{lm_gate_decode_vs_forward(dcut)}")
        r = lm_serve_full(cfg, B, S, N)
        log(f"    gate 3, bf16 full depth: {N - 1} decode steps under the "
            f"sync debug mode, cache storage kept; both planted faults "
            f"caught")
        log(f"    report: {json.dumps(r)} ({time.perf_counter() - t0:.1f} s)")
        out[arch] = r
    return out


def previous_order_gains(caches, dvec, *, seed, n_total=None, fold="min",
                         score_affine=None):
    """The sieve gains of ``cat([seed, caches])`` in the order of fp32
    additions of the sieve kernel before its split of n, in plain PyTorch:
    one 256-thread block per row, thread t adding columns t, t + 256, … in
    order, then a shared-memory tree (s = 128, 64, …, 1), then one true
    division. Each step is one IEEE fp32 operation, so the bits are that
    kernel's. A diagnostic only: it names the element whose accept
    decision the new order flips."""
    import torch

    T = torch.cat([seed[None], caches])
    n = T.shape[-1]
    if fold == "min":
        g = torch.clamp_min(T - dvec[None, :], 0.0)
    else:
        a, b = score_affine
        g = torch.clamp_min((a + b * dvec)[None, :] - T, 0.0)
    J = -(-n // 256)
    G = torch.nn.functional.pad(g, (0, J * 256 - n)).view(T.shape[0], J, 256)
    acc = torch.zeros_like(G[:, 0])
    for j in range(J):
        acc = acc + G[:, j]
    s = 128
    while s:
        acc[:, :s] += acc[:, s:2 * s]
        s //= 2
    return acc[:, 0] / torch.tensor(float(n if n_total is None else n_total),
                                    device=acc.device)


def first_flip(f, K, EPS, order, block=64) -> str:
    """Step the device sieve over ``order`` twice in lockstep, scoring with
    the kernel and with :func:`previous_order_gains`, and name the first
    element after which the two tables' sizes, exponents or live slots
    differ, with both orders' gains of the seed and of the slots whose
    accept decision differs."""
    import numpy as np
    import torch

    from repro_torch.core import functions as fx
    from repro_torch.core import streaming as st
    from repro_torch.kernels import ops

    eng = st.make_sieve_engine(f, K, EPS, mode="device", block_size=block)
    spec, c = eng.spec, eng._c
    fold, affine = fx.kernel_template(f.spec)
    kernel_gains = ops.sieve_gains
    yes = torch.ones((), dtype=torch.bool, device=f.device)

    def step(state, idx, d, gains_of):
        ops.sieve_gains = gains_of
        try:
            return st._element_step(spec, c, state, idx, d, yes)[0]
        finally:
            ops.sieve_gains = kernel_gains

    def clone(x):
        return st.SieveState(*(t.clone() for t in x))

    def differ(x, y):
        return ((x.sizes != y.sizes).any() | (x.slot_exp != y.slot_exp).any()
                | (x.active != y.active).any())

    a = st.init_state(f.n, spec, f.device)
    b = st.init_state(f.n, spec, f.device)
    for s in range(0, len(order), block):
        ib = np.asarray(order[s:s + block])
        ids = torch.as_tensor(ib.astype(np.int32), device=f.device)
        dmat = eng._distance_rows(eng._stage_block(
            f.V[torch.as_tensor(ib, device=f.device)], len(ib)))
        a0, b0 = clone(a), clone(b)
        flags = []
        for j in range(len(ib)):
            a = step(a, ids[j], dmat[j], kernel_gains)
            b = step(b, ids[j], dmat[j], previous_order_gains)
            flags.append(differ(a, b))
        hit = torch.stack(flags).nonzero()
        if not len(hit):
            continue
        e = int(hit[0])
        a, b = a0, b0
        for j in range(e):
            a = step(a, ids[j], dmat[j], kernel_gains)
            b = step(b, ids[j], dmat[j], previous_order_gains)
        kw = dict(seed=c.seed, fold=fold, score_affine=affine)
        g_new = kernel_gains(a.caches, dmat[e], **kw).cpu()
        g_old = previous_order_gains(b.caches, dmat[e], **kw).cpu()
        a = step(a, ids[e], dmat[e], kernel_gains)
        b = step(b, ids[e], dmat[e], previous_order_gains)
        slots = (a.sizes != b.sizes).nonzero().flatten().tolist()
        grid = not (torch.equal(a.slot_exp, b.slot_exp)
                    and torch.equal(a.active, b.active))
        gains = "; ".join(
            f"{'seed' if r == 0 else f'slot {r - 1}'} {float(g_new[r]):.9g} "
            f"vs {float(g_old[r]):.9g} (gap {float(g_new[r] - g_old[r]):.3e})"
            for r in [0] + [1 + q for q in slots])
        return (f"stream position {s + e}, element {int(ib[e])}: accept "
                f"differs in slots {slots}, grid differs {grid}; gains, this "
                f"kernel vs the previous order: {gains}")
    return "no accept decision differs over the whole stream"


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


def l2_flush(dev):
    """A call that reads 128 MB through the 50 MB L2 (``torch.amax``: the
    lines it leaves are clean, so the next call's misses write nothing
    back), after which the next call finds its operands in device
    memory."""
    import torch

    buf = torch.ones(32 << 20, device=dev)
    return lambda: torch.amax(buf)


def _device_times(calls, reps: int, tries: int = 10) -> dict:
    """Device time (µs) by kernel name over ``reps`` rounds of ``calls``
    (profiled again, up to ``tries`` times, while the profiler reports no
    device activity at all)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for call in calls:
                    call()
            torch.cuda.synchronize()
        times = {e.key: e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0}
        if times:
            break
    return times


def device_ms(fn, reps: int, flush=None) -> float:
    """Device time per call (ms): the durations of the kernels ``fn``
    launches, from the profiler, over ``reps`` calls after a warm-up. For
    kernels of a few µs, CUDA events around one call also time the host's
    launch of it, while the card waits. ``flush`` (:func:`l2_flush`) runs
    before each call; its kernels, which must not share a name with
    ``fn``'s, are left out of the time."""
    import torch

    fn()
    torch.cuda.synchronize()
    if flush is None:
        total = sum(_device_times([fn], reps).values())
    else:
        skip = set(_device_times([flush], 3))
        if not skip or skip & set(_device_times([fn], 3)):
            raise AssertionError(f"the L2 flush's kernels {sorted(skip)} are "
                                 f"missing or shared with the timed call")
        total = sum(t for key, t in _device_times([flush, fn], reps).items()
                    if key not in skip)
    if total <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total / 1e3 / reps


def phase_timing(peaks: dict, V64, Vpaper, serve_shapes) -> dict:
    """Per-kernel times at the main path's shapes (fp32 policy); the
    batched kernels held against their plain versions at every shape in
    ``serve_shapes`` (on the serving phase's payloads ``V64`` and
    ``Vpaper``) and timed at B = 64, n = m = 8 192."""
    import torch

    from repro_torch.core.distances import fp32_is_ieee
    from repro_torch.core.evaluator import e0_distances
    from repro_torch.core.precision import FP32, resolve
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

    def kernel_ms(fn, reps=R):
        ts = cuda_times(fn, reps)
        q1, _, q3 = statistics.quantiles(ts, n=4)
        return dict(ms=statistics.median(ts), ms_q1=q1, ms_q3=q3)

    kw = dict(n_total=N, policy=FP32)
    rel = {}
    extra_times = {}

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
    # the half policies run the same SIMT kernels (payload rounded as it is
    # staged); their tensor-core bound is another PR's yardstick
    for pol in ("bf16", "fp16"):
        ph = resolve(pol)
        kwh = dict(n_total=N, policy=ph)
        kch = ops.kernel_config(K, DIM, ph).k_chunk
        extra_times[f"fused_eval {pol}_ms"] = cuda_ms(
            lambda: ee.fused_eval(V, Sk, lengths, d_e0, k_chunk=kch,
                                  layout="flat", **kwh), R)
        extra_times[f"gain_eval {pol}_ms"] = cuda_ms(
            lambda: mg.gain_eval(Vb, Vb, cache, **kwh), R)
        extra_times[f"gain_update_eval {pol}_ms"] = cuda_ms(
            lambda: mg.gain_update_eval(Vb, Vb, cache, w, wv,
                                        cache_out=out_cache, **kwh), R)
    rows["gain_update_eval"] = dict(
        **kernel_ms(lambda: mg.gain_update_eval(Vb, Vb, cache, w, wv,
                                                cache_out=out_cache, **kw)),
        plain_ms=cuda_ms(lambda: mg.gain_update_eval_plain(Vb, Vb, cache, w,
                                                           wv, **kw), R),
        library_ms=cuda_ms(lambda: Vb @ Vb.T, R),
        bound=bound(gain_flops + 2.0 * N * DIM,
                    gain_in + 4 * (DIM + 1) + 4 * (N + N)))
    Bq, Nq, _ = V64.shape

    def e0_caches(Vs):
        return torch.stack([e0_distances(v, None, "sqeuclidean", FP32)
                            for v in Vs]).contiguous()

    cache64 = e0_caches(V64)
    w64 = V64[:, 123].contiguous()
    wv64 = torch.ones(Bq, device=dev)
    out64 = torch.empty_like(cache64)
    kwb = dict(n_total=Nq, policy=FP32)
    # every (B, n, m, d) the serving path launched a batched kernel at: the
    # first B tenants of its payload, m candidate rows of each (all of them
    # where m = n), their e0 caches, and a winner folded at every request
    payloads = {(Vs.shape[1], Vs.shape[2]): (Vs, caches) for Vs, caches in
                ((V64, cache64), (Vpaper, e0_caches(Vpaper)))}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name in SERVING_KERNELS:
        for B, n, m, d in sorted(serve_shapes[name]):
            Vs, caches = payloads[(n, d)]
            Vs, cache = Vs[:B], caches[:B]
            C = Vs if m == n else torch.stack([
                v[torch.randperm(n, generator=gen, device=dev)[:m]]
                for v in Vs])
            what = f"serving shape B={B} n={n} m={m}"
            kws = dict(n_total=n, policy=FP32)
            if name == "gain_eval_batched":
                agree(name, mg.gain_eval_batched(Vs, C, cache, **kws),
                      mg.gain_eval_batched_plain(Vs, C, cache, **kws), what)
                continue
            w, wv = Vs[:, 123].contiguous(), torch.ones(B, device=dev)
            g, nc = mg.gain_update_eval_batched(Vs, C, cache, w, wv, **kws)
            gp, ncp = mg.gain_update_eval_batched_plain(Vs, C, cache, w, wv,
                                                        **kws)
            agree(name, g, gp, what + " gains")
            agree(name, nc, ncp, what + " cache")
            del g, nc, gp, ncp
    agree("gain_eval_batched", mg.gain_eval_batched(V64, V64, cache64, **kwb),
          mg.gain_eval_batched_plain(V64, V64, cache64, **kwb),
          f"B={Bq} m={Nq}")
    g, nc = mg.gain_update_eval_batched(V64, V64, cache64, w64, wv64, **kwb)
    gp, ncp = mg.gain_update_eval_batched_plain(V64, V64, cache64, w64, wv64,
                                                **kwb)
    agree("gain_update_eval_batched", g, gp, f"gains B={Bq} m={Nq}")
    agree("gain_update_eval_batched", nc, ncp, f"cache B={Bq} n={Nq}")
    del g, nc, gp, ncp
    batched_flops = 2.0 * Bq * Nq * Nq * DIM
    batched_in = 4 * (2 * Bq * Nq * DIM + Bq * Nq)
    # cuBLAS's batched Gram product alone: (64, 8192, 8192) fp32, 17 GB out
    bmm_ms = cuda_ms(lambda: torch.bmm(V64, V64.transpose(1, 2)), R)
    rows["gain_eval_batched"] = dict(
        **kernel_ms(lambda: mg.gain_eval_batched(V64, V64, cache64, **kwb)),
        plain_ms=cuda_ms(lambda: mg.gain_eval_batched_plain(V64, V64, cache64,
                                                            **kwb), R),
        library_ms=bmm_ms,
        bound=bound(batched_flops, batched_in + 4 * Bq * Nq))
    rows["gain_update_eval_batched"] = dict(
        **kernel_ms(lambda: mg.gain_update_eval_batched(
            V64, V64, cache64, w64, wv64, cache_out=out64, **kwb)),
        plain_ms=cuda_ms(lambda: mg.gain_update_eval_batched_plain(
            V64, V64, cache64, w64, wv64, **kwb), R),
        library_ms=bmm_ms,
        bound=bound(batched_flops + 2.0 * Bq * Nq * DIM,
                    batched_in + 4 * Bq * (DIM + 1) + 4 * 2 * Bq * Nq))
    # the sieve kernels at the streaming phase's tables: the seed and the
    # sieve table's 34 slots, the seed and salsa's 64, and 16 partitions of
    # the first (µs-scale kernels: times are device times from the
    # profiler, the CUDA-event times of single calls beside them). Warm:
    # back-to-back calls, the table in the 50 MB L2 where it fits; cold:
    # 128 MB read through the L2 before each call. The bound, by bytes of
    # device memory, is a bound on the cold time.
    flush = l2_flush(dev)

    def sieve_row(kernel, plain, library, flops, nbytes):
        ev = kernel_ms(kernel, 50)
        return dict(
            ms=device_ms(kernel, 50), plain_ms=device_ms(plain, 50),
            library_ms=device_ms(library, 50),
            cold_ms=device_ms(kernel, 50, flush),
            cold_plain_ms=device_ms(plain, 50, flush),
            cold_library_ms=device_ms(library, 50, flush),
            bound=bound(flops, nbytes), event_ms=ev["ms"],
            event_ms_q1=ev["ms_q1"], event_ms_q3=ev["ms_q3"],
            event_plain_ms=cuda_ms(plain, 50),
            event_library_ms=cuda_ms(library, 50))

    for r in (34, 64):
        T, d = sieve_operands((), r + 1, N, "min", seed=r)
        seed, T = T[0].clone(), T[1:].contiguous()
        kws = dict(n_total=N, seed=seed)
        agree("sieve_gain_eval", mg.sieve_gain_eval(T, d, **kws),
              mg.sieve_gain_eval_plain(T, d, **kws), f"seed + ({r}, {N})")
        # the yardstick: one torch.sum over the same rows, seed in front
        full = torch.cat([seed[None], T])
        row = sieve_row(lambda: mg.sieve_gain_eval(T, d, **kws),
                        lambda: mg.sieve_gain_eval_plain(T, d, **kws),
                        lambda: torch.sum(full, dim=-1),
                        3.0 * (r + 1) * N, 4 * ((r + 1) * N + N + r + 1))
        if r == 34:
            rows["sieve_gain_eval"] = row
        else:  # salsa's table, beside the sieve table's row
            rows["sieve_gain_eval"].update({
                f"r65_{k}": v[0] if k == "bound" else v
                for k, v in row.items() if k in ("ms", "plain_ms",
                                                 "library_ms", "cold_ms",
                                                 "cold_library_ms", "bound",
                                                 "event_ms")})
    T, d = sieve_operands((16,), 35, N, "min", seed=16)
    seed, T = T[0, 0].clone(), T[:, 1:].contiguous()
    kws = dict(n_total=N, seed=seed)
    agree("sieve_gain_eval_batched", mg.sieve_gain_eval_batched(T, d, **kws),
          mg.sieve_gain_eval_batched_plain(T, d, **kws),
          f"seed + (16, 34, {N})")
    full = torch.cat([seed.expand(16, 1, N), T], dim=1)
    rows["sieve_gain_eval_batched"] = sieve_row(
        lambda: mg.sieve_gain_eval_batched(T, d, **kws),
        lambda: mg.sieve_gain_eval_batched_plain(T, d, **kws),
        lambda: torch.sum(full, dim=-1),
        3.0 * 16 * 35 * N, 4 * (16 * 34 * N + N + 16 * N + 16 * 35))
    del T, d, full, flush
    for name, r in rows.items():
        r["main_rel_err"] = rel[name]
    for key, ms in extra_times.items():
        name, field = key.split()
        rows[name][field] = ms
    return rows


def phase_end_to_end() -> dict:
    """Steady-state wall times of the main path's user calls (median of 3
    after a warm-up call), and profiles of greedy (both plans) and of a
    2 048-element window of the device sieve: device busy time by kernel
    against the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (EvalConfig, ExemplarClustering,
                                  PackedMultiset, greedy, lazy_greedy,
                                  sieve_streaming)
    from repro_torch.core.optimizers import _stream
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
    prefix = _stream(f, None, 0)[:2048]
    runs = {f"greedy_{mode}": functools.partial(greedy, f, K, mode=mode)
            for mode in ("device", "host")}
    # a window of the streaming path: 2 048 elements of the device sieve
    runs["sieve_device_2048"] = functools.partial(
        sieve_streaming, f, K, order=prefix, mode="device", block_size=64)
    for name, run in runs.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only: an ATen op's own entry repeats the
        # device time of the kernels it launched
        by_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                            for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA
                            and e.self_device_time_total > 0), reverse=True)
        busy = sum(t for t, _, _ in by_kernel)
        out[f"{name}_profiled_wall_ms"] = wall_ms
        out[f"{name}_device_busy_ms"] = busy
        log(f"    profile {name} k={K}: wall {wall_ms:.1f} ms (profiler on), "
            f"device busy {busy:.1f} ms" + (
                "" if busy else " (no device time in the trace: not measured)"))
        for t, count, key in by_kernel[:6]:
            log(f"      {t:9.3f} ms  {count:6d} x {t / count * 1e3:8.2f} us  "
                f"{key[:80]}")
        for t, count, key in by_kernel:   # the sieve kernel's in-stream time
            if "sieve_gain_kernel" in key:
                out[f"{name}_sieve_kernel_us_per_launch"] = t / count * 1e3
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
    identical = phase_kernels_batched(check)
    phase_kernels_sieve(check)
    phase_segment_edges(check)
    report_kernel_checks(check)
    phase_invariance()
    log(f"    batched kernels: {identical} requests bit for bit equal to "
        f"their unbatched launches (gains and folded cache)")

    log("[3] main path at the paper's size")
    ops.LAUNCHES.clear()
    walls = phase_main_path()
    main_launches = dict(ops.LAUNCHES)
    log(f"    launches: {json.dumps(main_launches)}")
    log("[3b] multi-tenant serving (SelectionService, run_selection_batch)")
    serve_walls, V64, Vpaper, serve_launches, serve_shapes = phase_serving()
    walls.update(serve_walls)
    log("[3c] streaming at the paper's size (sieve family, ingestion "
        "services)")
    t0 = time.perf_counter()
    ops.LAUNCHES.clear()
    stream_walls, fstream, full = phase_streaming()
    walls.update(stream_walls)
    stream_launches = dict(ops.LAUNCHES)
    log(f"    launches: {json.dumps(stream_launches)}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    same_members = full.indices == EARLIER_STREAM_MEMBERS
    log(f"    whole-stream members equal the previous order's "
        f"{EARLIER_STREAM_MEMBERS} (reported, not gated): {same_members}")
    if not same_members:
        from repro_torch.core.optimizers import _stream

        t1 = time.perf_counter()
        log(f"    first flipped element: "
            f"{first_flip(fstream, 10, 0.1, _stream(fstream, None, 0))} "
            f"({time.perf_counter() - t1:.1f} s)")
    del fstream
    log("[3e] contracts on the card (repro_torch.analysis.audit --device "
        "cuda --quick, then the paper's size)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    audit_launches = phase_contracts()
    log(f"    phase {time.perf_counter() - t0:.1f} s")
    log(f"[3d] mesh plans: {MESH_P} gloo ranks on cuda:0, then one NCCL rank "
        f"(n = 50 000, d = 100, k = 10)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_launches = phase_mesh(DEVICE_REFS)
    log(f"    phase {time.perf_counter() - t0:.1f} s")
    log(f"[3f] LM serving at full width ({', '.join(LM_SERVE)}; bf16)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ops.LAUNCHES.clear()
    phase_lm_serving()
    log(f"    launches of the port's kernels: "
        f"{json.dumps(dict(ops.LAUNCHES))} (the LM path has none); phase "
        f"{time.perf_counter() - t0:.1f} s")
    # each path's own launches: the main path's four kernels, the serving
    # path's two, the streaming path's two
    launches = {k: main_launches.get(k, 0) for k in MAIN_KERNELS}
    launches.update({k: serve_launches.get(k, 0) for k in SERVING_KERNELS})
    launches.update({k: stream_launches.get(k, 0) for k in STREAM_KERNELS})
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main, serving and streaming paths launched no "
                             f"{missing}")

    log("[4] timing at the main path's shapes (fp32, CUDA events)")
    peaks = peaks_for(torch.cuda.get_device_name(0))
    rows = phase_timing(peaks, V64, Vpaper, serve_shapes)
    del V64, Vpaper
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = rows[name]
        bound_ms, bound_by = r["bound"]
        extra = {k: v for k, v in r.items()
                 if k not in ("ms", "plain_ms", "library_ms", "bound")}
        log(f"    {name}: kernel {r['ms']:.4f} ms (before the split of "
            f"n: {EARLIER_MS[name]} ms), plain {r['plain_ms']:.4f} "
            f"ms, {LIBRARY[name]} {r['library_ms']:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}) {json.dumps(extra)}")
        if name == "gain_eval":
            log(f"      m=256 re-score: {r['top256_ms']:.4f} ms (before the "
                f"split of n: {EARLIER_MS['gain_eval top256']} ms)")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            # at the main path's policy (fp32) on phase 2's ragged shapes;
            # the log above has the others
            "max_abs_err": check.max_err[(name, "fp32")],
            "main_rel_err": r["main_rel_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r["library_ms"],
            # launches in the contract phase (3e)
            "audit_launches": audit_launches.get(name, 0),
            # per rank of the mesh phase (3d), for the kernels it runs
            **({"mesh_launches": [mesh_launches[q].get(name, 0)
                                  for q in sorted(mesh_launches)]}
               if name in MESH_KERNELS else {})})
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
