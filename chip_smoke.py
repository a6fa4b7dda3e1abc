#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. Environment and build: the card's name and power limit, torch/CUDA
   versions, and the build of every CUDA source under
   ``src/repro_torch/csrc`` (one nvcc each, in parallel) with the
   compiler's register/spill report, and a gate on the built code
   (``cuobjdump -sass``): every bf16 and fp16 instance of the gain and
   exemplar-eval kernels holds tensor-core instructions (HGMMA, or HMMA),
   and no fp32 or fp16_strict instance, second pass or sieve kernel holds
   any. While nvcc runs, this process runs phase 3g's fp32 gates 1 and 2
   (below), which launch none of the port's kernels.
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
   launch, ``fused_eval`` on 97 sets against the l = 5 000 launch, at
   every policy (bf16 and fp16 on the tensor cores).
3. The main path at the paper's size (N=50 000, l=5 000, k=10, dim=100):
   multiset evaluation in fused/flat, fused/loop and two_pass against the
   ``torch`` backend; greedy, stochastic and lazy greedy on the device plan
   against the host plan (identical indices and evaluation counts);
   multiset greedy against mincache greedy; then the paper's half-precision
   workload at fp16 and bf16 (the tensor-core kernels): ``evaluate_multiset``
   fused/flat against the ``torch`` backend at the same policy (relative
   1e-4), device greedy and lazy greedy against host mode. Kernel launches
   are counted over this phase only.
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
   2 048 elements (identical members and evaluations, values within
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
   and sieve / pp / salsa under ``device_sharded`` on the first 2 048
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
   chunk). Gate 3: the models at full width, ``LM_CUT``'s depth, in bf16
   (``LM_SERVE``), the decode
   loop under ``torch.cuda.set_sync_debug_mode("error")`` with every cache
   leaf (recurrent state tuples and whisper's ``enc_out`` included)
   keeping its storage. Each gate also catches a planted fault: logits
   off by 1 %, a decode one position off (not for xlstm, which has no
   positions), a decode that skips the in-place write of an ``ssm`` leaf
   (xlstm, hymba), a host read in the loop and a reallocated cache leaf.
   Reported, not gated: the bf16 tokens, prefill and decode times,
   tokens/s, peak memory, a profile of four decode steps (device busy
   time, its share of the step, kernels per step) and, for xlstm, the
   share of prefill in the sLSTM's sequential loop. The LM serving path
   launches none of the port's kernels.
   Then LM training with curation (phase 3g), TF32 off for the fp32
   gates, whose gates 1 and 2 run during phase 1's build. Gate 1: ``qwen3-0.6b``, ``granite-moe-3b-a800m`` and
   ``xlstm-1.3b`` at ``LM_CUT`` in fp32, one train step on the card and on
   the CPU from the same state after two warm steps on the batch's tokens
   shuffled (B = 2, 40 tokens):
   loss, grad norm and every leaf of the updated params, master, m and v
   within ``LM_TRAIN_CARD_CPU_REL`` (beside it, each side's distance from
   the step replayed in float64 on the card), the card's master also
   within ``LM_TRAIN_UPDATE_REL`` of its own update recomputed in float64,
   its params the master's cast; a planted update without bias correction
   on one leaf must exceed both bands.
   Gate 2, on the card at ``qwen3-0.6b``'s cut: ``microbatches=4`` = 1 within 1e-4,
   ``remat`` on = off bit for bit, and 4 steps through ``train()`` with a
   checkpoint at 2 and a resume = 4 straight steps bit for bit, under
   ``torch.use_deterministic_algorithms(True)``; a planted resume with m
   and v at zero must differ. Gate 3: ``qwen3-0.6b`` uncut in bf16 through
   ``train()`` over ``token_batches(..., curation=CurationConfig(256, 64),
   eval_cfg=EvalConfig(backend="cuda"))`` (``LM_TRAIN_FULL``: 24 steps of
   8 × 512 over 3 windows): every loss finite, the last below the first,
   each window's selection on the card held round by round against the
   ``torch`` backend's gains on the CPU at the card's own caches (the
   CPU's best, or a tie within both sides' rounding), and ``gain_eval``
   launched 64 times per window over ``train()`` (``train_launches``).
   Reported: ms per step, tokens/s of the steps and of the whole loop
   with its curations, peak memory,
   MFU against the dense bf16 peak, the busy share of one profiled step,
   the curation's ms per window (host embedding, selection) and
   ``gain_eval`` at the curation's shape (n = m = 256, d = 64) against its
   plain version, with its device time, ``V @ V.T``'s and its bound.
   Between 3f and 3g, LM serving on a mesh (phase 3h): ``LM_MESH_SHAPE``
   = (data 1, model 4) gloo ranks on ``cuda:0`` (``spawn_local``, a store
   under ``build/lm_mesh``), each holding the whole model (seeded) and its
   own block of the cache, through ``make_prefill_step`` /
   ``make_serve_step`` with ``rules=MeshRules.for_mesh(DeviceMesh)``, bf16,
   at full width and one layer period deep (``LM_MESH``, ``LM_MESH_CUT``):
   ``gemma3-1b`` 4 × 1 024 + 64 greedy tokens with a
   2 048 cache (its one kv head splits the buffers: the flash-decoding
   combine every decode step) and ``granite-moe-3b-a800m`` 4 × 512 + 32 at
   capacity 8.0 (expert parallelism over ``all_to_all_single`` in prefill,
   the dense MoE and heads-split caches in decode); then one NCCL rank on a
   (1, 1) mesh runs granite's prefill (expert parallelism over NCCL). Gates:
   every rank's tokens, and each step's logits bit for bit, equal rank 0's;
   rank 0 serves the same prompts on the single-device path fed the mesh's
   tokens, and every step's last-position logits lie within
   ``LM_MESH_REL`` of their max, the tokens equal but where the
   single-device top-2 margin is within 2 x the step's gap (a tie); prefill
   uses expert parallelism and decode does not, and granite's first MoE
   layer on a seeded input at the prefill's shape is bit for bit the dense
   MoE's on every rank; the NCCL prefill issues ``all_to_all_single``, its
   layer is bit for bit the dense one's, and its logits are in the band of
   the single-device prefill.
   Reported: each rank's prefill and decode times, its cache bytes beside
   the single-device cache's, the census of one decode step (collectives
   and the largest operand; and of a prefill, for granite), beside the
   card's line.
   In the same four ranks, LM training on a mesh (phase 3i): a second
   ``DeviceMesh`` of ``LM_MESH_TRAIN_SHAPE`` = (2, 2) over them, each rank
   holding its blocks of the params, master and moments. Gate 1 (fp32,
   ``qwen3-0.6b`` and ``granite-moe-3b-a800m`` at ``LM_CUT`` and full
   width, 8 × 64, a clip that binds): two steps after two warm ones,
   held to rank 0's single-device replay from the gathered warm state —
   loss
   and params, master, m, v within ``LM_TRAIN_CARD_CPU_REL``, a leaf
   beyond it no farther from a float64 replay than the single device plus
   the band; grad norm within ``LM_MESH_TRAIN_NORM_REL`` —, replicated
   leaves bit for bit on every rank, granite's ``all_to_all_single`` in
   every rank's census; for qwen3 two planted faults (the data-parallel
   sum left out, every leaf counted on every rank in the clip norm) must
   move the grad norm out of gate 1's band, and the elastic restore:
   saved on (2, 2), restored on (1, 4), its next step within the band of
   (2, 2)'s. Gate 2: bf16 ``qwen3-0.6b`` at ``LM_CUT``, 8 × 512, three
   steps from one curated window (``gain_eval`` on the card on every rank,
   the same picks), losses within ``LM_MESH_TRAIN_BF16_REL`` of the single
   device's. On 3h's NCCL rank, ``train(mesh=(1, 1))`` two fp32 steps bit
   for bit ``train(mesh=None)``. Reported per rank: ms per step, state
   bytes against the whole, a step's census, peak memory, ``gain_eval``
   launches, and each part's seconds.
   After 3g, the production dry run against the card (phase 3j): the dry
   run (``repro_torch.launch.dryrun``) of phase 3g's cell — ``qwen3-0.6b``
   uncut, bf16, remat, 8 × 512, the placed train step on a (1, 1) mesh —
   on meta tensors over a fake group of one rank, then one real step of
   the same code path on the card on one NCCL rank, under the dry run's
   own counters. Gates: the FLOPs (``FlopCounterMode``), the bytes
   accessed, the op count, the peak of the step's live storage and the
   collectives equal on both sides, and the argument bytes the summed
   ``nbytes`` of the real state and batch. Printed, not gated: the
   predicted peak beside the real step's ``max_memory_allocated`` (over
   what the card held before its state) and 3g's, the roofline's bound
   of the unfused eager step and the function's floor bound (H100
   data-sheet peaks) beside 3g's ms per step, ``lm_train_flops`` beside
   the counted FLOPs, and the phase's seconds.
   After 3j, the reference's property suites and top-level examples on the
   card (phase 3k). (a) Every kernel against its plain version in phase
   2's bands (each comparison catching the planted 1 % fault) at the
   shapes of ``tests/test_kernels.py``: ``fused_eval`` at its ``SHAPES``
   in both layouts, ``two_pass_eval`` at the first three, every policy at
   (128, 16, 5, 48), rbf at (96, 12, 4, 32), chunked launches under the
   suite's 400 000-byte budget (one chunk) and a 30 000-byte one (five)
   equal to the unchunked one within 1e-6; then
   ``SUITE_DRAWS`` seeded draws from the suites' ranges, each a gain shape
   (n in [9, 150], m in [1, 40], d in [1, 70], B in [1, 8], either fold)
   through rows 4-7 and a sieve table (r in [1, 65], n in [1, 150], P in
   [1, 8], with and without the seed row) through rows 8-9: every gain
   >= -1e-6, each request or partition of a batched launch bit for bit its
   unbatched launch. (b) The suites' invariants on the ``cuda`` backend at
   their generators and a fixed number of seeded draws
   (``SUITE_INVARIANTS``): monotone, diminishing returns, f(empty) = 0,
   greedy >= (1 - 1/e) OPT by brute force at n = 12, min-cache = direct
   value, every distance, the sieve's (1/2 - eps) bound on both plans, the
   zoo's chain (non-members only, ROADMAP C.2) and telescoping under rbf,
   and the device sieve's tables on the 1/32 grid (exact sums) with the
   ``cuda`` backend bit for bit the ``torch`` backend's, drawn and under
   salsa's eviction. (c) ``examples/quickstart_torch.py`` and
   ``examples/streaming_summarization_torch.py``, ``run(device="cuda")``
   at their own sizes (the quickstart's sharded step on one NCCL rank),
   held to the reference's figures (``QUICKSTART_FIGURES``,
   ``STREAMING_FIGURES``): identical selections, or at an argmax step a
   near tie whose two gains lie within the fp32 band (``gain_gap``);
   identical evaluations where the selections are; values within
   ``POLICY_TOLS``; device = host, CELF device = host, sharded = device.
   Launches are counted over this phase (``suites_launches``), and every
   kernel must launch in it. Each part's seconds are printed.
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
   HBM bound is a bound on the cold time. Then rows 1-7 (and CELF's m = 256
   re-score) at bf16 and fp16, on the tensor cores, each held to its plain
   version at ``MAIN_REL`` and timed beside it, beside cuBLAS in the
   compute dtype and beside their bound: the largest of the products at
   the dense bf16/fp16 peak, the epilogue's fp32 operations at the SIMT
   rate and the bytes.

5. Steady-state wall times of the main path's calls, and profiles (device
   busy time by kernel against wall time) of greedy in both plans and of a
   512-element window of the device sieve, with each top kernel's
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
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: Bands of kernel vs plain (and vs the math oracle of kernels/ref.py) on
#: the card, on max|err| / scale with scale = max(1, max|plain|, g·(max‖v‖² +
#: max‖s‖²)): the Gram identity ‖v‖²+‖s‖²−2⟨v,s⟩ loses eps·(‖v‖²+‖s‖²)
#: absolute however small the distance, and the rbf transform scales that
#: by at most g = 2γ (g = 1 for sqeuclidean). Kernel and plain version round
#: the payload alike and, but for fp16_strict, both accumulate in fp32, so
#: bf16 and fp16 keep the fp32 band: their tensor-core kernels sum the same
#: products in another fp32 order, and any such order of a Gram sum stays
#: within half the band up to d = 1 024 (tests/test_torch_tensor_core.py).
#: On the H100 the largest reading of the three was 0.45 of it (fused_eval,
#: fp16, d = 1024, on the tensor cores; 0.18 on the SIMT tile). fp16_strict accumulates
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


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def peaks_for(name: str) -> dict:
    """The card's row of the dense peaks (NVIDIA data sheets:
    ``repro_torch.launch.roofline.PEAKS``): fp32 outside the tensor cores,
    bf16/fp16 on the tensor cores, device memory bandwidth."""
    from repro_torch.launch.roofline import PEAKS

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


#: The tensor-core instructions a kernel instance may hold (wgmma is HGMMA
#: in SASS; mma.sync HMMA).
TC_SASS = ("HGMMA", "HMMA")
#: The sources whose kernels phase 1's SASS gate reads (an instance's
#: policy P is the template argument after the input type in its mangled
#: name; the sieve kernels and the second pass take none).
TC_GATED = ("exemplar_eval", "marginal_gain", "sieve_gain")


def sass_tensor_cores(lib_path) -> dict:
    """Tensor-core instructions per kernel instance of one built library
    (``cuobjdump -sass``): {mangled name: count}."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and any(op in line for op in TC_SASS):
            counts[fn] += 1
    return counts


def sass_gate() -> dict:
    """Phase 1's gate on the built kernels: every bf16 and fp16 instance
    (P = 1, 2) of the gain and exemplar-eval kernels holds tensor-core
    instructions, and no other kernel (their fp32 and fp16_strict
    instances, the row pass, the second pass, the sieve kernels) holds any.
    Returns, per source and policy (the others as "other"), the instances
    and the fewest and most tensor-core instructions."""
    from repro_torch.kernels import _build

    names = {0: "fp32", 1: "bf16", 2: "fp16", 3: "fp16_strict"}
    report = {}
    for src in TC_GATED:
        counts = sass_tensor_cores(_build._lib_path(src))
        if not counts:
            raise AssertionError(f"cuobjdump found no kernel in {src}")
        for fn, n in counts.items():
            m = re.search(r"_Z\d+(?:exemplar|gain)(?:_tc)?_kernelI"
                          r"(?:f|13__nv_bfloat16|6__half)Li(\d)E", fn)
            pol = names[int(m.group(1))] if m else "other"
            if (pol in ("bf16", "fp16")) != (n > 0):
                raise AssertionError(
                    f"{src}: {fn} ({pol}) holds {n} tensor-core instructions")
            lo, hi, k = report.get((src, pol), (n, n, 0))
            report[src, pol] = (min(lo, n), max(hi, n), k + 1)
    return {f"{src} {pol}": {"instances": k, "tensor_core_instructions":
                             [lo, hi]}
            for (src, pol), (lo, hi, k) in sorted(report.items())}


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
    on 97 of the sets the same sets' values of the l = L launch, at every
    policy (the SIMT tile at fp32 and fp16_strict, the tensor cores at bf16
    and fp16). Returns the number of columns compared per kernel."""
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

    for pol in POLICIES:
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
        f"against m={N}, fused_eval on 97 sets against l={L}; "
        f"{', '.join(POLICIES)})")
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


def pick_gains(f, sel_a, sel_b, t) -> list:
    """Host gains of the two diverging picks at round t, against the cache
    of sel_a's first t picks."""
    cache = f.init_cache()
    for j in sel_a[:t]:
        cache = f.fold_winner(cache, j)
    return f.gains_from_cache(cache, [sel_a[t], sel_b[t]]).cpu().tolist()


def gain_gap(f, sel_a, sel_b, t):
    """The two diverging picks' host gains at round t, as a line."""
    g = pick_gains(f, sel_a, sel_b, t)
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

    # the paper's half-precision workload: the same calls on the tensor-core
    # kernels, multiset evaluation held to the torch backend at the same
    # policy, device greedy and CELF to host mode
    for pol in ("fp16", "bf16"):
        ref_h = ExemplarClustering(V, EvalConfig(
            policy=pol, memory_budget_bytes=4 << 30)).loss_multi(packed)
        fh = ExemplarClustering(V, EvalConfig(backend="cuda", policy=pol))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fh.loss_multi(packed)
        torch.cuda.synchronize()
        key = f"evaluate_multiset fused/flat {pol}"
        walls[key] = time.perf_counter() - t0
        rel = float((got - ref_h).abs().max() / ref_h.abs().max())
        if not (got.shape == (L,) and bool(torch.isfinite(got).all())
                and rel <= 1e-4):
            raise AssertionError(f"{key}: relative error {rel:.3e} vs torch")
        log(f"  {key} l={L} k={K}: relative error vs torch backend "
            f"{rel:.3e}; {walls[key] * 1e3:.1f} ms")
        fg = ExemplarClustering(X, EvalConfig(backend="cuda", policy=pol))
        for name, run in (
                ("greedy", lambda mode: greedy(fg, K, mode=mode)),
                ("lazy_greedy", lambda mode: lazy_greedy(fg, K, mode=mode))):
            res = {}
            for mode in ("device", "host"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[mode] = run(mode)
                torch.cuda.synchronize()
                walls[f"{name} {mode} {pol}"] = time.perf_counter() - t0
            same_selection(f"{name} {pol} n={N} k={K}", res["device"],
                           res["host"], fg)
            log(f"    wall: device {walls[f'{name} device {pol}']:.3f} s, "
                f"host {walls[f'{name} host {pol}']:.3f} s")

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


def phase_streaming(N=50_000, DIM=100, K=10, EPS=0.1, PREFIX=2048, P=16,
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
#: and two decoder layers). Gate 3 runs at this depth too (at the
#: published widths, batches, prompts and token counts), to give phase 3i
#: its time inside the script's limit.
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
    """Gate 3 and the report: the model in bf16, prefill of B × S,
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
        r = lm_serve_full(replace(cfg, **LM_CUT[arch]), B, S, N)
        log(f"    gate 3, bf16 at LM_CUT's depth: {N - 1} decode steps under "
            f"the sync debug mode, cache storage kept; both planted faults "
            f"caught")
        log(f"    report: {json.dumps(r)} ({time.perf_counter() - t0:.1f} s)")
        out[arch] = r
    return out


#: Phase 3h, LM serving on a mesh of ``LM_MESH_SHAPE`` (data, model) gloo
#: ranks on the one card, bf16, each at full width: (batch, prompt,
#: greedy tokens, cache length, MoE capacity). gemma3's one kv head does not
#: divide the model axis, so its caches split along the buffer (the 512-slot
#: ring and the 2 048-slot global layers both divide by 4) and decode runs
#: the flash-decoding combine; the 1 024-token prompt wraps the ring before
#: decode starts. granite's 48 padded experts and its 512-token prompt
#: divide by 4, so prefill runs expert parallelism over
#: ``all_to_all_single``; decode (S = 1) takes the dense MoE, and its 8 kv
#: heads split over the model axis. granite runs at capacity 8.0, which
#: drops nothing: expert parallelism bins per source rank, the dense path
#: per call, so only without drops do the two compute one function (as in
#: the reference's own ``test_moe_ep_matches_dense``).
LM_MESH = {"gemma3-1b": (4, 1024, 64, 2048, None),
           "granite-moe-3b-a800m": (4, 512, 32, 544, 8.0)}
LM_MESH_SHAPE = (1, 4)
#: 3h's depth, cut to one period of each layer pattern, the cuts of
#: ``LM_CUT`` (gemma3's five local layers and its global one; granite's two
#: MoE layers), to give phase 3i the time it takes inside the script's
#: limit; widths, batches, prompts, tokens and caches stay as they were.
LM_MESH_CUT = {"gemma3-1b": LM_CUT["gemma3-1b"],
               "granite-moe-3b-a800m": LM_CUT["granite-moe-3b-a800m"]}
#: The mesh against the single-device path on the card, bf16: each step's
#: last-position logits within 1/16 of their max |value| (the port's bf16
#: serving band, ``tests/test_torch_lm_serve.py``'s ``REL_BF16``); tokens
#: equal except where the single-device top-2 margin is within 2 x the
#: step's largest logit gap.
LM_MESH_REL = 1 / 16


def _mesh_rules_on(world: int, data: int):
    """``MeshRules`` on a (data, model) ``DeviceMesh`` over the world."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.sharding import MeshRules

    grid = np.arange(world).reshape(data, world // data).tolist()
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return MeshRules.for_mesh(DeviceMesh(kind, grid,
                                         mesh_dim_names=("data", "model")))


def _lm_mesh_setup(arch, B, S, capacity):
    import torch

    from repro_torch.configs import get_config, replace
    from repro_torch.models.model import init_model

    torch.cuda.set_device(0)
    cfg = replace(get_config(arch), **LM_MESH_CUT[arch])
    if capacity is not None:
        cfg = replace(cfg, moe_capacity=capacity)
    model = init_model(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device="cuda", dtype=torch.int32)
    return cfg, model, prompts


def _mesh_vs_one(mesh_rows, one_rows, tokens) -> dict:
    """Per step: the largest logit gap against ``LM_MESH_REL`` of the
    single-device logits' max, and the mesh's token against the single
    device's argmax (a tie where the top-2 margin is within 2 x the gap).
    The single-device path was fed the mesh's tokens, so every step after
    a tie is still compared."""
    import torch

    worst, ties = 0.0, []
    for j, (a, b) in enumerate(zip(mesh_rows, one_rows)):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        worst = max(worst, err / (LM_MESH_REL * scale))
        if err > LM_MESH_REL * scale:
            raise AssertionError(f"step {j}: logits {err:.4e} apart, band "
                                 f"{LM_MESH_REL * scale:.4e}")
        top2 = torch.topk(b, 2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= 2 * err
        same = tokens[:, j] == torch.argmax(b, dim=-1)
        if not bool(torch.all(same | tie)):
            raise AssertionError(f"step {j}: tokens {tokens[:, j].tolist()} "
                                 f"!= single device "
                                 f"{torch.argmax(b, -1).tolist()}")
        ties += [(j, b_) for b_ in torch.nonzero(~same).flatten().tolist()]
    return {"worst_of_band": worst, "ties": ties}


def _ep_vs_dense(model, rules, B, S) -> float:
    """The first MoE layer at the prefill's shape on a seeded input:
    largest gap between expert parallelism and the dense path."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models.moe_ep import moe_ep

    cfg = model.cfg
    p = next(iter(model.groups.values()))[0]["moe"]
    w = model.embed["w"]
    gen = torch.Generator(device=w.device)
    gen.manual_seed(2)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=w.device) \
        .to(w.dtype)
    with torch.no_grad():
        ep = moe_ep(p, cfg, x, cfg.act, rules)
        return float((ep.float() - L.moe(p, cfg, x, cfg.act).float())
                     .abs().max())


def lm_mesh_rank(rank, world, data, arch, B, S, N, cache_len, capacity):
    """One gloo rank of phase 3h on cuda:0: a warm-up (its prefill under
    the census), then the timed prefill and N − 1 greedy decode steps on
    the mesh with each step's logits kept; a census of one more decode
    step; rank 0 then serves the same prompts on the single-device path,
    fed the mesh's tokens, and compares step by step."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis.census import take_census
    from repro_torch.models.model import tree_leaves
    from repro_torch.models.moe_ep import ep_applicable
    from repro_torch.train.step import make_prefill_step, make_serve_step

    cfg, model, prompts = _lm_mesh_setup(arch, B, S, capacity)
    rules = _mesh_rules_on(world, data)
    prefill = make_prefill_step(cfg, cache_len, rules=rules)
    step = make_serve_step(cfg, rules=rules)
    # the warm-up, its prefill under the census
    (tok, caches), c = take_census(prefill, model, {"tokens": prompts})
    census_prefill = {k: c.summary()[k] for k in (
        "collectives", "max_collective_bytes")}
    for i in range(2):
        tok, caches = step(model, {"tokens": tok, "caches": caches,
                                   "pos": S + i})
    del caches
    torch.cuda.synchronize()
    dist.barrier()
    with _LogitsTap() as tap:
        t0 = time.perf_counter()
        tok, caches = prefill(model, {"tokens": prompts})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for i in range(N - 1):
            tok, caches = step(model, {"tokens": tok, "caches": caches,
                                       "pos": S + i})
            out.append(tok)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
    tokens = torch.cat(out, 1)
    digests = torch.stack([r.view(torch.int32).sum(dtype=torch.int64)
                           for r in tap.rows]).tolist()
    r = {"tokens": tokens.cpu().tolist(), "digests": digests,
         "prefill_ms": t_prefill * 1e3,
         "decode_ms_per_step": t_decode / (N - 1) * 1e3,
         "cache_bytes": sum(t.numel() * t.element_size()
                            for _, t in tree_leaves(caches)),
         "ep_prefill": cfg.family == "moe" and ep_applicable(cfg, rules, B, S),
         "ep_decode": cfg.family == "moe" and ep_applicable(cfg, rules, B, 1),
         "census_prefill": census_prefill}
    _, c = take_census(step, model, {"tokens": tok, "caches": caches,
                                     "pos": S + N - 1})
    r["census_decode"] = {k: c.summary()[k] for k in (
        "collectives", "max_collective_bytes", "syncs")}
    del caches
    if cfg.family == "moe":
        r["ep_vs_dense"] = _ep_vs_dense(model, rules, B, S)
    if rank == 0:
        if data != 1:
            raise ValueError("rank 0 compares its rows: data must be 1")
        one_prefill = make_prefill_step(cfg, cache_len)
        one_step = make_serve_step(cfg)
        with _LogitsTap() as one:
            _, c1 = one_prefill(model, {"tokens": prompts})
            for i in range(N - 1):
                _, c1 = one_step(model, {"tokens": tokens[:, i:i + 1],
                                         "caches": c1, "pos": S + i})
        r["one_cache_bytes"] = sum(t.numel() * t.element_size()
                                   for _, t in tree_leaves(c1))
        r["compare"] = _mesh_vs_one(tap.rows, one.rows, tokens)
    return r


def lm_mesh_ranks(rank, world, data):
    """One gloo rank of phase 3h: every configuration of ``LM_MESH`` in
    turn (one world for both, so the ranks start once)."""
    import torch

    out = {}
    for arch, (B, S, N, cache_len, capacity) in LM_MESH.items():
        t0 = time.perf_counter()
        out[arch] = lm_mesh_rank(rank, world, data, arch, B, S, N, cache_len,
                                 capacity)
        torch.cuda.empty_cache()
        out[arch]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train"] = lm_mesh_train_rank(rank, world)        # phase 3i
    out["train_seconds"] = time.perf_counter() - t0
    return out


def lm_mesh_nccl_rank(rank, world, arch, B, S, capacity):
    """Phase 3h (c): one NCCL rank, mesh (1, 1), the MoE prefill (expert
    parallelism over NCCL's ``all_to_all_single``) against the
    single-device prefill."""
    import torch

    from repro_torch.analysis.census import take_census
    from repro_torch.models.moe_ep import ep_applicable
    from repro_torch.train.step import make_prefill_step

    cfg, model, prompts = _lm_mesh_setup(arch, B, S, capacity)
    rules = _mesh_rules_on(world, 1)
    prefill = make_prefill_step(cfg, S + 1, rules=rules)
    prefill(model, {"tokens": prompts})                   # warm-up
    _, c = take_census(prefill, model, {"tokens": prompts})
    with _LogitsTap() as tap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, _ = prefill(model, {"tokens": prompts})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        make_prefill_step(cfg, S + 1)(model, {"tokens": prompts})
    r = {"ep": ep_applicable(cfg, rules, B, S),
         "ep_vs_dense": _ep_vs_dense(model, rules, B, S),
         "collectives": c.summary()["collectives"],
         "prefill_ms": t_prefill * 1e3,
         "compare": _mesh_vs_one(tap.rows[:1], tap.rows[1:], tok)}
    del model
    torch.cuda.empty_cache()
    r["train"] = lm_mesh_train_nccl(world)                 # phase 3i
    return r


def phase_lm_mesh() -> dict:
    """Phase 3h: LM serving on a mesh, gated against the single-device
    path; returns each configuration's per-rank report."""
    from repro_torch.core.distributed import spawn_local

    store = ROOT / "build" / "lm_mesh"
    store.mkdir(parents=True, exist_ok=True)
    data, model_axis = LM_MESH_SHAPE
    world = data * model_axis
    card = card_line()
    out = {}
    t0 = time.perf_counter()
    worlds = spawn_local(lm_mesh_ranks, world, store_dir=store,
                         backend="gloo", timeout=1000, args=(data,))
    log(f"  {world} gloo ranks on cuda:0, both configurations and phase "
        f"3i: {time.perf_counter() - t0:.1f} s with the ranks' start (3i "
        f"{worlds[0]['train_seconds']:.1f} s of it)")
    for arch, (B, S, N, cache_len, capacity) in LM_MESH.items():
        ranks = [w[arch] for w in worlds]
        r0 = ranks[0]
        for q, r in enumerate(ranks):
            if r["tokens"] != r0["tokens"] or r["digests"] != r0["digests"]:
                raise AssertionError(f"{arch}: rank {q}'s tokens or logits "
                                     f"differ from rank 0's")
        cmp = r0["compare"]
        cap = "" if capacity is None else f", capacity {capacity}"
        log(f"  {arch} on ({data}, {model_axis}) gloo ranks, B {B} x prompt "
            f"{S}, {N} tokens, cache {cache_len}{cap}: every rank's tokens "
            f"and logits bit for bit rank 0's; against the single-device "
            f"path (fed the mesh's tokens) every step within the band, worst "
            f"{cmp['worst_of_band']:.4f} of it; ties (step, row) "
            f"{cmp['ties']}")
        if r0["ep_prefill"] or r0["ep_decode"]:
            if not r0["ep_prefill"] or r0["ep_decode"]:
                raise AssertionError(f"{arch}: expert parallelism should run "
                                     f"in prefill and not in decode")
            gaps = [r["ep_vs_dense"] for r in ranks]
            if any(gaps):
                raise AssertionError(f"{arch}: expert parallelism differs "
                                     f"from the dense MoE by {gaps}")
            a2a = {q: r["census_prefill"]["collectives"].get(
                "alltoall_base_", 0) for q, r in enumerate(ranks)}
            log(f"    prefill: expert parallelism (all_to_all_single per "
                f"rank {json.dumps(a2a)}; census "
                f"{json.dumps(r0['census_prefill'])}); its first layer on "
                f"a seeded ({B}, {S}) input bit for bit the dense MoE's on "
                f"every rank; decode (S = 1): the dense MoE")
        for q, r in enumerate(ranks):
            log(f"    rank {q}: prefill {r['prefill_ms']:.2f} ms, decode "
                f"{r['decode_ms_per_step']:.2f} ms/step, cache "
                f"{r['cache_bytes']} B (single device "
                f"{r0['one_cache_bytes']} B), a decode step's census "
                f"{json.dumps(r['census_decode'])}; card: {card}")
        log(f"    {r0['seconds']:.1f} s on rank 0 with the model's init")
        out[arch] = ranks
    arch = "granite-moe-3b-a800m"
    B, S, _, _, capacity = LM_MESH[arch]
    t0 = time.perf_counter()
    (r,) = spawn_local(lm_mesh_nccl_rank, 1, store_dir=store, backend="nccl",
                       args=(arch, B, S, capacity), timeout=600)
    a2a = r["collectives"].get("alltoall_base_", 0)
    if not r["ep"] or not a2a or r["ep_vs_dense"]:
        raise AssertionError(f"NCCL rank: expert parallelism {r['ep']}, "
                             f"collectives {r['collectives']}, against the "
                             f"dense MoE {r['ep_vs_dense']}")
    log(f"  1 NCCL rank, mesh (1, 1): {arch} prefill {B} x {S} through "
        f"expert parallelism ({a2a} all_to_all_single on NCCL; census "
        f"{json.dumps(r['collectives'])}; its first layer bit for bit the "
        f"dense MoE's), logits within the band of the "
        f"single-device prefill (worst {r['compare']['worst_of_band']:.4f} "
        f"of it, ties {r['compare']['ties']}); prefill "
        f"{r['prefill_ms']:.2f} ms; {time.perf_counter() - t0:.1f} s with "
        f"its start; card: {card}")
    out["nccl"] = r
    out["gain_eval_launches"] = report_lm_mesh_train(worlds, r["train"])
    return out


#: Phase 3i, LM training on a mesh, run inside phase 3h's world: a second
#: ``DeviceMesh`` of ``LM_MESH_TRAIN_SHAPE`` (data, model) over the same
#: four gloo ranks on cuda:0, every rank holding its blocks of the params,
#: master and moments. Gate 1: these configurations at ``LM_CUT`` and full
#: width in fp32 (granite at capacity 8.0, which drops nothing), B × S of
#: ``LM_MESH_TRAIN_BATCH``, two steps after two warm ones on the compared
#: batches' tokens shuffled (gate 1 of 3g: a row with no gradient history
#: moves by lr·sign(g)), with a clip that binds (``LM_MESH_TRAIN_OPT``).
LM_MESH_TRAIN_GATE1 = ("qwen3-0.6b", "granite-moe-3b-a800m")
LM_MESH_TRAIN_SHAPE = (2, 2)
LM_MESH_TRAIN_BATCH = (8, 64)
LM_MESH_TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10,
                         grad_clip=0.1)
#: Gate 2: qwen3-0.6b at ``LM_CUT`` in bf16, B × S = 8 × 512, three steps
#: from one curated window of 256 rows (64 kept, ``gain_eval`` on the
#: ``cuda`` backend); the losses against the single-device path's within
#: the bf16 policy's 5e-2 relative (``POLICY_TOLS``).
LM_MESH_TRAIN_GATE2 = dict(arch="qwen3-0.6b", B=8, S=512, steps=3,
                           window=256, select=64)
LM_MESH_TRAIN_BF16_REL = 5e-2
#: Gate 1's grad norm against the single-device step's: 1e-5 relative
#: (the norm adds each leaf's squares in one reduction on either side; the
#: mesh's blocks in rank order).
LM_MESH_TRAIN_NORM_REL = 1e-5


def _mesh_train_cfg(arch, dtype):
    from repro_torch.configs import get_config, replace

    cfg = replace(get_config(arch), **LM_CUT[arch], dtype=dtype)
    return replace(cfg, moe_capacity=8.0) if cfg.family == "moe" else cfg


def _replicated_bits(state) -> list:
    """A digest of every replicated leaf's bits (params, master, m, v)."""
    import hashlib

    import torch

    plan = state["params"].placement
    h = hashlib.sha256()
    with torch.no_grad():
        for n, p in state["params"].named_parameters():
            if all(phys is None for phys in plan.specs[n]):
                for t in [p] + [state["opt"][k][n] for k in ("master", "m",
                                                              "v")]:
                    h.update(t.detach().cpu().contiguous().view(
                        torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _state_bytes(state) -> int:
    o = state["opt"]
    return sum(p.numel() * p.element_size()
               for p in state["params"].parameters()) + sum(
        t.numel() * 4 for k in ("master", "m", "v") for t in o[k].values())


class _NoDataSum:
    """Planted fault: the backward keeps each data shard's own gradient
    (the data-parallel sum left out)."""

    def __enter__(self):
        from repro_torch.distributed import parallel

        self.P, self.real = parallel, parallel._data_reduce
        parallel._data_reduce = lambda sh, g, dim: (
            g if dim is None else g.chunk(sh.p, dim)[sh.index].contiguous())
        return self

    def __exit__(self, *exc):
        self.P._data_reduce = self.real


class _NormPerRank:
    """Planted fault: every rank counts every leaf in the clip norm (a
    replicated leaf once per rank)."""

    def __enter__(self):
        from repro_torch.train import step as St

        self.St, self.real = St, St._first_replica
        St._first_replica = lambda rules, spec: True
        return self

    def __exit__(self, *exc):
        self.St._first_replica = self.real


def _mesh_train_gate1(rank, world, rules, arch, store) -> dict:
    """Gate 1 on one configuration: two warm mesh steps; for qwen3 the two
    planted faults, one step each on a copy of the warm blocks (the grad
    norm against the single-device step's); the warm state gathered to
    rank 0, which replays the next two steps on one device and in float64
    from it; the two mesh steps (the first timed, the second under the
    census), gathered to rank 0 and held to its replays. For qwen3 also the elastic
    restore: the state saved after the two steps, a third step on (2, 2)
    (its batch the first's tokens shuffled anew, so every row it touches
    has a history), and the same step restored on (1, 4). ``t`` holds each
    part's seconds."""
    import copy

    import torch
    import torch.distributed as dist

    from repro_torch.analysis.census import take_census
    from repro_torch.train import step as St
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptimizerConfig

    cfg = _mesh_train_cfg(arch, "float32")
    opt = OptimizerConfig(**LM_MESH_TRAIN_OPT)
    B, S = LM_MESH_TRAIN_BATCH
    gen = torch.Generator().manual_seed(3)
    batches = [_train_batch(cfg, B, S, gen, "cuda") for _ in range(2)]

    def shuffled(b):
        toks = torch.cat([b["tokens"], b["labels"][:, -1:]], 1)
        perm = torch.randperm(toks.numel(), generator=gen).to("cuda")
        w = toks.flatten()[perm].view_as(toks)
        return {"tokens": w[:, :S], "labels": w[:, 1:]}

    warm = [shuffled(b) for b in batches]
    batches.append(shuffled(batches[0]))
    lead = int(rules.mesh.mesh.flatten()[0])
    t, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    state = St.init_train_state(cfg, 0, "cuda", rules=rules)
    step = St.make_train_step(cfg, opt, rules=rules)
    lap("init")
    for b in warm:
        state, _ = step(state, b)
    lap("warm steps")
    r = {"faults": {}}
    if arch == "qwen3-0.6b":
        for name, plant in (("no data sum", _NoDataSum),
                            ("norm per rank", _NormPerRank)):
            placed = copy.deepcopy(state)
            with plant():
                _, mf = step(placed, batches[0])
            r["faults"][name] = float(mf["grad_norm"])
            del placed
        lap("planted faults")
    whole = St.gather_train_state(state, dst=lead, device="cuda")
    lap("gather")
    if whole is not None:
        r["whole_bytes"] = _state_bytes(whole)
        ref = _one_device_steps(cfg, opt, whole, batches[:2])
        r.update({k: ref.pop(k) for k in ("one_losses", "one_norms")})
        del whole
    lap("one device and float64")
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    lap("barrier")
    state, m1 = step(state, batches[0])
    lap("step")
    (state, m2), c = take_census(step, state, batches[1])
    lap("step under the census")
    s = c.summary()
    r.update({"ms_per_step": t["step"] * 1e3,
              "peak_bytes": torch.cuda.max_memory_allocated(),
              "losses": [float(m1["loss"]), float(m2["loss"])],
              "norms": [float(m1["grad_norm"]), float(m2["grad_norm"])],
              "state_bytes": _state_bytes(state),
              "replicated": _replicated_bits(state),
              "census": {k: s[k] for k in ("collectives",
                                           "max_collective_bytes")}})
    got = St.gather_train_state(state, dst=lead, device="cuda")
    if got is not None:
        one, wide = ref["second"], ref["wide"]
        r["gaps"] = {"one": _leaf_gaps(got, one),
                     "f64": _leaf_gaps(got, wide),
                     "one_f64": _leaf_gaps(one, wide)}
        del one, wide, got, ref
    lap("gather and compare")
    if arch == "qwen3-0.6b":
        ckpt = CheckpointManager(store / "ckpt", async_write=False)
        ckpt.save(4, state)
        lap("save")
        state, m3 = step(state, batches[2])
        third = St.gather_train_state(state, dst=lead, device="cuda")
        lap("third step")
        rules14 = _mesh_rules_on(world, 1)
        back, _ = ckpt.restore(state, step=4, device="cuda",
                               shardings=rules14)
        del state
        lap("restore on (1, 4)")
        back, m14 = St.make_train_step(cfg, opt, rules=rules14)(
            back, batches[2])
        r["elastic"] = {"loss": float(m3["loss"]),
                        "loss_14": float(m14["loss"])}
        restored = St.gather_train_state(back, dst=lead, device="cuda")
        if restored is not None:
            r["elastic"]["gap"] = _state_gap(restored, third)
        del back, third, restored
        lap("step on (1, 4)")
    else:
        del state
    torch.cuda.empty_cache()
    dist.barrier()
    lap("end barrier")
    r["t"] = t
    r["seconds"] = sum(t.values())
    return r


class _deterministic:
    """``torch.use_deterministic_algorithms(True)`` for a block (cuBLAS's
    workspace set as it requires), both restored after."""

    def __enter__(self):
        import os

        import torch

        self.prev = torch.are_deterministic_algorithms_enabled()
        self.prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        return self

    def __exit__(self, *exc):
        import os

        import torch

        torch.use_deterministic_algorithms(self.prev)
        if self.prev_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def _one_device_steps(cfg, opt, whole, batches) -> dict:
    """Rank 0: the steps on one device from the gathered warm state, and
    again in float64 (the optimizer's state stays fp32); the losses and
    norms, and both states after the last step, on the card."""
    import torch

    from repro_torch.configs import replace
    from repro_torch.train.step import make_train_step

    wide_cfg = replace(cfg, dtype="float64")
    out = {"one_losses": [], "one_norms": [], "wide_cfg": wide_cfg}
    for key, c in (("second", cfg), ("wide", wide_cfg)):
        st = _state_on(c, whole, "cuda")
        step = make_train_step(c, opt)
        for b in batches:
            st, m = step(st, b)
            if c is cfg:
                out["one_losses"].append(float(m["loss"]))
                out["one_norms"].append(float(m["grad_norm"]))
        out[key] = st
    return out


def _mesh_train_gate2(rank, rules) -> dict:
    """Gate 2: bf16 qwen3 on three batches of one curated window; every
    rank curates the window on the card (its picks and ``gain_eval``
    launches reported); rank 0 replays the steps on one device."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import EvalConfig
    from repro_torch.data.pipeline import CurationConfig, token_batches
    from repro_torch.kernels import ops
    from repro_torch.train import step as St
    from repro_torch.train.optimizer import OptimizerConfig

    g = LM_MESH_TRAIN_GATE2
    cfg = _mesh_train_cfg(g["arch"], "bfloat16")
    opt = OptimizerConfig(**LM_MESH_TRAIN_OPT)
    t, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    ops.LAUNCHES.clear()
    with _CurationTap() as tap:
        batches = list(token_batches(
            cfg.vocab_size, g["B"], g["S"], g["steps"], seed=7,
            curation=CurationConfig(window=g["window"], select=g["select"]),
            eval_cfg=EvalConfig(backend="cuda"), device="cuda"))
    launches = ops.LAUNCHES.get("gain_eval", 0)
    picks = [list(map(int, w["indices"])) for w in tap.windows]
    lap("curation")
    state = St.init_train_state(cfg, 0, "cuda", rules=rules)
    step = St.make_train_step(cfg, opt, rules=rules)
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    lap("init")
    losses, times = [], []
    for b in batches:
        t1 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t1) * 1e3)
    lap("steps")
    r = {"losses": losses, "ms_per_step": times,
         "peak_bytes": torch.cuda.max_memory_allocated(),
         "picks": picks, "windows": len(picks), "gain_eval": launches,
         "state_bytes": _state_bytes(state)}
    del state
    torch.cuda.empty_cache()
    if rank == 0:
        one = St.init_train_state(cfg, 0, "cuda")
        r["whole_bytes"] = _state_bytes(one)
        step1 = St.make_train_step(cfg, opt)
        r["one_losses"] = []
        for b in batches:
            one, m = step1(one, b)
            r["one_losses"].append(float(m["loss"]))
        del one
        torch.cuda.empty_cache()
    lap("one device")
    dist.barrier()
    lap("end barrier")
    r["t"] = t
    r["seconds"] = sum(t.values())
    return r


def lm_mesh_train_rank(rank, world) -> dict:
    """Phase 3i on one gloo rank of 3h's world: a (2, 2) mesh over the
    same ranks, gates 1 and 2 (the elastic restore within gate 1)."""
    import torch

    data, _ = LM_MESH_TRAIN_SHAPE
    rules = _mesh_rules_on(world, data)
    store = ROOT / "build" / "lm_mesh"
    out = {}
    for arch in LM_MESH_TRAIN_GATE1:
        out[arch] = _mesh_train_gate1(rank, world, rules, arch, store)
        torch.cuda.empty_cache()
    out["gate2"] = _mesh_train_gate2(rank, rules)
    return out


def lm_mesh_train_nccl(world) -> dict:
    """Phase 3i on 3h's NCCL rank: ``train(mesh=(1, 1))`` two fp32 steps
    against ``train(mesh=None)``, bit for bit (deterministic algorithms, as
    3g's crash-resume gate)."""
    import torch

    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import gather_train_state
    from repro_torch.train.trainer import TrainConfig, train

    arch = LM_MESH_TRAIN_GATE1[0]
    cfg = _mesh_train_cfg(arch, "float32")
    opt = OptimizerConfig(**LM_MESH_TRAIN_OPT)
    B, S = LM_MESH_TRAIN_BATCH
    gen = torch.Generator().manual_seed(3)
    batches = [_train_batch(cfg, B, S, gen, "cuda") for _ in range(2)]
    with _deterministic():
        rules = _mesh_rules_on(world, 1)
        t0 = time.perf_counter()
        s_mesh, h_mesh = train(cfg, TrainConfig(steps=2, log_every=1), opt,
                               iter(batches), mesh=rules.mesh, device="cuda")
        t_mesh = time.perf_counter() - t0
        s_mesh = gather_train_state(s_mesh, device="cuda")
        s_one, h_one = train(cfg, TrainConfig(steps=2, log_every=1), opt,
                             iter(batches), device="cuda")
    same = all(torch.equal(a, b) for a, b in zip(
        s_mesh["params"].parameters(), s_one["params"].parameters()))
    for k in ("master", "m", "v"):
        same &= all(torch.equal(s_mesh["opt"][k][n], t)
                    for n, t in s_one["opt"][k].items())
    return {"same": same, "losses": [h["loss"] for h in h_mesh],
            "one_losses": [h["loss"] for h in h_one],
            "seconds": t_mesh}


def lm_mesh_train_ranks(rank, world):
    """Phase 3i alone on one gloo rank (see :func:`phase_lm_mesh_train`)."""
    import torch

    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    out = {"train": lm_mesh_train_rank(rank, world)}
    out["train_seconds"] = time.perf_counter() - t0
    return out


def lm_mesh_train_nccl_rank(rank, world):
    import torch

    torch.cuda.set_device(0)
    return {"train": lm_mesh_train_nccl(world)}


def phase_lm_mesh_train() -> list:
    """Phase 3i alone, in a world of its own (the whole script runs it
    inside phase 3h's, :func:`phase_lm_mesh`); returns ``gain_eval``'s
    launches per rank."""
    from repro_torch.core.distributed import spawn_local

    store = ROOT / "build" / "lm_mesh"
    store.mkdir(parents=True, exist_ok=True)
    world = LM_MESH_SHAPE[0] * LM_MESH_SHAPE[1]
    t0 = time.perf_counter()
    worlds = spawn_local(lm_mesh_train_ranks, world, store_dir=store,
                         backend="gloo", timeout=900)
    log(f"  {world} gloo ranks on cuda:0, phase 3i: "
        f"{time.perf_counter() - t0:.1f} s with the ranks' start")
    (r,) = spawn_local(lm_mesh_train_nccl_rank, 1, store_dir=store,
                       backend="nccl", timeout=600)
    return report_lm_mesh_train(worlds, r["train"])


def report_lm_mesh_train(worlds, nccl) -> list:
    """Phase 3i's report and gates on every rank's results: logs every
    line first, then raises naming each gate that failed. Returns
    ``gain_eval``'s launches per rank."""
    import math

    card = card_line()
    ranks = [w["train"] for w in worlds]
    band, nband = LM_TRAIN_CARD_CPU_REL, LM_MESH_TRAIN_NORM_REL
    B, S = LM_MESH_TRAIN_BATCH
    failed = []

    def gate(ok, what):
        if not ok:
            failed.append(what)

    def rel(a, b):
        return abs(a - b) / abs(b)

    for arch in LM_MESH_TRAIN_GATE1:
        rs = [r[arch] for r in ranks]
        r0 = rs[0]
        g = r0["gaps"]
        err, leaf = max((e, lf) for lf, e in g["one"].items())
        # a leaf out of the band must be no farther from the float64
        # replay than the single-device step is, plus the band
        beyond = {lf: (e, g["f64"][lf], g["one_f64"][lf])
                  for lf, e in g["one"].items() if e > band}
        log(f"  [3i] {arch} (LM_CUT, fp32) on {LM_MESH_TRAIN_SHAPE} gloo "
            f"ranks, B {B} x {S}, 2 steps after 2 warm: losses "
            f"{r0['losses']} (single device {r0['one_losses']}), grad norms "
            f"{r0['norms']} (single device {r0['one_norms']}, clip "
            f"{LM_MESH_TRAIN_OPT['grad_clip']}); params, master, m, v worst "
            f"{leaf} {err:.3e} = {err / band:.3f} of the band; against the "
            f"float64 replay: mesh {max(g['f64'].values()) / band:.3f}, "
            f"single device {max(g['one_f64'].values()) / band:.3f} of it")
        for lf, (e, ef, eo) in beyond.items():
            log(f"    {lf}: {e / band:.3f} of the band from the single "
                f"device; from the float64 replay the mesh "
                f"{ef / band:.3f}, the single device {eo / band:.3f}")
            gate(ef <= eo + band, f"{arch}: {lf} out of the band and "
                                  f"farther from the float64 replay than "
                                  f"the single device")
        for q, r in enumerate(rs):
            gate(r["losses"] == r0["losses"]
                 and r["replicated"] == r0["replicated"],
                 f"{arch}: rank {q}'s losses or replicated leaves differ "
                 f"from rank 0's")
        gate(all(rel(a, b) <= band for a, b in zip(r0["losses"],
                                                    r0["one_losses"])),
             f"{arch}: losses out of the band")
        gate(all(rel(a, b) <= nband for a, b in zip(r0["norms"],
                                                     r0["one_norms"])),
             f"{arch}: grad norms out of {nband}")
        gate(min(r0["one_norms"]) > LM_MESH_TRAIN_OPT["grad_clip"],
             f"{arch}: the clip does not bind")
        for name, norm in r0["faults"].items():
            nerr = rel(norm, r0["one_norms"][0])
            log(f"    planted {name}: grad norm {norm:.6f} against "
                f"{r0['one_norms'][0]:.6f}, {nerr / nband:.1f}x the norm "
                f"band ({nerr / band:.1f}x gate 1's)")
            gate(nerr > band, f"{arch}: the bands miss the planted {name}")
        if "elastic" in r0:
            e = r0["elastic"]
            eerr, eleaf = e["gap"]
            log(f"    elastic: saved on (2, 2) after the two steps, "
                f"restored on (1, 4): its next step worst {eleaf} "
                f"{eerr:.3e} = {eerr / band:.3f} of the band (loss "
                f"{e['loss_14']:.6f} vs {e['loss']:.6f})")
            gate(eerr <= band and rel(e["loss_14"], e["loss"]) <= band,
                 f"{arch}: the step restored on (1, 4) is out of the band")
        if "moe" in arch:
            a2a = [r["census"]["collectives"].get("alltoall_base_", 0)
                   for r in rs]
            gate(all(a2a), f"{arch}: all_to_all_single missing on a rank")
        for q, r in enumerate(rs):
            log(f"    rank {q}: {r['ms_per_step']:.1f} ms/step, state "
                f"{r['state_bytes']} B of the whole {r0['whole_bytes']} B, "
                f"peak {r['peak_bytes'] / 1e9:.2f} GB, a step's census "
                f"{json.dumps(r['census'])}; {r['seconds']:.1f} s "
                f"{json.dumps({k: round(v, 1) for k, v in r['t'].items()})};"
                f" card: {card}")
    g = [r["gate2"] for r in ranks]
    g0 = g[0]
    c = LM_MESH_TRAIN_GATE2
    log(f"  [3i] gate 2: {c['arch']} (LM_CUT, bf16), {c['B']} x {c['S']}, "
        f"{c['steps']} steps from one curated window of {c['window']} "
        f"(gain_eval on the card): losses {g0['losses']} (single device "
        f"{g0['one_losses']}, band {LM_MESH_TRAIN_BF16_REL} relative)")
    for q, r in enumerate(g):
        log(f"    rank {q}: {json.dumps([round(x, 1) for x in r['ms_per_step']])}"
            f" ms/step, state {r['state_bytes']} B of the whole "
            f"{g0['whole_bytes']} B, peak {r['peak_bytes'] / 1e9:.2f} GB, "
            f"gain_eval launches {r['gain_eval']}; {r['seconds']:.1f} s "
            f"{json.dumps({k: round(v, 1) for k, v in r['t'].items()})}; "
            f"card: {card}")
        gate(r["picks"] == g0["picks"] and r["losses"] == g0["losses"],
             f"gate 2: rank {q}'s picks or losses differ from rank 0's")
        gate(r["windows"] == 1 and r["gain_eval"] > 0,
             f"gate 2: rank {q}: {r['windows']} windows, {r['gain_eval']} "
             f"gain_eval launches")
    gate(all(math.isfinite(a) and rel(a, b) <= LM_MESH_TRAIN_BF16_REL
             for a, b in zip(g0["losses"], g0["one_losses"])),
         "gate 2: losses out of the bf16 band")
    log(f"  [3i] 1 NCCL rank: train(mesh=(1, 1)) 2 fp32 steps, losses "
        f"{nccl['losses']} (train(mesh=None) {nccl['one_losses']}), the "
        f"state bit for bit: {nccl['same']}; {nccl['seconds']:.1f} s; card: "
        f"{card}")
    gate(nccl["same"] and nccl["losses"] == nccl["one_losses"],
         "NCCL: train(mesh=(1, 1)) differs from train(mesh=None)")
    if failed:
        raise AssertionError("phase 3i: " + "; ".join(failed))
    return [r["gain_eval"] for r in g]


#: Phase 3g, LM training with curation. Gate 1 (card = CPU port, fp32 at
#: ``LM_CUT``): these three configurations, dense, MoE routing with its
#: drops, and recurrence; the batch of each step (B, S).
LM_TRAIN_GATE1 = ("qwen3-0.6b", "granite-moe-3b-a800m", "xlstm-1.3b")
LM_TRAIN_GATE_BATCH = (2, 40)
#: Gate 3: qwen3-0.6b uncut in bf16, ``token_batches(vocab, B, S,
#: steps, curation=CurationConfig(window, select))`` on the ``cuda``
#: backend: 3 windows of 256 × 512 tokens, 64 kept from each, 8 batches of
#: 8 × 512 per window.
LM_TRAIN_FULL = dict(arch="qwen3-0.6b", B=8, S=512, steps=24, window=256,
                     select=64, lr=1e-3, warmup=4)
#: Gate 1's band, card against the CPU port: the loss, the grad norm and
#: every leaf of the updated params, master, m and v within 1e-4 of the
#: CPU side's max |value|, the serving gate's band (``LM_CARD_CPU_REL``).
#: Both sides start from the same state after two warm steps on the
#: compared batch's tokens, shuffled: AdamW divides each element's step by
#: its own gradient history, so an element with no history and a
#: near-cancelling gradient moves by about lr·sign(g), which fp32 leaves
#: undecided on either side. At the full vocabulary that is every row a
#: step sees first: after warm steps on other tokens, the qwen3 cut's
#: embedding master parted at such rows, each side as far from a float64
#: replay as from the other. The shuffled tokens give every row the step
#: touches a history in other contexts. Card and CPU add
#: the same fp32 products in their own orders (cuBLAS against the CPU's
#: BLAS, TF32 off) through the backward of two to eight layers; on the
#: H100 their gradients were within 1.9e-5 of each other and of a float64
#: replay, leaf by leaf, at these cuts. m and v carry the step's gradient
#: linearly (v: its square) and the clip scale, so they hold the grad norm
#: too: the CPU's ``_foreach_norm`` left it 3e-5 (qwen3) and 2.6e-4
#: (xlstm) low at these widths, which this gate caught.
LM_TRAIN_CARD_CPU_REL = 1e-4
#: Gate 1's second band, on the card alone: its updated master (and so the
#: params, its cast) against its own update recomputed in float64 from its
#: new m and v, the old master and the step's lr (the reference's formula:
#: ``master − lr·(m̂ / (√v̂ + eps) + wd·master)``), within 1e-6 of the
#: leaf's max |value| (a few fp32 roundings of an update of at most a few
#: lr).
LM_TRAIN_UPDATE_REL = 1e-6
#: ``gain_eval`` against its plain version at the curation's shape
#: (n = m = 256, d = 64): within 1e-4 of the largest gain. The gains are
#: means over 256 rows of small relus (about 1.6e-5 at the first window),
#: while the Gram identity rounds each distance at eps·(‖v‖² + ‖c‖²),
#: about 5e-4 of the largest gain there, so phase 2's absolute band (1e-5
#: times at least 1) would pass a 1 % error and its relative ``MAIN_REL``
#: sits under the rounding; the 256 rows average it to 2.9e-5 (H100).
LM_GAIN_REL = 1e-4
#: Gate 2, ``microbatches=4`` against one batch: the reference's own bound
#: (``tests/test_data_and_trainer.py``), on loss and on every parameter.
LM_TRAIN_MICROBATCH_BOUND = 1e-4
#: The optimizer of gates 1–2 (warm-up 2, so the gates' third step is on
#: the cosine).
LM_TRAIN_GATE_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
def _train_batch(cfg, B, S, gen, device):
    import torch

    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         dtype=torch.int32).to(device)
    return {"tokens": toks[:, :S], "labels": toks[:, 1:]}


def _state_on(cfg, state, device):
    """A copy of a train state on ``device``; ``cfg`` may widen the model
    to float64 (the replay), the optimizer's state stays fp32."""
    import copy

    import torch

    model = copy.deepcopy(state["params"]).to(device)
    if cfg.dtype == "float64":
        model.double()
    elif cfg.dtype != model.cfg.dtype:
        raise ValueError(f"{model.cfg.dtype} -> {cfg.dtype}")
    model.cfg = cfg
    opt = {k: {n: t.to(device, copy=True) for n, t in state["opt"][k].items()}
           for k in ("master", "m", "v")}
    opt["step"] = state["opt"]["step"].to(device, copy=True)
    if not torch.equal(opt["step"].cpu(), state["opt"]["step"].cpu()):
        raise AssertionError("the step did not copy")
    return {"params": model, "opt": opt}


def _named(state, part) -> dict:
    """``{reference path: [tensor per layer]}`` of one part of a train
    state: ``params`` or an optimizer dict (``opt/m`` …)."""
    from repro_torch.convert import lm_ref_leaves

    if part == "params":
        return lm_ref_leaves(state["params"].named_parameters())
    return lm_ref_leaves(state["opt"][part.split("/")[1]].items())


def _state_gap(got, want, parts=("params", "opt/master", "opt/m",
                                  "opt/v")) -> tuple:
    """Largest max|got − want| / max|want| over the leaves under ``parts``
    of two train states (a leaf: a reference path, its layers together),
    computed in float64 on the card, and its leaf; the steps
    must be equal."""
    return max(((e, leaf) for leaf, e in _leaf_gaps(got, want,
                                                    parts).items()),
               default=(0.0, ""))


def _leaf_gaps(got, want, parts=("params", "opt/master", "opt/m",
                                 "opt/v")) -> dict:
    """``{leaf: max|got − want| / max|want|}`` as :func:`_state_gap`
    computes it."""
    import torch

    if int(got["opt"]["step"]) != int(want["opt"]["step"]):
        raise AssertionError(f"steps differ: {int(got['opt']['step'])} vs "
                             f"{int(want['opt']['step'])}")
    dev = "cuda"
    out = {}
    with torch.no_grad():
        for part in parts:
            g, w = _named(got, part), _named(want, part)
            for path, ts in w.items():
                err = scale = 0.0
                for a, b in zip(g[path], ts):
                    b = b.to(dev).double()
                    err = max(err, float((a.to(dev).double() - b).abs()
                                         .max()))
                    scale = max(scale, float(b.abs().max()))
                out[f"/{part}/{'/'.join(path)}"] = err / (scale or 1.0)
    return out


def _update_gap(state, master_before: dict, lr: float, step: int,
                opt) -> tuple:
    """Largest gap, over the leaves, between a state's new master and the
    reference's update recomputed in float64 from the state's own new m
    and v, ``master_before`` (the old master by parameter name), the
    step's fp32 lr and its step, relative to the leaf's max |value|; the
    params must be the master cast to their dtype, bit for bit."""
    import torch

    from repro_torch.convert import lm_ref_leaves

    bc1 = 1 - opt.b1 ** (step + 1)
    bc2 = 1 - opt.b2 ** (step + 1)
    o = state["opt"]
    params = dict(state["params"].named_parameters())
    gaps: dict = {}
    with torch.no_grad():
        for name, new in o["master"].items():
            par = params[name]
            if not torch.equal(par, new.to(par.dtype)):
                raise AssertionError(f"{name} is not its master's cast")
            m, v = o["m"][name].double(), o["v"][name].double()
            old = master_before[name].to(new.device).double()
            want = old - lr * ((m / bc1) / (torch.sqrt(v / bc2) + opt.eps)
                               + opt.weight_decay * old)
            gaps[name] = (float((new.double() - want).abs().max()),
                          float(want.abs().max()))
    worst = (0.0, "")
    for path, pairs in lm_ref_leaves(gaps.items()).items():
        err, scale = max(e for e, _ in pairs), max(sc for _, sc in pairs)
        worst = max(worst, (err / (scale or 1.0), "/" + "/".join(path)))
    return worst


class _NoBiasCorrection:
    """Gate 1's planted fault: ``adamw_update`` without the bias
    correction on one leaf (``embed.w``): its master and parameter take
    ``m / (√v + eps)`` where the update takes ``m̂ / (√v̂ + eps)``."""

    def __init__(self, leaf="embed.w"):
        self.leaf = leaf

    def __enter__(self):
        import torch

        from repro_torch.train import step as St

        self.St, self.real = St, St.adamw_update
        real, leaf = self.real, self.leaf

        def faulty(cfg, grads, opt_state, params):
            i = list(opt_state["master"]).index(leaf)
            master0 = opt_state["master"][leaf].clone()
            m0, v0 = opt_state["m"][leaf].clone(), opt_state["v"][leaf].clone()
            out = real(cfg, grads, opt_state, params)
            lr, gnorm = out[1]["lr"], out[1]["grad_norm"]
            with torch.no_grad():
                scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
                g = grads[i].float() * scale
                m = cfg.b1 * m0 + (1 - cfg.b1) * g
                v = cfg.b2 * v0 + (1 - cfg.b2) * g * g
                new = master0 - lr * (m / (torch.sqrt(v) + cfg.eps)
                                      + cfg.weight_decay * master0)
                opt_state["master"][leaf].copy_(new)
                params[i].copy_(new)
            return out

        St.adamw_update = faulty
        return self

    def __exit__(self, *exc):
        self.St.adamw_update = self.real


def lm_train_gate_card_vs_cpu(cut) -> str:
    """Gate 1: one fp32 train step on the card and on the CPU from the same
    state (after two warm steps on the card on the batch's tokens,
    shuffled; see ``LM_TRAIN_CARD_CPU_REL``) and batch: loss, grad norm, lr
    and every leaf of the updated params, master, m and v within
    ``LM_TRAIN_CARD_CPU_REL`` of the CPU's; the card's master also within
    ``LM_TRAIN_UPDATE_REL`` of the update recomputed in float64 from its
    own m and v, its params the master's cast. A planted update without
    bias correction on one leaf must exceed both bands. Reported: each
    side's state against the step replayed in float64 on the card."""
    import torch

    from repro_torch.configs import replace
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import init_train_state, make_train_step

    B, S = LM_TRAIN_GATE_BATCH
    opt = OptimizerConfig(**LM_TRAIN_GATE_OPT)
    step = make_train_step(cut, opt)
    gen = torch.Generator().manual_seed(3)
    batch = _train_batch(cut, B, S, gen, "cpu")
    toks = torch.cat([batch["tokens"], batch["labels"][:, -1:]], 1)
    warm = init_train_state(cut, 0, device="cuda")
    for _ in range(2):
        w = toks.flatten()[torch.randperm(toks.numel(), generator=gen)]
        w = w.view_as(toks).to("cuda")
        step(warm, {"tokens": w[:, :S], "labels": w[:, 1:]})
    at = int(warm["opt"]["step"])
    cpu = _state_on(cut, warm, "cpu")
    card, faulty = _state_on(cut, warm, "cuda"), _state_on(cut, warm, "cuda")
    wide_cfg = replace(cut, dtype="float64")
    wide = _state_on(wide_cfg, warm, "cuda")
    del warm
    master_before = {n: t.clone() for n, t in card["opt"]["master"].items()}
    t0 = time.perf_counter()
    _, m_cpu = step(cpu, batch)
    t_cpu = time.perf_counter() - t0
    on_card = {k: v.to("cuda") for k, v in batch.items()}
    _, m_card = step(card, on_card)
    torch.cuda.synchronize()
    with _NoBiasCorrection():
        _, m_faulty = step(faulty, on_card)
    _, m_wide = make_train_step(wide_cfg, opt)(wide, on_card)
    band, ubound = LM_TRAIN_CARD_CPU_REL, LM_TRAIN_UPDATE_REL
    for key in ("loss", "grad_norm", "lr"):
        a, b = float(m_card[key]), float(m_cpu[key])
        if not abs(a - b) <= band * abs(b):
            raise AssertionError(f"{cut.name}: card {key} {a!r} vs CPU "
                                 f"{b!r} > {band} relative")
    err, leaf = _state_gap(card, cpu)
    if not err <= band:
        raise AssertionError(f"{cut.name}: card state {err:.3e} from the "
                             f"CPU port's at {leaf} > {band}")
    caught, fleaf = _state_gap(faulty, cpu)
    if not caught > band:
        raise AssertionError(f"{cut.name}: the band {band} misses an update "
                             f"without bias correction ({caught:.3e})")
    lr = float(m_card["lr"])
    uerr, uleaf = _update_gap(card, master_before, lr, at, opt)
    if not uerr <= ubound:
        raise AssertionError(f"{cut.name}: card master {uerr:.3e} from its "
                             f"update recomputed in float64 at {uleaf} > "
                             f"{ubound}")
    ucaught, _ = _update_gap(faulty, master_before,
                             float(m_faulty["lr"]), at, opt)
    if not ucaught > ubound:
        raise AssertionError(f"{cut.name}: the band {ubound} misses an update"
                             f" without bias correction ({ucaught:.3e})")
    e_card, _ = _state_gap(card, wide)
    e_cpu, _ = _state_gap(cpu, wide)
    return (f"loss {float(m_card['loss']):.6f} (CPU "
            f"{float(m_cpu['loss']):.6f}, float64 on the card "
            f"{float(m_wide['loss']):.6f}), grad norm "
            f"{float(m_card['grad_norm']):.6f}; params, master, m, v: worst "
            f"{leaf} {err:.3e} = {err / band:.3f} of the band (against the "
            f"float64 replay: card {e_card / band:.3f}, CPU "
            f"{e_cpu / band:.3f} of it; planted update without bias "
            f"correction: {caught / band:.0f}x at {fleaf}); master against "
            f"its float64 update: worst {uleaf} {uerr:.3e} = "
            f"{uerr / ubound:.3f} of {ubound} (planted: "
            f"{ucaught / ubound:.0f}x); CPU step {t_cpu:.1f} s")


def lm_train_gate_equivalences(cut) -> str:
    """Gate 2 on the card: ``microbatches=4`` = 1 within the reference's
    1e-4, ``remat`` on = off bit for bit, and crash-resume (4 steps with a
    checkpoint at 2 and a resume) = 4 straight steps bit for bit, under
    ``torch.use_deterministic_algorithms(True)``; a resume that leaves m and
    v at zero must differ."""
    import shutil

    import torch

    from repro_torch.data.pipeline import token_batches
    from repro_torch.train import checkpoint as C
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.train.trainer import TrainConfig, train

    opt = OptimizerConfig(**LM_TRAIN_GATE_OPT)
    gen = torch.Generator().manual_seed(4)
    parts = []
    # microbatches: from the state after two steps (as gate 1)
    dev = "cuda"
    base = init_train_state(cut, 0, device=dev)
    step = make_train_step(cut, opt)
    for _ in range(2):
        step(base, _train_batch(cut, 8, 40, gen, dev))
    batch = _train_batch(cut, 8, 40, gen, dev)
    one, four = _state_on(cut, base, dev), _state_on(cut, base, dev)
    _, m1 = step(one, batch)
    _, m4 = make_train_step(cut, opt, microbatches=4)(four, batch)
    dl = abs(float(m1["loss"]) - float(m4["loss"]))
    dp = max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(
        one["params"].parameters(), four["params"].parameters()))
    if not (dl < LM_TRAIN_MICROBATCH_BOUND and dp < LM_TRAIN_MICROBATCH_BOUND):
        raise AssertionError(f"{cut.name}: microbatches=4 differs from one "
                             f"batch by {dl:.3e} (loss), {dp:.3e} (params)")
    parts.append(f"microbatches 4 = 1: loss {dl:.3e}, params {dp:.3e} "
                 f"(bound {LM_TRAIN_MICROBATCH_BOUND})")
    del one, four

    with _deterministic():
        a, b = _state_on(cut, base, dev), _state_on(cut, base, dev)
        make_train_step(cut, opt, remat=True)(a, batch)
        make_train_step(cut, opt, remat=False)(b, batch)
        gap, leaf = _state_gap(a, b)
        if gap != 0.0:
            raise AssertionError(f"{cut.name}: remat on differs from off by "
                                 f"{gap:.3e} at {leaf}")
        parts.append("remat on = off bit for bit")
        del a, b, base

        d = ROOT / "build" / "lm_train_ckpt"
        shutil.rmtree(d, ignore_errors=True)

        def batches(skip=0):
            it = token_batches(cut.vocab_size, 2, 40, steps=4, seed=5,
                               device=dev)
            for _ in range(skip):
                next(it)
            return it

        t0 = time.perf_counter()
        straight, _ = train(cut, TrainConfig(steps=4, log_every=100), opt,
                            batches(), device=dev)
        train(cut, TrainConfig(steps=2, ckpt_every=2, ckpt_dir=str(d),
                               log_every=100), opt, batches(), device=dev)
        resumed, _ = train(cut, TrainConfig(steps=4, ckpt_every=100,
                                            ckpt_dir=str(d), resume="auto",
                                            log_every=100), opt, batches(2),
                           device=dev)
        gap, leaf = _state_gap(resumed, straight)
        if gap != 0.0:
            raise AssertionError(f"{cut.name}: crash and resume differs from "
                                 f"4 straight steps by {gap:.3e} at {leaf}")
        del resumed
        # the planted fault: a resume that leaves m and v at zero
        shutil.rmtree(d / "step_4")
        real = C.CheckpointManager.restore

        def zero_moments(self, *a, **kw):
            state, manifest = real(self, *a, **kw)
            for k in ("m", "v"):
                for t in state["opt"][k].values():
                    t.zero_()
            return state, manifest

        C.CheckpointManager.restore = zero_moments
        try:
            bad, _ = train(cut, TrainConfig(steps=4, ckpt_every=100,
                                            ckpt_dir=str(d), resume="auto",
                                            log_every=100), opt, batches(2),
                           device=dev)
        finally:
            C.CheckpointManager.restore = real
        caught, fleaf = _state_gap(bad, straight)
        if not caught > 0.0:
            raise AssertionError(f"{cut.name}: crash-resume misses a resume "
                                 f"with m and v at zero")
        parts.append(f"crash at 2 and resume = 4 straight steps bit for bit "
                     f"(planted zero moments: {caught:.3e} at {fleaf}; "
                     f"{time.perf_counter() - t0:.1f} s with the "
                     f"checkpoints)")
        del bad, straight
        shutil.rmtree(d, ignore_errors=True)
    return "; ".join(parts)


def lm_train_flops(cfg, B, S) -> dict:
    """Model FLOPs of one remat train step: 6·N·T for the matmuls of every
    parameter (the tied embedding counted once, as the head: its lookup is
    no product), the remat's second forward of the layers, 2·N_layers·T,
    and attention's QKᵀ and PV over the full S × S scores (the port
    computes them unmasked) in the forward (4·B·S²·H·hd a layer), the
    backward (twice that) and the recomputed forward."""
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    h, hk, hd, ff = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    per_layer = d * (h + 2 * hk) * hd + h * hd * d + 3 * d * ff
    per_layer += 2 * d + (2 * hd if cfg.qk_norm else 0)
    N = V * d + L * per_layer + d
    T = B * S
    attn = 16.0 * B * S * S * h * hd * L
    return {"params": N, "six_nt": 6.0 * N * T,
            "remat": 2.0 * L * per_layer * T, "attention": attn,
            "total": 6.0 * N * T + 2.0 * L * per_layer * T + attn}


class _CurationTap:
    """Records each window ``Curator.select`` takes (its tokens, the
    selection, and its ms: the host embedding and the whole select)."""

    def __init__(self):
        from repro_torch.data import pipeline as P

        self.P, self.windows = P, []

    def __enter__(self):
        import torch

        P, windows = self.P, self.windows
        self.real_select = P.Curator.select
        self.real_embed = P.hashed_embedding
        real_select, real_embed = self.real_select, self.real_embed
        spent = []

        def embed(*a, **kw):
            t0 = time.perf_counter()
            out = real_embed(*a, **kw)
            spent.append(time.perf_counter() - t0)
            return out

        def select(cur, tokens):
            spent.clear()
            t0 = time.perf_counter()
            idx = real_select(cur, tokens)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            windows.append({"tokens": tokens.copy(), "indices": idx,
                            "embed_ms": sum(spent) * 1e3,
                            "select_ms": (total - sum(spent)) * 1e3})
            return idx

        P.Curator.select, P.hashed_embedding = select, embed
        return self

    def __exit__(self, *exc):
        self.P.Curator.select = self.real_select
        self.P.hashed_embedding = self.real_embed


def _same_selection_or_tie(window, ccfg, vocab) -> str:
    """A curation window's selection on the card against the ``torch``
    backend's on the CPU, round by round: both sides' caches fold the
    card's picks, and at every round the card's pick must lead the card's
    gains, and the CPU's gain of it may trail the CPU's best by at most
    twice the largest gap between the two sides' gains over the candidates
    (a flip inside both roundings: g_cpu[b] − g_cpu[a] ≤ |g_cpu[b] −
    g_card[b]| + |g_card[a] − g_cpu[a]|). So every round past a tie is
    held too. Reported: whether the CPU's own greedy picks the same, the
    rounds whose CPU best differs from the card's pick, and the largest
    gap between the sides' gains relative to the round's best gain."""
    import numpy as np

    from repro_torch.core import EvalConfig, ExemplarClustering
    from repro_torch.data.pipeline import Curator, hashed_embedding

    card = window["indices"]
    cpu = Curator(ccfg, vocab, EvalConfig(backend="torch"),
                  device="cpu").select(window["tokens"])
    emb = hashed_embedding(window["tokens"], ccfg.embed_dim, vocab)
    fc = ExemplarClustering(emb, EvalConfig(backend="torch"), device="cpu")
    fk = ExemplarClustering(emb, EvalConfig(backend="cuda"), device="cuda")
    cc, ck = fc.init_cache(), fk.init_cache()
    ties, worst = [], 0.0
    for t, j in enumerate(card):
        free = np.setdiff1d(np.arange(len(emb)), card[:t])
        gc = fc.gains_from_cache(cc, free).numpy()
        gk = fk.gains_from_cache(ck, free).cpu().numpy()
        a = int(np.searchsorted(free, j))
        err = float(np.abs(gk - gc).max())
        gap = float(gc.max() - gc[a])
        if not (gk[a] == gk.max() and gap <= 2 * err):
            raise AssertionError(
                f"round {t}: the card picks {j} (card gain {gk[a]!r}, CPU "
                f"{gc[a]!r}), the CPU's best is {free[int(np.argmax(gc))]} "
                f"(CPU gain {gc.max()!r}): not a tie within the gains' gap "
                f"{err:.3e}")
        if gap > 0:
            ties.append(t)
        worst = max(worst, err / float(gc.max() or 1.0))
        cc, ck = fc.fold_winner(cc, int(j)), fk.fold_winner(ck, int(j))
    same = "identical" if np.array_equal(card, cpu) else (
        f"parts at pick {int(np.argmax(card != cpu))}")
    return (f"CPU's greedy {same}; card's picks within a tie at every round"
            f" (ties at rounds {ties}; card and CPU gains at most "
            f"{worst:.3e} of the best apart)")


def lm_gain_eval_row(windows, peaks) -> dict:
    """``gain_eval`` at the curation's shape (n = m = 256, d = 64): against
    its plain version on a window's embedding, at the empty set's cache
    and after half the selection, then its device time (profiler) and
    event time beside the plain version, ``V @ C.T`` and the bound."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import EvalConfig, ExemplarClustering
    from repro_torch.core.precision import FP32
    from repro_torch.data.pipeline import hashed_embedding
    from repro_torch.kernels import marginal_gain as mg

    w = windows[0]
    ccfg = LM_TRAIN_FULL
    vocab = get_config(ccfg["arch"]).vocab_size
    emb = hashed_embedding(w["tokens"], 64, vocab)
    f = ExemplarClustering(emb, EvalConfig(backend="cuda"),
                           device="cuda")
    V = f.V
    n, dim = V.shape
    caches = [f.init_cache()]
    for j in w["indices"][:ccfg["select"] // 2]:
        caches.append(f.fold_winner(caches[-1], int(j)))
    kw = dict(n_total=n, policy=FP32)
    gram = 2 * float((V * V).sum(1).max())
    errs = []
    for vec, _ in (caches[0], caches[-1]):
        got = mg.gain_eval(V, V, vec.contiguous(), **kw)
        ref = mg.gain_eval_plain(V, V, vec.contiguous(), **kw)
        torch.cuda.synchronize()
        top = float(ref.abs().max())
        band = LM_GAIN_REL * top
        err = float((got - ref).abs().max())
        caught = float((got * 0.99 - ref).abs().max())
        if not (bool(torch.isfinite(got).all()) and err <= band
                and caught > band):
            raise AssertionError(f"gain_eval at the curation's shape: max "
                                 f"abs error {err:.3e} (band {band:.3e}, "
                                 f"planted 1 %: {caught:.3e}; Gram term "
                                 f"{gram:.3e})")
        errs.append(err / band)
    vec = caches[-1][0].contiguous()
    flops = 2.0 * n * n * dim
    nbytes = 4 * (2 * n * dim + n + n)
    t_ops = flops / peaks["fp32"] * 1e3
    t_bytes = nbytes / peaks["bw"] * 1e3
    return {"n": n, "m": n, "d": dim, "err_of_band": max(errs),
            "eps_gram_of_top": 2 ** -23 * gram / top,
            "ms": device_ms(lambda: mg.gain_eval(V, V, vec, **kw), 50),
            "event_ms": cuda_ms(lambda: mg.gain_eval(V, V, vec, **kw), 50),
            "plain_ms": cuda_ms(lambda: mg.gain_eval_plain(V, V, vec, **kw),
                                50),
            "library_ms": device_ms(lambda: V @ V.T, 50),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def lm_train_full(peaks) -> dict:
    """Gate 3 and the report: ``train()`` over curated ``token_batches``
    on the ``cuda`` backend, qwen3-0.6b uncut in bf16 (``LM_TRAIN_FULL``).
    Every step's loss finite, the last below the first; each window's
    selection on the card the ``torch`` backend's best on the CPU at every
    round, or a tie (``_same_selection_or_tie``);
    ``gain_eval`` launched k times per window (counted over ``train()``
    alone). Reported: ms per step (median after two warm-up steps),
    tokens/s of the steps alone and of the whole loop after the first
    window (its curations included), peak memory, MFU, the busy share of
    one profiled step, the curation's ms per window and ``gain_eval``'s
    row at its shape."""
    import math

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import EvalConfig
    from repro_torch.data.pipeline import CurationConfig, token_batches
    from repro_torch.kernels import ops
    from repro_torch.models.params import count_params
    from repro_torch.train import step as St
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, train

    c = LM_TRAIN_FULL
    cfg = get_config(c["arch"])
    ccfg = CurationConfig(window=c["window"], select=c["select"])
    opt = OptimizerConfig(lr=c["lr"], warmup_steps=c["warmup"],
                          total_steps=c["steps"])
    times, ends = [], []
    real_make = St.make_train_step

    def timed_make(*a, **kw):
        fn = real_make(*a, **kw)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            times.append(ends[-1] - t0)
            return out

        return timed

    losses = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    St.make_train_step = timed_make
    t0 = time.perf_counter()
    try:
        with _CurationTap() as tap:
            batches = token_batches(
                cfg.vocab_size, c["B"], c["S"], steps=c["steps"],
                curation=ccfg, eval_cfg=EvalConfig(backend="cuda"),
                device="cuda")
            ops.LAUNCHES.clear()
            state, _ = train(
                cfg, TrainConfig(steps=c["steps"], log_every=1), opt,
                batches, on_metrics=lambda s, m: losses.append(m["loss"]),
                device="cuda")
            launches = dict(ops.LAUNCHES)
    finally:
        St.make_train_step = real_make
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    windows = tap.windows
    if len(losses) != c["steps"] or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{cfg.name}: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: the last loss {losses[-1]} is not "
                             f"below the first {losses[0]}")
    n_windows = c["steps"] * c["B"] // c["select"]
    if len(windows) != n_windows:
        raise AssertionError(f"{len(windows)} curation windows, expected "
                             f"{n_windows}")
    want = c["select"] * len(windows)
    if launches.get("gain_eval", 0) != want:
        raise AssertionError(f"gain_eval launched {launches.get('gain_eval', 0)}"
                             f" times over training, expected {want} "
                             f"({c['select']} rounds x {len(windows)} "
                             f"windows)")
    selections = [_same_selection_or_tie(w, ccfg, cfg.vocab_size)
                  for w in windows]
    # one profiled step, and the kernel row at the curation's shape
    step = St.make_train_step(cfg, opt)
    gen = torch.Generator().manual_seed(0)
    batch = _train_batch(cfg, c["B"], c["S"], gen, "cuda")
    step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t1) * 1e3
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:5]
    n_params = count_params(state["params"])
    del state
    torch.cuda.empty_cache()
    steady = statistics.median(times[2:])
    flops = lm_train_flops(cfg, c["B"], c["S"])
    if flops["params"] != n_params:
        raise AssertionError(f"FLOP count's N {flops['params']} != the "
                             f"model's {n_params}")
    tokens = c["B"] * c["S"]
    # the whole loop from the end of the first window's last step: every
    # later window's curation, its steps and the trainer's own work
    per_window = c["select"] // c["B"]
    loop_s = ends[-1] - ends[per_window - 1]
    return {
        "params": n_params, "batch": c["B"], "seq": c["S"],
        "steps": c["steps"], "windows": len(windows),
        "losses_first_last": [losses[0], losses[-1]],
        "ms_per_step": steady * 1e3,
        "ms_per_step_q": [t * 1e3 for t in
                          statistics.quantiles(times[2:], n=4)],
        "tokens_per_s": tokens / steady,
        "tokens_per_s_with_curation": (c["steps"] - per_window) * tokens
        / loop_s,
        "loop_s_after_first_window": loop_s,
        "max_memory_allocated": peak, "memory_allocated_before": before,
        "flops_per_step": flops["total"], "flops_split": {
            k: flops[k] for k in ("six_nt", "remat", "attention")},
        "mfu": flops["total"] / steady / peaks["half"],
        "mfu_peak": peaks["half"],
        "profiled_step_wall_ms": prof_wall,
        "profiled_step_device_busy_ms": busy,
        "profiled_step_busy_share": busy / prof_wall,
        "profiled_step_device_kernels": sum(e.count for e in dev_events),
        "top_kernels_ms": [[e.key[:60], e.self_device_time_total / 1e3,
                            e.count] for e in top],
        "curation_embed_ms": [w["embed_ms"] for w in windows],
        "curation_select_ms": [w["select_ms"] for w in windows],
        "train_wall_s": wall, "gain_eval_launches": launches["gain_eval"],
        "selections": selections,
        "gain_eval_curation_shape": lm_gain_eval_row(windows, peaks),
    }


def phase_lm_gates() -> None:
    """Phase 3g's fp32 gates 1 and 2, which launch none of the port's
    kernels (``main`` runs them while the kernels build)."""
    import torch

    from repro_torch.configs import get_config, replace

    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # the fp32 gates
    try:
        for arch in LM_TRAIN_GATE1:
            t0 = time.perf_counter()
            cut = replace(get_config(arch), dtype="float32", **LM_CUT[arch])
            log(f"  {arch}: gate 1, card = CPU port ({cut.num_layers} "
                f"layers, fp32, B x S = {LM_TRAIN_GATE_BATCH}): "
                f"{lm_train_gate_card_vs_cpu(cut)} "
                f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        arch = LM_TRAIN_FULL["arch"]
        cut = replace(get_config(arch), dtype="float32", **LM_CUT[arch])
        log(f"  {arch}: gate 2, equivalences on the card ({cut.num_layers} "
            f"layers, fp32): {lm_train_gate_equivalences(cut)} "
            f"({time.perf_counter() - t0:.1f} s)")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def phase_lm_training(peaks) -> dict:
    """Phase 3g's gate 3 and the report (gates 1-2: :func:`phase_lm_gates`)."""
    t0 = time.perf_counter()
    arch = LM_TRAIN_FULL["arch"]
    r = lm_train_full(peaks)
    c = LM_TRAIN_FULL
    log(f"  {arch}: gate 3, bf16 full width ({r['params']} parameters), "
        f"{c['steps']} steps of {c['B']} x {c['S']} over {r['windows']} "
        f"curated windows of {c['window']} (k = {c['select']}): losses "
        f"finite, {r['losses_first_last'][0]:.4f} -> "
        f"{r['losses_first_last'][1]:.4f}; selections against the CPU's: "
        f"{'; '.join(r['selections'])}; gain_eval launched "
        f"{r['gain_eval_launches']} times "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"    report: {json.dumps(r)}")
    return r


#: Phase 3j, the production dry run against the card: phase 3g's cell
#: (``LM_TRAIN_FULL``'s arch, batch and length; bf16, remat), as the dry
#: run's train step runs it — the placed step on a (1, 1) ``("data",
#: "model")`` mesh.
LM_DRYRUN_MESH = (1, 1)


def phase_lm_dryrun(train_report, peaks) -> dict:
    """Phase 3j: the dry run (``repro_torch.launch.dryrun``) of 3g's cell on
    meta tensors over a fake group of one rank, then one real step of the
    same code path on the card, on one NCCL rank (an in-process store),
    under the dry run's own counters (``dryrun.measure``). Gates: the
    FLOPs, the bytes accessed, the op count, the peak of the step's live
    storage and the collectives equal on both sides, and the argument
    bytes equal to the real state's and batch's. Printed: the peaks, the
    roofline's eager bound and the function's floor bound against 3g's
    ms per step, ``lm_train_flops`` against the counted FLOPs."""
    import math

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import Shape
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import step as St

    t0 = time.perf_counter()
    c = LM_TRAIN_FULL
    cfg = get_config(c["arch"])
    shape = Shape("phase_3g", c["S"], c["B"], "train")
    axes = ("data", "model")
    if dist.is_initialized():
        raise AssertionError("phase 3j starts with no process group")
    D.ensure_fake_group(1)
    try:
        run, meta = D.lower_cell(c["arch"], shape, False, cfg=cfg,
                                 mesh=make_mesh(LM_DRYRUN_MESH, axes))
    finally:
        dist.destroy_process_group()
    rec = D.cell_record(run, meta, shape, peaks=peaks)
    t_dry = time.perf_counter() - t0
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(LM_DRYRUN_MESH, axes)
        if mesh.device_type != "cuda":
            raise AssertionError(f"3j: an NCCL rank's mesh is on "
                                 f"{mesh.device_type!r}, not the card")
        rules = MeshRules.for_mesh(mesh)
        D.resolve_shards(rules)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()    # what earlier phases hold
        state = St.init_train_state(cfg, 0, "cuda", rules=rules)
        batch = _train_batch(cfg, c["B"], c["S"],
                             torch.Generator().manual_seed(0), "cuda")
        real_args = D.nbytes(state) + D.nbytes(batch)
        step = D.cell_step(cfg, shape, rules)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        real = D.measure(step, state, batch)
        torch.cuda.synchronize()
        real_peak = torch.cuda.max_memory_allocated() - base
        loss = float(real.pop("out")[1]["loss"])
        del state, batch, step
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    mem = rec["memory"]
    counts = {"flops": (run["flops"], real["flops"]),
              "bytes accessed": (run["bytes accessed"],
                                 real["bytes accessed"]),
              "aten_ops": (run["aten_ops"], real["aten_ops"]),
              "temp_bytes": (run["temp_bytes"], real["temp_bytes"]),
              "collectives": (run["collectives"], real["collectives"])}
    differ = {k: v for k, v in counts.items() if v[0] != v[1]}
    if differ:
        raise AssertionError(f"3j: the dry run's counts differ from the "
                             f"real step's (dry run, card): {differ}")
    real_flops = real["flops"]
    if mem["argument_bytes"] != real_args:
        raise AssertionError(f"3j: the dry run's argument bytes "
                             f"{mem['argument_bytes']} != the real state's "
                             f"and batch's {real_args}")
    if not math.isfinite(loss):
        raise AssertionError(f"3j: the real step's loss {loss}")
    terms = rec["roofline"]
    measured_s = train_report["ms_per_step"] / 1e3
    hand = lm_train_flops(cfg, c["B"], c["S"])
    return {
        "flops": real_flops, "argument_bytes": real_args,
        "bytes_accessed": real["bytes accessed"],
        "aten_ops": real["aten_ops"], "temp_bytes": real["temp_bytes"],
        "collectives": real["collectives"]["counts"],
        "real_step_counted_s": real["seconds"],
        "predicted_peak_bytes": mem["peak_bytes_per_device"],
        "predicted_temp_bytes": mem["temp_bytes"],
        "real_step_peak_bytes": real_peak, "memory_allocated_before": base,
        "phase_3g_max_memory_allocated": train_report["max_memory_allocated"],
        "roofline": {k: terms[k] for k in ("compute_s", "memory_s",
                                           "collective_s", "bottleneck",
                                           "bound_s", "memory_floor_bytes",
                                           "memory_floor_s",
                                           "floor_bound_s")},
        "phase_3g_ms_per_step": train_report["ms_per_step"],
        "share_of_bound_reached": terms["bound_s"] / measured_s,
        "share_of_floor_bound_reached": terms["floor_bound_s"] / measured_s,
        "lm_train_flops": hand["total"],
        "lm_train_flops_over_counted": hand["total"] / real_flops,
        "real_step_loss": loss,
        "dry_run_s": t_dry, "meta_run_s": rec["lower_s"],
        "seconds": time.perf_counter() - t0,
    }


# ---------------------------------------------------------------------------
# Phase 3k: the reference's property suites and top-level examples on the card
# ---------------------------------------------------------------------------

#: tests/test_kernels.py's shapes (n, l, k, d): on and off the tile edges
#: (BLOCK_N = 128, BLOCK_L = 32, CHUNK_D = 16, one set slot, d = 200).
SUITE_SHAPES = ((64, 8, 3, 16), (257, 19, 7, 33), (512, 64, 10, 100),
                (100, 5, 1, 128), (96, 24, 16, 200))
#: Seeded draws of (n, m, d, B) and of (r, n, P) in part (a).
SUITE_DRAWS = 64
#: tests/test_kernel_parity.py's per-policy bands: an example's value on
#: the card against the reference's, on max(1, |reference|).
POLICY_TOLS = {"fp32": 1e-5, "bf16": 5e-2, "fp16": 1e-2}
#: The reference's figures for its two top-level examples: the steps of
#: examples/quickstart.py and examples/streaming_summarization.py through
#: the JAX package on the CPU. tests/test_torch_examples.py and
#: tests/test_torch_examples_streaming.py compute them afresh and hold these
#: equal to them.


def _figs(indices, value, evaluations, **extra):
    return dict(indices=indices, value=value, evaluations=evaluations,
                **extra)


_QUICK_GREEDY = [62, 668, 492, 234, 1762, 1311, 917, 1721]
_QUICK_SIEVE = [1946, 1236, 1380, 683, 336, 924, 620, 1180]
QUICKSTART_FIGURES = {
    "fit": _figs(_QUICK_GREEDY, 11.33134937286377, 15972,
                 cluster_sizes=[264, 263, 243, 274, 218, 238, 251, 249],
                 purity=1.0),
    "optimizers": {
        "greedy": _figs(_QUICK_GREEDY, 11.33134937286377, 15972),
        "lazy_greedy": _figs(_QUICK_GREEDY, 11.33134937286377, 4560),
        "stochastic_greedy": _figs(
            [572, 1491, 1125, 234, 1416, 1311, 917, 1515], 11.31581974029541,
            6046),
        "sieve_streaming": _figs(_QUICK_SIEVE, 10.980342864990234, 58000),
        "sieve_streaming_pp": _figs(_QUICK_SIEVE, 10.980342864990234, 20160),
        "three_sieves": _figs([1946, 1349, 513, 655, 1515, 1342, 283, 1425],
                              11.046131014823914, 211),
        "salsa": _figs([1946, 1236, 1815, 683, 336, 924, 620, 1180],
                       10.99489974975586, 59999),
    },
    "precision": {
        "fp32": _figs(_QUICK_GREEDY, 11.33134937286377, 15972),
        "bf16": _figs(_QUICK_GREEDY, 11.330510139465332, 15972),
        "fp16": _figs(_QUICK_GREEDY, 11.331341743469238, 15972),
    },
    "greedy_host": _figs(_QUICK_GREEDY, 11.33134937286377, 15972),
    "greedy_device": _figs(_QUICK_GREEDY, 11.331350326538086, 15972),
    "lazy_host": _figs(_QUICK_GREEDY, 11.33134937286377, 4560),
    "lazy_device": _figs(_QUICK_GREEDY, 11.331350326538086, 4560),
}
_STREAM_SIEVE = [1819, 3611, 1125, 3077, 1403, 531, 787, 1449, 1458, 2759,
                 1981, 2882]
STREAMING_FIGURES = {
    "offline": _figs([215, 2183, 3281, 2780, 3142, 3918, 3198, 2906, 154,
                      1697, 1288, 2255], 20.260622024536133, 47934),
    "sieve_streaming": _figs(_STREAM_SIEVE, 19.603178024291992, 132031),
    "sieve_streaming++": _figs(_STREAM_SIEVE, 19.603178024291992, 40240),
    "salsa": _figs([1819, 3611, 3077, 1449, 1494, 368, 2237, 3526, 1182, 2414,
                    665, 3197], 19.71817970275879, 147993),
    "three_sieves(T=100)": _figs([672, 2292, 1819, 763, 2174, 2050, 1417,
                                  3654, 1996, 3080, 83, 696],
                                 19.6760151386261, 394),
    "service": _figs([2, 3, 5, 6, 7, 9, 17, 25, 29, 34, 38, 55],
                     19.603178024291992, 132031, n_ingested=4000,
                     n_accepted=29),
}
#: Steps of the examples whose selection is an argmax per round, where a
#: pick may flip between two near-equal gains; the sieves' accept
#: decisions are held identical.
ARGMAX_STEPS = ("fit", "optimizers/greedy", "optimizers/lazy_greedy",
                "optimizers/stochastic_greedy", "precision/fp32",
                "precision/bf16", "precision/fp16", "greedy_host",
                "greedy_device", "lazy_host", "lazy_device", "offline")


def _need(ok, what):
    if not ok:
        raise AssertionError(what)


def _on_card(a, dtype=None):
    import numpy as np
    import torch

    return torch.as_tensor(np.asarray(a), dtype=dtype or torch.float32,
                           device="cuda").contiguous()


def suite_eval_case(check, n, l, k, d, *, policy="fp32", mode="fused",
                    variant="flat", rbf=False, budget=None, seed=0):
    """``ops.exemplar_eval`` at a shape of tests/test_kernels.py, on its
    generator (normal + 2 payloads, ragged lengths, d_e0 = ‖v‖², rbf's
    transform of it): the kernels' result against the plain version's on
    the same inputs, and two_pass's W·n. Returns the (l,) result."""
    import numpy as np
    import torch

    from repro_torch.core.precision import resolve
    from repro_torch.kernels import exemplar_eval as ee
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    V = (rng.normal(size=(n, d)) + 2.0).astype(np.float32)
    S = (rng.normal(size=(l, k, d)) + 2.0).astype(np.float32)
    lengths = rng.integers(1, k + 1, size=l)
    d_e0 = np.sum(V ** 2, axis=1)
    gamma = 1.0 if rbf else None
    if rbf:
        d_e0 = 2.0 * (1.0 - np.exp(-d_e0))
    scale = (2.0 if rbf else 1.0) * float((V * V).sum(-1).max()
                                          + (S * S).sum(-1).max())
    p = resolve(policy)
    V, S, lengths, d_e0 = (_on_card(V), _on_card(S),
                           _on_card(lengths, torch.int32), _on_card(d_e0))
    tag = (f"suite n={n} l={l} k={k} d={d} {policy} {mode}/{variant}"
           f"{' rbf' if rbf else ''}{f' budget={budget}' if budget else ''}")
    got = ops.exemplar_eval(V, S, lengths, d_e0, policy=p, mode=mode,
                            variant=variant, memory_budget_bytes=budget,
                            rbf_gamma=gamma)
    kw = dict(n_total=n, policy=p, rbf_gamma=gamma)
    if mode == "fused":
        SS = S.permute(1, 0, 2).contiguous() if variant == "flat" else S
        check("fused_eval", got,
              ee.fused_eval_plain(V, SS, lengths, d_e0, layout=variant, **kw),
              policy, tag, scale=scale)
        return got
    Wp = ee.two_pass_eval_plain(V, S, lengths, d_e0, **kw)
    check("two_pass_eval", got, Wp.sum(1), policy, tag + " rowsum",
          scale=scale)
    W = ee.two_pass_eval(V, S, lengths, d_e0,
                         k_chunk=ops.kernel_config(k, d, p).k_chunk, **kw)
    check("two_pass_eval", W * n, Wp * n, policy, tag + " W·n", scale=scale)
    return got


def suite_gain_case(check, n, m, d, B, fold, seed):
    """Rows 4–7 at a drawn shape of tests/test_kernels.py's ranges, B
    requests: the min fold on its normal + 1 payloads with caches around
    the typical distance 2d (its caches in [0.5, 4] leave every gain at 0
    once d passes a few), the max fold on payloads whose distances are
    O(1); the first candidate is the request's most central row and the
    winner lies half the typical distance from it, so that no request's
    gains are all 0 or all far under the band's scale (a planted fault
    could not show: the Gram identity's band grows with max‖v‖², which
    outliers set at small d). Each kernel against its
    plain version, every gain ≥ −1e-6, and each request of the batched
    launches bit for bit its unbatched launch."""
    import numpy as np
    import torch

    from repro_torch.core.functions import SIM_ALPHA, SIM_BETA
    from repro_torch.core.precision import FP32
    from repro_torch.kernels import marginal_gain as mg

    rng = np.random.default_rng(seed)
    sigma, shift = (1.0, 1.0) if fold == "min" else ((2 * d) ** -0.5, 0.1)
    V = rng.normal(size=(B, n, d)) * sigma + shift
    C = rng.normal(size=(B, m, d)) * sigma + shift
    # the first candidate is each request's most central row, and the
    # winner lies half the typical distance from it
    central = np.linalg.norm(V - V.mean(1, keepdims=True), axis=2).argmin(1)
    C[:, 0] = V[np.arange(B), central]
    w = C[:, 0] + sigma * rng.choice([-1.0, 1.0], size=(B, d))
    cache = (rng.uniform(0.5, 1.5, size=(B, n)) * 2 * d if fold == "min"
             else rng.uniform(0.0, 0.8, size=(B, n)))
    wv = rng.integers(0, 2, size=B)
    scale = float((V * V).sum(-1).max() + (C * C).sum(-1).max())
    V, C, w, cache, wv = map(_on_card, (V, C, w, cache, wv))
    kw = dict(n_total=n, policy=FP32, rbf_gamma=None, fold=fold,
              affine=(SIM_ALPHA, SIM_BETA) if fold == "max" else None)
    tag = f"suite draw B={B} n={n} m={m} d={d} {fold}"
    gb = mg.gain_eval_batched(V, C, cache, **kw)
    check("gain_eval_batched", gb, mg.gain_eval_batched_plain(V, C, cache,
                                                              **kw),
          "fp32", tag, scale=scale)
    ub, cb = mg.gain_update_eval_batched(V, C, cache, w, wv, **kw)
    up, cp = mg.gain_update_eval_batched_plain(V, C, cache, w, wv, **kw)
    check("gain_update_eval_batched", ub, up, "fp32", tag + " gains",
          scale=scale)
    check("gain_update_eval_batched", cb, cp, "fp32", tag + " cache",
          scale=scale)
    for b in range(B):
        g = mg.gain_eval(V[b], C[b], cache[b], **kw)
        check("gain_eval", g, mg.gain_eval_plain(V[b], C[b], cache[b], **kw),
              "fp32", f"{tag} request {b}", scale=scale)
        gu, cu = mg.gain_update_eval(V[b], C[b], cache[b], w[b], wv[b], **kw)
        gp, cpl = mg.gain_update_eval_plain(V[b], C[b], cache[b], w[b], wv[b],
                                            **kw)
        check("gain_update_eval", gu, gp, "fp32", f"{tag} request {b} gains",
              scale=scale)
        check("gain_update_eval", cu, cpl, "fp32",
              f"{tag} request {b} cache", scale=scale)
        _need(min(float(g.min()), float(gu.min())) >= -1e-6,
              f"{tag} request {b}: a negative gain")
        _need(torch.equal(g, gb[b]) and torch.equal(gu, ub[b])
              and torch.equal(cu, cb[b]),
              f"{tag}: request {b} differs from its unbatched launch")


def suite_sieve_case(check, r, n, P, fold, seeded, seed):
    """Rows 8–9 at a drawn table (r ∈ [1, 65], n ∈ [1, 150]), P partitions,
    with and without the seed row: each kernel against its plain version,
    every gain ≥ −1e-6, each partition bit for bit its unbatched launch."""
    import torch

    from repro_torch.core.functions import SIM_ALPHA, SIM_BETA
    from repro_torch.kernels import marginal_gain as mg

    T, dv = sieve_operands((P,), r, n, fold, seed)
    kw = dict(n_total=n, fold=fold,
              affine=(SIM_ALPHA, SIM_BETA) if fold == "max" else None,
              seed=T[0, 0].clone() if seeded else None)
    tag = f"suite draw P={P} r={r} n={n} {fold}{' seed' if seeded else ''}"
    got = mg.sieve_gain_eval_batched(T, dv, **kw)
    check("sieve_gain_eval_batched", got,
          mg.sieve_gain_eval_batched_plain(T, dv, **kw), "fp32", tag)
    _need(float(got.min()) >= -1e-6, f"{tag}: a negative gain")
    for p in range(P):
        one = mg.sieve_gain_eval(T[p], dv[p], **kw)
        check("sieve_gain_eval", one,
              mg.sieve_gain_eval_plain(T[p], dv[p], **kw), "fp32",
              f"{tag} partition {p}")
        _need(torch.equal(one, got[p]),
              f"{tag}: partition {p} differs from its unbatched launch")


def suite_draws(rng):
    """One seeded draw of part (a): a gain shape and a sieve table from the
    reference suites' ranges."""
    gain = dict(n=int(rng.integers(9, 151)), m=int(rng.integers(1, 41)),
                d=int(rng.integers(1, 71)), B=int(rng.integers(1, 9)),
                fold=str(rng.choice(["min", "max"])))
    sieve = dict(r=int(rng.integers(1, 66)), n=int(rng.integers(1, 151)),
                 P=int(rng.integers(1, 9)),
                 fold=str(rng.choice(["min", "max"])),
                 seeded=bool(rng.integers(0, 2)))
    return gain, sieve


def phase_suite_kernels(check) -> None:
    """Part (a): every kernel at the reference suites' shapes."""
    import numpy as np

    from repro_torch.core.evaluator import plan_chunks
    from repro_torch.core.precision import FP32

    for shape in SUITE_SHAPES:
        for variant in ("flat", "loop"):
            suite_eval_case(check, *shape, variant=variant)
    for shape in SUITE_SHAPES[:3]:
        suite_eval_case(check, *shape, mode="two_pass", variant="loop")
    for pol in POLICIES:
        suite_eval_case(check, 128, 16, 5, 48, policy=pol, seed=4)
    suite_eval_case(check, 96, 12, 4, 32, rbf=True, seed=5)
    # the suite's 400 000-byte budget holds all 32 sets; 30 000 splits them
    # into five chunks
    _need(len(plan_chunks(32, 128, 6, 40, FP32, "fused", 30_000)) == 5,
          "the 30 000-byte budget does not split (128, 32, 6, 40) in five")
    full = suite_eval_case(check, 128, 32, 6, 40, seed=6)
    err = 0.0
    for budget in (400_000, 30_000):
        chunked = suite_eval_case(check, 128, 32, 6, 40, seed=6,
                                  budget=budget)
        err = max(err, float((chunked - full).abs().max()))
    _need(err <= 1e-6, f"chunked launches differ from the unchunked one by "
                       f"{err:.3e}")
    rng = np.random.default_rng(2025)
    for i in range(SUITE_DRAWS):
        gain, sieve = suite_draws(rng)
        suite_gain_case(check, seed=i, **gain)
        suite_sieve_case(check, seed=i, **sieve)
    log(f"    (a) {check.cases} comparisons: SHAPES x (flat, loop), two_pass "
        f"at SHAPES[:3], 4 policies at (128, 16, 5, 48), rbf at "
        f"(96, 12, 4, 32), chunked (budgets 400 000 and 30 000) = unchunked "
        f"within 1e-6 ({err:.1e}), "
        f"{SUITE_DRAWS} drawn gain shapes (B in [1, 8]) and sieve tables, "
        f"every gain >= -1e-6, batched = unbatched bit for bit")
    report_kernel_checks(check)


def suite_function(n=24, d=4, seed=0, **kw):
    """tests/test_core_properties.py's ground set on the card (the ``cuda``
    backend; distances without a kernel form on the ``torch`` backend)."""
    import numpy as np

    from repro_torch.core import EvalConfig, ExemplarClustering
    from repro_torch.core.distances import MXU_ELIGIBLE

    rng = np.random.default_rng(seed)
    V = (rng.normal(size=(n, d)) + 1.5).astype(np.float32)
    backend = "cuda" if kw.get("distance", "sqeuclidean") in MXU_ELIGIBLE \
        else "torch"
    return ExemplarClustering(V, EvalConfig(backend=backend, **kw),
                              device="cuda"), V


def suite_monotone(seed, idx, extra):
    """f(A) ≤ f(A ∪ {e}) (Definition 3)."""
    f, V = suite_function(seed=seed)
    a = f.value(V[sorted(idx)])
    ae = f.value(V[sorted(set(idx) | {extra})])
    _need(a <= ae + 1e-5, f"monotone seed={seed}: {a} > {ae}")


def suite_diminishing(seed, a_idx, b_extra, e):
    """Δ(e|A) ≥ Δ(e|B) for A ⊆ B, e ∉ B (Definition 2)."""
    import numpy as np

    f, V = suite_function(seed=seed)
    a_set = set(a_idx)
    b_set = a_set | set(b_extra)
    if e in b_set:
        b_set.discard(e)
        a_set.discard(e)
        if not a_set:
            a_set = {(e + 1) % 24}
            b_set |= a_set
    A, B = V[sorted(a_set)], V[sorted(b_set)]
    da = f.value(np.concatenate([A, V[[e]]])) - f.value(A)
    db = f.value(np.concatenate([B, V[[e]]])) - f.value(B)
    _need(da >= db - 1e-4, f"diminishing returns seed={seed}: {da} < {db}")


def suite_empty(seed):
    import numpy as np

    f, _ = suite_function(seed=seed)
    _need(f.value(np.zeros((0, 4), np.float32)) == 0.0,
          f"f(empty) != 0 at seed={seed}")


def suite_greedy_bound(seed, k):
    """Greedy ≥ (1 − 1/e)·OPT, OPT by brute force over n = 12."""
    import itertools
    import math

    from repro_torch.core import greedy

    f, V = suite_function(n=12, seed=seed)
    res = greedy(f, k)
    opt = float(f.value_sets([V[list(c)] for c in itertools.combinations(
        range(12), k)]).max())
    _need(res.value >= (1 - 1 / math.e) * opt - 1e-5,
          f"greedy seed={seed} k={k}: {res.value} < (1 - 1/e) x {opt}")


def suite_mincache(seed):
    """The min-cache's value equals direct evaluation at every step."""
    import numpy as np

    f, V = suite_function(seed=seed)
    cache = f.init_mincache()
    chosen = []
    for j in np.random.default_rng(seed).choice(24, size=5, replace=False):
        chosen.append(int(j))
        cache = f.update_mincache(cache, f.V[int(j)])
        got, direct = f.value_from_mincache(cache), f.value(V[chosen])
        _need(abs(got - direct) < 1e-4,
              f"min-cache seed={seed} {chosen}: {got} vs {direct}")


def suite_distances(seed, dist):
    """f ≥ 0 and monotone for every distance."""
    f, V = suite_function(seed=seed, distance=dist)
    s3, s5 = f.value(V[:3]), f.value(V[:5])
    _need(s3 >= -1e-6 and s5 >= s3 - 1e-5,
          f"{dist} seed={seed}: f(V[:3]) = {s3}, f(V[:5]) = {s5}")


def suite_sieve_bound(seed, k, eps, mode):
    """SieveStreaming ≥ (1/2 − ε)·greedy, host and device plans."""
    from repro_torch.core import greedy, sieve_streaming

    f, _ = suite_function(seed=seed)
    base = greedy(f, k)
    res = sieve_streaming(f, k, eps=eps, seed=seed, mode=mode)
    _need(len(res.indices) <= k and
          res.value >= (0.5 - eps) * base.value - 1e-5,
          f"sieve {mode} seed={seed} k={k} eps={eps}: {res.value} vs "
          f"greedy {base.value}")


def zoo_function(name, n, d, seed):
    """tests/test_function_properties.py's zoo member (rbf) on the card."""
    import numpy as np

    from repro_torch.core import EvalConfig
    from repro_torch.core.functions import FUNCTIONS

    rng = np.random.default_rng(seed)
    V = (rng.normal(size=(n, d)) * 0.4).astype(np.float32)
    return FUNCTIONS[name](V, EvalConfig(distance="rbf", backend="cuda"),
                           device="cuda")


def suite_zoo_chain(name, n, d, seed, held_out, order):
    """Every non-member's gain ≥ 0 along a greedy chain, and the held-out
    candidate's gain non-increasing while it stays out of S (graph cut
    scores members below zero, ROADMAP C.2)."""
    import numpy as np

    f = zoo_function(name, n, d, seed)
    cache = f.init_cache()
    members, held = [], []
    for _ in range(min(5, n - 1)):
        gains = f.gains_from_cache(cache, np.arange(n)).cpu().double().numpy()
        out = np.setdiff1d(np.arange(n), members)
        _need(gains[out].min() >= -1e-5,
              f"{name} n={n} d={d} seed={seed}: gain {gains[out].min()}")
        if held_out not in members:
            held.append(gains[held_out])
        j = max(order, key=lambda i: gains[i])
        members.append(j)
        cache = f.fold_winner(cache, j)
    _need(all(b <= a + 1e-5 for a, b in zip(held, held[1:])),
          f"{name} n={n} d={d} seed={seed}: held-out gains {held}")


def suite_zoo_telescopes(name, n, d, seed):
    """f(S) = f(∅) + the sum of the accepted gains along any chain."""
    f = zoo_function(name, n, d, seed)
    cache = f.init_cache()
    total = f.value_from_cache(cache)
    _need(abs(total) <= 1e-5, f"{name}: f(empty) = {total}")
    for t in range(min(5, n - 1)):
        j = (seed + 7 * t) % n
        total += float(f.gains_from_cache(cache, [j])[0])
        cache = f.fold_winner(cache, j)
    value = f.value_from_cache(cache)
    _need(abs(value - total) <= 5e-5,
          f"{name} n={n} d={d} seed={seed}: {value} vs telescoped {total}")


def suite_dyadic_tables(seed, k, eps, variant, block_size, evict=False):
    """The device sieve's table after a stream on the 1/32 grid (n = 64,
    every sum exact in float32): the ``cuda`` backend's bit for bit the
    ``torch`` backend's; with ``evict``, salsa squeezed into a sieve-sized
    table over an ascending-norm stream."""
    import numpy as np
    import torch

    from repro_torch.core import ExemplarClustering
    from repro_torch.core import streaming as st

    rng = np.random.default_rng(seed)
    V = (rng.integers(0, 129, size=(64, 6)) / 32.0).astype(np.float32)
    s_max = None
    if evict:
        order = np.argsort((V ** 2).sum(axis=1), kind="stable")
        s_max = st.default_capacity(k, eps, "sieve")
    else:
        order = np.random.default_rng(seed + 1).permutation(64)
    f = ExemplarClustering(V, device="cuda")
    X = f.V[torch.as_tensor(order, device="cuda")]
    engines = []
    for backend in ("torch", "cuda"):
        eng = st.make_sieve_engine(f, k, eps, variant=variant, mode="device",
                                   s_max=s_max, block_size=block_size,
                                   backend=backend)
        eng.offer(order, X)
        engines.append(eng)
    et, ec = engines
    tag = f"dyadic seed={seed} k={k} eps={eps} {variant} block={block_size}"
    _need(et.evaluations() == ec.evaluations() and et.best() == ec.best(),
          f"{tag}: evaluations or best sieve differ")
    for name in st.SieveState._fields:
        _need(torch.equal(getattr(et.state, name), getattr(ec.state, name)),
              f"{tag}: {name} differs between the torch and cuda backends")


def _subset(rng, n, lo, hi):
    return sorted(int(i) for i in rng.choice(n, size=int(rng.integers(
        lo, hi + 1)), replace=False))


def _zoo_draw(rng, chain=False):
    """tests/test_function_properties.py's draw: a zoo member, n, d, a
    seed and, for the chain, a held-out candidate and a tie order."""
    from repro_torch.core.functions import FUNCTIONS

    n = int(rng.integers(6, 49))
    out = dict(name=str(rng.choice(sorted(FUNCTIONS))), n=n,
               d=int(rng.integers(2, 9)), seed=int(rng.integers(2**31 - 1)))
    if chain:
        out.update(held_out=int(rng.integers(n)),
                   order=[int(i) for i in rng.permutation(n)])
    return out


#: Part (b): each invariant, its number of seeded draws (the CPU suites'
#: example budgets) and how one draw is made.
SUITE_INVARIANTS = (
    ("monotone", 25, suite_monotone, lambda r: dict(
        seed=int(r.integers(51)), idx=_subset(r, 24, 1, 6),
        extra=int(r.integers(24)))),
    ("diminishing returns", 25, suite_diminishing, lambda r: dict(
        seed=int(r.integers(51)), a_idx=_subset(r, 24, 1, 4),
        b_extra=_subset(r, 24, 1, 4), e=int(r.integers(24)))),
    ("empty set = 0", 10, suite_empty, lambda r: dict(
        seed=int(r.integers(31)))),
    ("greedy >= (1 - 1/e) OPT", 8, suite_greedy_bound, lambda r: dict(
        seed=int(r.integers(21)), k=int(r.integers(2, 4)))),
    ("min-cache = direct", 10, suite_mincache, lambda r: dict(
        seed=int(r.integers(21)))),
    ("every distance", 16, suite_distances, lambda r: dict(
        seed=int(r.integers(21)), dist=str(r.choice(
            ["sqeuclidean", "manhattan", "cosine", "rbf"])))),
    ("sieve >= (1/2 - eps) greedy", 20, suite_sieve_bound, lambda r: dict(
        seed=int(r.integers(41)), k=int(r.integers(2, 4)),
        eps=float(r.choice([0.1, 0.2])), mode=str(r.choice(["host",
                                                            "device"])))),
    ("zoo chain", 20, suite_zoo_chain, lambda r: _zoo_draw(r, chain=True)),
    ("zoo telescopes", 20, suite_zoo_telescopes, _zoo_draw),
    ("dyadic sieve tables", 20, suite_dyadic_tables, lambda r: dict(
        seed=int(r.integers(1001)), k=int(r.integers(1, 5)),
        eps=float(r.choice([0.1, 0.25, 0.5])),
        variant=str(r.choice(["pp", "salsa", "sieve"])),
        block_size=int(r.choice([1, 17, 64])))),
    ("dyadic tables under eviction", 20, suite_dyadic_tables,
     lambda r: dict(seed=int(r.integers(1001)), k=int(r.integers(2, 5)),
                    eps=0.1, variant="salsa", block_size=32, evict=True)),
)


def phase_suite_invariants() -> dict:
    """Part (b): the suites' invariants on the ``cuda`` backend on the
    card, at the suites' generators and a fixed number of seeded draws.
    Returns the draws per invariant."""
    import numpy as np

    rng = np.random.default_rng(2026)
    done = {}
    for name, count, fn, draw in SUITE_INVARIANTS:
        for _ in range(count):
            fn(**draw(rng))
        done[name] = count
    log(f"    (b) invariants held at every draw: {json.dumps(done)}")
    return done


def figure_steps(figs, prefix=""):
    """The step names of an example's figures ("fit", "optimizers/greedy",
    …): every dict that holds a selection."""
    for key, val in figs.items():
        if not isinstance(val, dict):
            continue
        if "indices" in val:
            yield prefix + key
        else:
            yield from figure_steps(val, f"{prefix}{key}/")


def _step(figs, step):
    for key in step.split("/"):
        figs = figs[key]
    return figs


def hold_example(what, got_all, want_all, make_f) -> dict:
    """Each step of a twin's run on the card against the reference's
    figures: identical selections, or at an argmax step a near tie (the two
    picks' gains at the first diverging round within the fp32 band, from
    ``make_f(policy)``'s function on the card); identical evaluations where
    the selections are; values within POLICY_TOLS. Returns the count of
    identical steps and the near ties."""
    out = {"identical": 0, "near_ties": []}
    for step in figure_steps(want_all):
        got, want = _step(got_all, step), _step(want_all, step)
        policy = step.split("/")[1] if step.startswith("precision/") \
            else "fp32"
        if got["indices"] == want["indices"]:
            _need(got["evaluations"] == want["evaluations"],
                  f"{what} {step}: evaluations {got['evaluations']} != the "
                  f"reference's {want['evaluations']}")
            out["identical"] += 1
        else:
            differ = (f"{what} {step}: {got['indices']} != the reference's "
                      f"{want['indices']}")
            _need(step in ARGMAX_STEPS, differ)
            t = next(i for i, (a, b) in enumerate(zip(want["indices"],
                                                      got["indices"]))
                     if a != b)
            f = make_f(policy)
            ga, gb = pick_gains(f, want["indices"], got["indices"], t)
            gap = gain_gap(f, want["indices"], got["indices"], t)
            _need(abs(ga - gb) <= BANDS["fp32"] * max(1.0, abs(ga)),
                  f"{differ}; {gap}")
            out["near_ties"].append(f"{step}: {gap}")
        _need(abs(got["value"] - want["value"]) <= POLICY_TOLS[policy] * max(
            1.0, abs(want["value"])),
              f"{what} {step}: value {got['value']} vs the reference's "
              f"{want['value']}")
    return out


def example_function(n, dim, centers, seed, policy):
    """An example's ground set on the card at ``policy`` (a near tie's
    gains are read from it)."""
    from repro_torch.core import EvalConfig, ExemplarClustering
    from repro_torch.data.synthetic import blobs

    X, _ = blobs(n=n, dim=dim, centers=centers, seed=seed)
    return ExemplarClustering(X, EvalConfig(policy=policy, backend="cuda"),
                              device="cuda")


def phase_suite_examples() -> dict:
    """Part (c): both twins' ``run(device="cuda")`` against the reference's
    figures, and the card's plans against each other (device = host, CELF
    device = host, sharded = device). Returns each twin's seconds."""
    sys.path.insert(0, str(ROOT / "examples"))
    import quickstart_torch
    import streaming_summarization_torch

    t0 = time.perf_counter()
    q = quickstart_torch.run("cuda")
    seconds = {"quickstart": time.perf_counter() - t0}
    held_q = hold_example("quickstart", q, QUICKSTART_FIGURES,
                          functools.partial(example_function, 2000, 32, 8, 0))
    for a, b in (("greedy_device", "greedy_host"),
                 ("lazy_device", "lazy_host"), ("sharded", "greedy_device")):
        _need(q[a]["indices"] == q[b]["indices"]
              and q[a]["evaluations"] == q[b]["evaluations"]
              and abs(q[a]["value"] - q[b]["value"])
              <= BANDS["fp32"] * max(1.0, abs(q[b]["value"])),
              f"quickstart on the card: {a} {q[a]} != {b} {q[b]}")
    fit = QUICKSTART_FIGURES["fit"]
    if q["fit"]["indices"] == fit["indices"]:
        _need(q["fit"]["cluster_sizes"] == fit["cluster_sizes"]
              and q["fit"]["purity"] == fit["purity"],
              f"quickstart: clusters {q['fit']['cluster_sizes']} (purity "
              f"{q['fit']['purity']}) != the reference's")
    t0 = time.perf_counter()
    s = streaming_summarization_torch.run("cuda")
    seconds["streaming"] = time.perf_counter() - t0
    held_s = hold_example("streaming", s, STREAMING_FIGURES,
                          functools.partial(example_function, 4000, 64, 12,
                                            1))
    svc, want = s["service"], STREAMING_FIGURES["service"]
    _need(svc["n_ingested"] == want["n_ingested"]
          and svc["n_accepted"] == want["n_accepted"],
          f"streaming service: {svc['n_ingested']} ingested, "
          f"{svc['n_accepted']} accepted; the reference's "
          f"{want['n_ingested']}, {want['n_accepted']}")
    log(f"    (c) quickstart on cuda ({seconds['quickstart']:.1f} s): "
        f"{held_q['identical']} of {len(list(figure_steps(QUICKSTART_FIGURES)))} "
        f"steps identical to the reference, near ties {held_q['near_ties']}; "
        f"device = host, CELF device = host, sharded over "
        f"{q['sharded']['devices']} NCCL rank = device; greedy f = "
        f"{q['greedy_device']['value']:.6f}, clusters "
        f"{q['fit']['cluster_sizes']}, purity {q['fit']['purity']:.2%}")
    log(f"        streaming on cuda ({seconds['streaming']:.1f} s): "
        f"{held_s['identical']} of {len(STREAMING_FIGURES)} steps identical, "
        f"near ties {held_s['near_ties']}; service f = {svc['value']:.6f}, "
        f"{svc['n_ingested']} ingested, {svc['n_accepted']} accepted; "
        f"seconds per step "
        f"{json.dumps({k: round(v['seconds'], 3) for k, v in s.items() if isinstance(v, dict)})}")
    return seconds


def phase_suites() -> dict:
    """Phase 3k: parts (a), (b) and (c); returns each part's seconds."""
    seconds = {}
    t0 = time.perf_counter()
    phase_suite_kernels(Checker())
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_suite_invariants()
    seconds["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seconds.update({f"c {k}": v for k, v in phase_suite_examples().items()})
    seconds["c"] = time.perf_counter() - t0
    return seconds


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
        # the names are read from sessions of ``reps`` calls too: the
        # profiler has come back with no device activity at all from a
        # session of three flushes, ten times in a row
        skip = set(_device_times([flush], reps))
        if not skip or skip & set(_device_times([fn], reps)):
            raise AssertionError(f"the L2 flush's kernels {sorted(skip)} are "
                                 f"missing or shared with the timed call")
        total = sum(t for key, t in _device_times([flush, fn], reps).items()
                    if key not in skip)
    if total <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total / 1e3 / reps


def phase_timing(peaks: dict, V64, Vpaper, serve_shapes) -> tuple:
    """Per-kernel times at the main path's shapes (fp32 policy); the
    batched kernels held against their plain versions at every shape in
    ``serve_shapes`` (on the serving phase's payloads ``V64`` and
    ``Vpaper``) and timed at B = 64, n = m = 8 192. Then rows 1-7 (and
    CELF's re-score) at bf16 and fp16, on the tensor cores. Returns the
    fp32 rows and {(kernel, policy): row} of the half policies."""
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

    def tc_bound(flops, epilogue_ops, nbytes):
        """The tensor-core instances' bound: the largest of the products at
        the dense bf16/fp16 peak, the epilogue's fp32 operations at the SIMT
        rate (one a lane a cycle: half the FMA-counted fp32 peak) and the
        bytes, with the one that binds. The epilogue counts what the kernels
        do: five operations a gain cell (min fold, sqeuclidean), three an
        exemplar-eval cell and four a (row, set), eight a row's fold."""
        t = {"tensor-core operations": flops / peaks["half"] * 1e3,
             "fp32 operations": epilogue_ops / (peaks["fp32"] / 2) * 1e3,
             "bytes": nbytes / peaks["bw"] * 1e3}
        by = max(t, key=t.get)
        return t[by], by

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
    half = {}

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
    for pol in ("bf16", "fp16"):
        p = resolve(pol)
        kwbh = dict(n_total=Nq, policy=p)
        cacheh = torch.stack([e0_distances(v, None, "sqeuclidean", p)
                              for v in V64]).float().contiguous()
        agree("gain_eval_batched",
              mg.gain_eval_batched(V64, V64, cacheh, **kwbh),
              mg.gain_eval_batched_plain(V64, V64, cacheh, **kwbh),
              f"B={Bq} m={Nq} {pol}")
        g, nc = mg.gain_update_eval_batched(V64, V64, cacheh, w64, wv64,
                                            **kwbh)
        gp, ncp = mg.gain_update_eval_batched_plain(V64, V64, cacheh, w64,
                                                    wv64, **kwbh)
        agree("gain_update_eval_batched", g, gp, f"gains B={Bq} m={Nq} {pol}")
        agree("gain_update_eval_batched", nc, ncp, f"cache B={Bq} n={Nq} {pol}")
        del g, nc, gp, ncp
        V64h = V64.to(p.compute_dtype)
        bmmh = cuda_ms(lambda: torch.bmm(V64h, V64h.transpose(1, 2)), R)
        del V64h
        half[("gain_eval_batched", pol)] = dict(
            **kernel_ms(lambda: mg.gain_eval_batched(V64, V64, cacheh,
                                                     **kwbh)),
            plain_ms=cuda_ms(lambda: mg.gain_eval_batched_plain(
                V64, V64, cacheh, **kwbh), R),
            library_ms=bmmh,
            bound=tc_bound(batched_flops, 5 * Bq * Nq * Nq,
                           batched_in + 4 * Bq * Nq))
        half[("gain_update_eval_batched", pol)] = dict(
            **kernel_ms(lambda: mg.gain_update_eval_batched(
                V64, V64, cacheh, w64, wv64, cache_out=out64, **kwbh)),
            plain_ms=cuda_ms(lambda: mg.gain_update_eval_batched_plain(
                V64, V64, cacheh, w64, wv64, **kwbh), R),
            library_ms=bmmh,
            bound=tc_bound(batched_flops + 2.0 * Bq * Nq * DIM,
                           5 * Bq * Nq * Nq + 8 * Bq * Nq,
                           batched_in + 4 * Bq * (DIM + 1) + 4 * 2 * Bq * Nq))
    # rows 1-7 at bf16 and fp16: the tensor-core kernels, on the main path's
    # fp32 operands (rounded as they are staged), held to their plain
    # versions as above; library: cuBLAS in the compute dtype on operands
    # converted beforehand (the product alone)
    # the paper-size winner (by here w and wv hold the serving shapes')
    w1, wv1 = Vb[123].contiguous(), torch.ones((), device=dev)
    for pol in ("bf16", "fp16"):
        p = resolve(pol)
        cd = p.compute_dtype
        kwh = dict(n_total=N, policy=p)
        kch = ops.kernel_config(K, DIM, p).k_chunk
        d_e0h = e0_distances(V, None, "sqeuclidean", p).float().contiguous()
        cacheh = e0_distances(Vb, None, "sqeuclidean", p).float().contiguous()
        Vh, Sflath, Vbh = V.to(cd), Sflat.to(cd), Vb.to(cd)
        eval_lib = cuda_ms(lambda: Vh @ Sflath.T, R)
        gain_lib = cuda_ms(lambda: Vbh @ Vbh.T, R)
        for layout, SS in (("flat", Sk), ("loop", S)):
            agree("fused_eval",
                  ee.fused_eval(V, SS, lengths, d_e0h, k_chunk=kch,
                                layout=layout, **kwh),
                  ee.fused_eval_plain(V, SS, lengths, d_e0h, layout=layout,
                                      **kwh), f"l={L} {layout} {pol}")
        agree("two_pass_eval", ee.two_pass_eval(V, S, lengths, d_e0h,
                                                k_chunk=kch, **kwh),
              ee.two_pass_eval_plain(V, S, lengths, d_e0h, **kwh),
              f"W ({L}, {N}) {pol}")
        for C in (Vb, top):
            agree("gain_eval", mg.gain_eval(Vb, C, cacheh, **kwh),
                  mg.gain_eval_plain(Vb, C, cacheh, **kwh),
                  f"m={C.shape[0]} {pol}")
        g, nc = mg.gain_update_eval(Vb, Vb, cacheh, w1, wv1, **kwh)
        gp, ncp = mg.gain_update_eval_plain(Vb, Vb, cacheh, w1, wv1, **kwh)
        agree("gain_update_eval", g, gp, f"gains m={N} {pol}")
        agree("gain_update_eval", nc, ncp, f"cache n={N} {pol}")
        del g, nc, gp, ncp
        cells = N * int(lengths.sum())
        half[("fused_eval", pol)] = dict(
            **kernel_ms(lambda: ee.fused_eval(V, Sk, lengths, d_e0h,
                                              k_chunk=kch, layout="flat",
                                              **kwh)),
            plain_ms=cuda_ms(lambda: ee.fused_eval_plain(
                V, Sk, lengths, d_e0h, layout="flat", **kwh), R),
            library_ms=eval_lib,
            bound=tc_bound(eval_flops, 3 * cells + 4 * N * L, eval_in + 4 * L))
        half[("fused_eval", pol)]["loop_ms"] = cuda_ms(
            lambda: ee.fused_eval(V, S, lengths, d_e0h, k_chunk=kch,
                                  layout="loop", **kwh), R)
        half[("two_pass_eval", pol)] = dict(
            **kernel_ms(lambda: ee.two_pass_eval(V, S, lengths, d_e0h,
                                                 k_chunk=kch, **kwh)),
            plain_ms=cuda_ms(lambda: ee.two_pass_eval_plain(
                V, S, lengths, d_e0h, **kwh), R),
            library_ms=eval_lib,
            bound=tc_bound(eval_flops, 3 * cells + 4 * N * L,
                           eval_in + 4 * L * N))
        half[("gain_eval", pol)] = dict(
            **kernel_ms(lambda: mg.gain_eval(Vb, Vb, cacheh, **kwh)),
            plain_ms=cuda_ms(lambda: mg.gain_eval_plain(Vb, Vb, cacheh,
                                                        **kwh), R),
            library_ms=gain_lib,
            bound=tc_bound(gain_flops, 5 * N * N, gain_in + 4 * N))
        toph = top.to(cd)
        half[("gain_eval top256", pol)] = dict(
            **kernel_ms(lambda: mg.gain_eval(Vb, top, cacheh, **kwh), 20),
            plain_ms=cuda_ms(lambda: mg.gain_eval_plain(Vb, top, cacheh,
                                                        **kwh), 20),
            library_ms=cuda_ms(lambda: Vbh @ toph.T, 20),
            bound=tc_bound(2.0 * N * 256 * DIM, 5 * N * 256,
                           4 * (N * DIM + 256 * DIM + N + 256)))
        half[("gain_update_eval", pol)] = dict(
            **kernel_ms(lambda: mg.gain_update_eval(
                Vb, Vb, cacheh, w1, wv1, cache_out=out_cache, **kwh)),
            plain_ms=cuda_ms(lambda: mg.gain_update_eval_plain(
                Vb, Vb, cacheh, w1, wv1, **kwh), R),
            library_ms=gain_lib,
            bound=tc_bound(gain_flops + 2.0 * N * DIM, 5 * N * N + 8 * N,
                           gain_in + 4 * (DIM + 1) + 4 * (N + N)))
        del Vh, Sflath, Vbh, toph
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
    return rows, half


#: Elements of the device sieve's profiled window in phase 5: the
#: profiler's processing of the trace grows with the window, which need
#: only show the kernel's time per launch and the card's busy share.
SIEVE_WINDOW = 512


def phase_end_to_end() -> dict:
    """Steady-state wall times of the main path's user calls (median of 3
    after a warm-up call), and profiles of greedy (both plans) and of a
    ``SIEVE_WINDOW``-element window of the device sieve: device busy time
    by kernel against the call's wall time."""
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
    prefix = _stream(f, None, 0)[:SIEVE_WINDOW]
    runs = {f"greedy_{mode}": functools.partial(greedy, f, K, mode=mode)
            for mode in ("device", "host")}
    # a window of the streaming path: the device sieve's first elements
    runs[f"sieve_device_{SIEVE_WINDOW}"] = functools.partial(
        sieve_streaming, f, K, order=prefix, mode="device", block_size=64)
    for name, run in runs.items():
        torch.cuda.synchronize()
        t_all = time.perf_counter()
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
                "" if busy else " (no device time in the trace: not measured)")
            + f"; {time.perf_counter() - t_all:.1f} s with the trace's "
              f"processing")
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
    # nvcc runs in its own processes: this one runs 3g's gates 1-2 meanwhile
    t0 = time.perf_counter()
    built = {}

    def build():
        try:
            built["info"] = _build.build_all()
        except BaseException as e:      # raised below, once the gates end
            built["error"] = e
        built["seconds"] = time.perf_counter() - t0

    builder = threading.Thread(target=build, name="nvcc")
    builder.start()
    log("[1b] phase 3g's fp32 gates 1-2 while the kernels build (they "
        "launch none of the port's kernels)")
    try:
        phase_lm_gates()
    finally:
        builder.join()
    if "error" in built:
        raise built["error"]
    info = built["info"]
    log(f"    built {sorted(info)} in {built['seconds']:.1f} s; the build "
        f"and the gates {time.perf_counter() - t0:.1f} s")
    for nm, rec in sorted(info.items()):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", rec["log"])]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", rec["log"]))
        log(f"    {nm}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes {spills}")
    log(f"    tensor-core instructions (HGMMA / HMMA in cuobjdump -sass) per "
        f"source and policy: {json.dumps(sass_gate())} (gated: every bf16 "
        f"and fp16 instance has some, no other kernel any)")

    log("[2] kernels vs plain versions (and the math oracle) on the card")
    t0 = time.perf_counter()
    check = Checker()
    phase_kernels(check)
    identical = phase_kernels_batched(check)
    phase_kernels_sieve(check)
    phase_segment_edges(check)
    report_kernel_checks(check)
    phase_invariance()
    log(f"    batched kernels: {identical} requests bit for bit equal to "
        f"their unbatched launches (gains and folded cache); phase "
        f"{time.perf_counter() - t0:.1f} s")

    log("[3] main path at the paper's size")
    t0 = time.perf_counter()
    ops.LAUNCHES.clear()
    walls = phase_main_path()
    main_launches = dict(ops.LAUNCHES)
    log(f"    launches: {json.dumps(main_launches)}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    log("[3b] multi-tenant serving (SelectionService, run_selection_batch)")
    t0 = time.perf_counter()
    serve_walls, V64, Vpaper, serve_launches, serve_shapes = phase_serving()
    walls.update(serve_walls)
    log(f"    phase {time.perf_counter() - t0:.1f} s")
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
    log(f"[3h] LM serving on a mesh ({', '.join(LM_MESH)}; "
        f"{LM_MESH_SHAPE} gloo ranks on cuda:0, then one NCCL rank; bf16), "
        f"and [3i] LM training on a {LM_MESH_TRAIN_SHAPE} mesh over the "
        f"same ranks")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ops.LAUNCHES.clear()
    mesh_train_launches = phase_lm_mesh()["gain_eval_launches"]
    log(f"    launches of the port's kernels in this process: "
        f"{json.dumps(dict(ops.LAUNCHES))} (the LM path has none; 3i's "
        f"ranks launched gain_eval {mesh_train_launches}); phase "
        f"{time.perf_counter() - t0:.1f} s")
    if not all(mesh_train_launches):
        raise AssertionError("the LM mesh training path launched no "
                             "gain_eval on a rank")
    peaks = peaks_for(torch.cuda.get_device_name(0))
    log(f"[3g] LM training with curation ({LM_TRAIN_FULL['arch']} at full "
        f"width, bf16; gates 1-2 at LM_CUT, fp32, ran in [1b])")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ops.LAUNCHES.clear()
    train_report = phase_lm_training(peaks)
    log(f"    launches over the phase: {json.dumps(dict(ops.LAUNCHES))}; "
        f"phase {time.perf_counter() - t0:.1f} s")
    log(f"[3j] the production dry run against one real step of 3g's cell "
        f"({LM_TRAIN_FULL['arch']}, {LM_TRAIN_FULL['B']} x "
        f"{LM_TRAIN_FULL['S']}, bf16, remat; the placed step on a "
        f"{LM_DRYRUN_MESH} mesh)")
    dry = phase_lm_dryrun(train_report, peaks)
    log(f"    dry run = the real step on one NCCL rank, under the same "
        f"counters: FLOPs {dry['flops']:.6e}, bytes accessed "
        f"{dry['bytes_accessed']:.6e} in {dry['aten_ops']} ops, the step's "
        f"live-storage peak {dry['temp_bytes']} B, collectives "
        f"{json.dumps(dry['collectives'])}; argument bytes: dry run = the "
        f"real state's and batch's nbytes = {dry['argument_bytes']}")
    log(f"    peak (not gated): predicted {dry['predicted_peak_bytes']} B "
        f"(arguments + {dry['predicted_temp_bytes']} B of the step's live "
        f"storage), the real step's max_memory_allocated over the "
        f"{dry['memory_allocated_before']} B held before its state "
        f"{dry['real_step_peak_bytes']} B, 3g's over train() "
        f"{dry['phase_3g_max_memory_allocated']} B")
    log(f"    roofline (predicted from the H100 data-sheet peaks "
        f"{json.dumps(peaks)}; not gated): {json.dumps(dry['roofline'])}, "
        f"against 3g's "
        f"{dry['phase_3g_ms_per_step']:.1f} ms a step: "
        f"{dry['share_of_bound_reached']:.3f} of the unfused eager step's "
        f"bound reached, {dry['share_of_floor_bound_reached']:.3f} of the "
        f"function's (its memory floor "
        f"{dry['roofline']['memory_floor_bytes']} B); "
        f"lm_train_flops {dry['lm_train_flops']:.6e} = "
        f"{dry['lm_train_flops_over_counted']:.4f} x the counted FLOPs")
    log(f"    report: {json.dumps(dry)}")
    log(f"    phase {dry['seconds']:.1f} s (the meta run "
        f"{dry['meta_run_s']:.1f} s)")
    log("[3k] the reference's property suites and top-level examples on the "
        "card ((a) kernels at the suites' shapes, (b) the invariants on the "
        "cuda backend, (c) both example twins)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ops.LAUNCHES.clear()
    suite_seconds = phase_suites()
    suite_launches = dict(ops.LAUNCHES)
    log(f"    launches over the phase: {json.dumps(suite_launches)}; seconds "
        f"{json.dumps({k: round(v, 1) for k, v in suite_seconds.items()})}; "
        f"phase {time.perf_counter() - t0:.1f} s")
    missing = [k for k in KERNELS if not suite_launches.get(k)]
    if missing:
        raise AssertionError(f"phase 3k launched no {missing}")
    # each path's own launches: the main path's four kernels, the serving
    # path's two, the streaming path's two
    launches = {k: main_launches.get(k, 0) for k in MAIN_KERNELS}
    launches.update({k: serve_launches.get(k, 0) for k in SERVING_KERNELS})
    launches.update({k: stream_launches.get(k, 0) for k in STREAM_KERNELS})
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main, serving and streaming paths launched no "
                             f"{missing}")
    if not train_report["gain_eval_launches"]:
        raise AssertionError("the LM training path launched no gain_eval")

    log("[4] timing at the main path's shapes (fp32, then bf16 and fp16; "
        "CUDA events)")
    t0 = time.perf_counter()
    rows, half = phase_timing(peaks, V64, Vpaper, serve_shapes)
    del V64, Vpaper
    log("    rows 1-7 at bf16 and fp16 (tensor cores; fp32 operands, as the "
        "main path passes them): kernel ms (q1-q3), plain ms, cuBLAS in the "
        "compute dtype ms, bound ms (by)")
    for (name, pol), r in half.items():
        extra = {k: v for k, v in r.items() if k in ("loop_ms",)}
        log(f"      {name} {pol}: {r['ms']:.4f} ({r['ms_q1']:.4f}-"
            f"{r['ms_q3']:.4f}), plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.4f}, bound {r['bound'][0]:.4f} "
            f"({r['bound'][1]}) {json.dumps(extra)}")
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
            # the tensor-core instances (rows 1-7 at bf16 and fp16; rows
            # 8-9 are fp32 only)
            **({"half": {pol: {
                "ms": half[name, pol]["ms"],
                "plain_ms": half[name, pol]["plain_ms"],
                "library_ms": half[name, pol]["library_ms"],
                "bound_ms": half[name, pol]["bound"][0],
                "bound_by": half[name, pol]["bound"][1]}
                for pol in ("bf16", "fp16")}}
               if (name, "bf16") in half else {}),
            # launches in the contract phase (3e)
            "audit_launches": audit_launches.get(name, 0),
            # launches over phase 3k (the suites' shapes and invariants,
            # the example twins)
            "suites_launches": suite_launches[name],
            # launches over phase 3g's train() (curated qwen3-0.6b)
            **({"train_launches": train_report["gain_eval_launches"],
                # per rank of phase 3i's curated window on the mesh
                "mesh_train_launches": mesh_train_launches}
               if name == "gain_eval" else {}),
            # per rank of the mesh phase (3d), for the kernels it runs
            **({"mesh_launches": [mesh_launches[q].get(name, 0)
                                  for q in sorted(mesh_launches)]}
               if name in MESH_KERNELS else {})})
    log(f"    main-path first-call wall times (s): {json.dumps(walls)}; "
        f"phase {time.perf_counter() - t0:.1f} s")
    log("[5] end to end at the paper's size (steady state)")
    t0 = time.perf_counter()
    log(f"    {json.dumps(phase_end_to_end())}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"    total {time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
