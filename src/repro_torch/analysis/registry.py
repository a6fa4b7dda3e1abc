"""Audit-case grid: every contract × its documented signature space.

The registry turns each :mod:`repro_torch.analysis.contracts` declaration
into concrete cases over the grid the engine documents — execution plans ×
round strategies × the device-eligible function zoo × backends × precision
policies × batch sizes — and computes the *exact* numbers the contract's
prose implies for that case: host syncs, kernel launches and collectives
per round, the largest collective operand, new cache buffers per round and
the precision threshold. The arithmetic lives here, beside its derivation,
so every expected count traces back to the code path that issues it; the
auditor (:mod:`repro_torch.analysis.report`) only compares.

The grid is the reference's (``repro/analysis/registry.py``): the same
shapes, function specs, kinds and policies, and the same labels with the
backend part mapped (``jnp`` → ``torch``, ``pallas_interpret`` →
``cuda``), so a case can be found in both packages. On CPU tensors the
``cuda`` backend runs the kernels' plain versions; on the card it runs the
kernels. A case builds real inputs from a seed; the report runs the
entry point at k = K, K + 1 and K + 2 rounds under the census
(:func:`report.evaluate_case`).

Mesh cases run on the default process group (a 1-D mesh over it): the CLI
starts a one-rank gloo group when none exists, and the mesh test runs them
on two ranks. Their numbers depend on the number of ranks p only through
the sharded pool's take block (n/p rows at most) and GreeDi's p + 1
all-gathers per round.

The separate :func:`runtime_checks` list runs the claims a census of one
call cannot see: no kernel rebuild on a second same-shape call, the cache
buffers and the sieve table reused in place, the overlapped offer equal to
the serialized one, and the service's one dispatch per bucket.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import functions as fx
from repro_torch.core.functions import FnSpec

# --- grid shapes (the reference's) -----------------------------------------
N = 48          #: ground-set rows
D = 8           #: feature dim
K = 5           #: selection rounds
M_STOCH = 16    #: stochastic per-round sample width
BLOCK_M = 16    #: torch-backend candidate block (48/16 = 3 blocks ≠ K)
TOP_B = 8       #: CELF re-score width
B_BLOCK = 6     #: stream block (the streaming rounds: one per element)
SIEVE_K = 4
SIEVE_EPS = 0.2
SIEVE_P = 3     #: stream partitions in the batched case

#: The device-plan function zoo (DEVICE_PLAN_ELIGIBLE), as FnSpecs.
SPECS = {
    "exemplar": FnSpec(),
    "facility_location": FnSpec("facility_location"),
    "graph_cut": FnSpec("graph_cut", lam=0.5),
    "saturated_coverage": FnSpec("saturated_coverage", sat=0.25),
}

BACKENDS = ("torch", "cuda")
POLICIES = ("fp32", "bf16")
KINDS = ("dense", "stochastic", "lazy")
#: the reference's label spelling of each backend
REF_BACKEND = {"torch": "jnp", "cuda": "pallas_interpret"}


@dataclasses.dataclass
class Expect:
    """Exact expected numbers for one case, per round. A CELF round adds
    the ``*_per_iteration`` numbers once per re-score iteration of its
    inner loop; the census counts the iterations by their one ``sort``
    each."""

    rounds: int
    syncs: int = 0                     #: host syncs per round
    syncs_per_iteration: int = 0
    #: host syncs and host-to-device copies of the whole call (None: not
    #: checked — CELF)
    syncs_total: Optional[int] = 0
    launches: dict = dataclasses.field(default_factory=dict)
    launches_per_iteration: dict = dataclasses.field(default_factory=dict)
    #: scored batches per round (the contract's launch budget is per batch)
    batches_per_round: int = 1
    collectives: Counter = dataclasses.field(default_factory=Counter)
    collectives_per_iteration: Counter = dataclasses.field(
        default_factory=Counter)
    max_collective_bytes: Optional[int] = None
    #: new cache buffers the kernels read or write per round (None: no
    #: kernel reads the cache on this route)
    cache_allocs: Optional[int] = None
    uniform: bool = True
    #: half → fp32 widens of at least this many elements are violations
    #: (None: fp32 policy, not checked): 2·B·N + 16, the reference's bound —
    #: O(B·n) accumulators may widen, a distance tile (B·n, ≥ 8) may not
    widen_elems: Optional[int] = None
    require_half: bool = False
    #: peak device bytes over the call (the card only)
    memory_bound: Optional[int] = None
    #: the sieve table must come out as the very tensor that went in
    table_in_place: bool = False
    derivation: str = ""


@dataclasses.dataclass
class AuditCase:
    contract: str
    label: str
    #: k' -> (fn, args, kwargs): the entry point at k' rounds (or k'
    #: stream elements), its inputs built on ``device`` from a seed
    build: Callable[[int], tuple]
    expect: Expect
    mesh: bool = False

    @property
    def ref_label(self) -> str:
        """The reference registry's label of the same case."""
        parts = self.label.split(".")
        return ".".join(REF_BACKEND.get(p, p) for p in parts)

    @property
    def backend(self) -> str:
        return next((p for p in self.label.split(".") if p in BACKENDS), "")

    @property
    def kind(self) -> str:
        return next((p for p in self.label.split(".") if p in KINDS), "")


def _eff_backend(spec: FnSpec, backend: str) -> str:
    # run_selection's normalization: a function with no kernel template
    # (saturated coverage) scores through torch on any backend
    return backend if fx.kernel_template(spec) is not None else "torch"


def _m_scored_max(kind: str) -> int:
    # widest single scored batch: dense scores all n every round, stochastic
    # its m-row sample, lazy seeds bounds over all n then re-scores top_b
    return {"dense": N, "stochastic": M_STOCH, "lazy": N}[kind]


def _precision(policy: str, batch: int = 1):
    if policy != "bf16":
        return None, False
    return 2 * batch * N + 16, True


def _function(fname, backend, policy, device, seed=0):
    from repro_torch.core.evaluator import EvalConfig

    rng = np.random.default_rng(seed)
    V = torch.as_tensor(rng.standard_normal((N, D)).astype(np.float32),
                        device=device)
    cfg = EvalConfig(backend="cuda" if backend == "cuda" else "torch",
                     policy=policy)
    spec = SPECS[fname]
    params = {k: v for k, v in (("lam", spec.lam), ("sat", spec.sat)) if v}
    return fx.FUNCTIONS[fname](V, cfg, device=device, **params)


def _cand(kind, k, device, batch=None):
    """Candidate rows at k rounds: dense (1, N), stochastic (k, M_STOCH)
    — the first K rows the same at every k — lazy (1, 0)."""
    if kind == "dense":
        c = np.arange(N)[None, :]
    elif kind == "stochastic":
        rng = np.random.default_rng(7)
        rows = [rng.permutation(N)[:M_STOCH] for _ in range(K + 2)]
        c = np.stack(rows[:k])
    else:
        c = np.zeros((1, 0), np.int64)
    if batch is not None:
        c = np.broadcast_to(c[None], (batch,) + c.shape)
    return torch.as_tensor(np.array(c, np.int64), device=device)


def _kernel_names(spec: FnSpec, be: str, batched: bool, fused: bool):
    """(round kernel, re-score kernel) names on this route."""
    if be != "cuda":
        return None, None
    sfx = "_batched" if batched else ""
    round_k = ("gain_update_eval" if fused and fx.kernel_fused_ok(spec)
               else "gain_eval") + sfx
    return round_k, "gain_eval" + sfx


def _rounds_expect(kind, spec, be, policy, batch, *, fused_route=True,
                   first_test=1, per_round_coll=Counter(),
                   per_iter_coll=Counter(), blocks=1, iter_blocks=1,
                   max_bytes=None, derivation="") -> Expect:
    """The per-round numbers every selection plan shares: syncs, launches
    and new cache buffers; the plan adds its collectives."""
    fused = fused_route and fx.kernel_fused_ok(spec)
    round_k, rescore_k = _kernel_names(spec, be, batch is not None, fused)
    widen, half = _precision(policy, batch or 1)
    gc = spec.name == "graph_cut"
    if be != "cuda":
        cache_allocs = None
    elif kind != "lazy" and fused:
        cache_allocs = 0            # the fused kernel's two ping-pong buffers
    else:
        # an explicit fold writes a fresh cache once per round, which the
        # kernel then reads; graph cut's kernel reads its static row_aux
        cache_allocs = 0 if gc else 1
    if kind == "lazy":
        return Expect(
            rounds=K, syncs=first_test, syncs_per_iteration=1,
            syncs_total=None,
            launches_per_iteration={rescore_k: iter_blocks} if rescore_k
            else {},
            collectives=per_round_coll, collectives_per_iteration=per_iter_coll,
            batches_per_round=iter_blocks, max_collective_bytes=max_bytes,
            cache_allocs=cache_allocs, uniform=False, widen_elems=widen,
            require_half=half, derivation=derivation)
    return Expect(
        rounds=K, launches={round_k: blocks} if round_k else {},
        batches_per_round=blocks, collectives=per_round_coll,
        max_collective_bytes=max_bytes, cache_allocs=cache_allocs,
        widen_elems=widen, require_half=half, derivation=derivation)


# --- single-device selection ------------------------------------------------


def _device_case(kind, fname, backend, policy, device, batch=None):
    from repro_torch.core import engine as eng

    spec = SPECS[fname]
    be = _eff_backend(spec, backend)
    bm = min(BLOCK_M, N)

    def build(k):
        pol = _function(fname, be, policy, device).cfg.resolved_policy()
        kw = dict(fn=spec, kind=kind, k=k, top_b=TOP_B,
                  distance="sqeuclidean", policy=pol, block_m=bm,
                  backend=be, rbf_gamma=None)
        if batch is None:
            f = _function(fname, be, policy, device)
            args = (f.V, f.cache_seed, f.row_aux, _cand(kind, k, device),
                    torch.zeros((D,), dtype=f.V.dtype, device=device))
            return eng._select_scan, args, kw
        fs = [_function(fname, be, policy, device, seed=b)
              for b in range(batch)]
        pl = eng._stack_batch_payload(fs)
        args = (pl["V"], pl["seed"], pl["aux"], _cand(kind, k, device, batch),
                pl["w0"], torch.full((batch,), k, dtype=torch.long,
                                     device=device))
        return eng._select_scan_batched, args, kw

    # Single device: no collective. A dense/stochastic round on the cuda
    # route is ONE fused launch (exemplar, facility location) or one
    # gain_eval after an explicit fold (graph cut); a CELF round folds once
    # and re-scores top_b per iteration (one gain_eval each), testing its
    # stopping rule once per iteration plus the breaking test.
    exp = _rounds_expect(kind, spec, be, policy, batch,
                         derivation="single device: collective-free")
    name = "engine.select_scan" if batch is None \
        else "engine.select_scan_batched"
    return AuditCase(
        contract=name,
        label=f"{'device' if batch is None else f'batched[B={batch}]'}"
              f".{kind}.{fname}.{be}.{policy}",
        build=build, expect=exp)


# --- mesh-sharded selection -------------------------------------------------


def _shards():
    from repro_torch.core import distributed

    return distributed.resolve_mesh(None, ("data",))


def _sharded_case(kind, fname, backend, policy, pool_plan, device, p,
                  batch=None):
    from repro_torch.core import distributed as dist
    from repro_torch.core import engine as eng

    spec = SPECS[fname]
    be = _eff_backend(spec, backend)
    gc = int(fname == "graph_cut")
    plan = "device_sharded" if pool_plan == "replicated" \
        else "device_sharded_pool"
    nb = batch or 1

    # run_sharded_selection's take-block cap on the sharded pool: n/p rows
    bm = BLOCK_M if pool_plan == "replicated" \
        else min(BLOCK_M, max(8, -(-N // p)))

    def build(k):
        sh = _shards()
        pol = _function(fname, be, policy, device).cfg.resolved_policy()
        kw = dict(fn=spec, kind=kind, k=k, top_b=TOP_B, n_total=N,
                  block_m=bm, distance="sqeuclidean", policy=pol,
                  backend=be, rbf_gamma=None, pool_plan=pool_plan)
        if batch is None:
            f = _function(fname, be, policy, device)
            entry = dist._placed_sharded(f, sh)
            run = dist.make_selection_scan(sh, sh.axes, **kw)
            pool = f.V if pool_plan == "replicated" else entry["V_sh"]
            args = (entry["V_sh"], pool, entry["seed_sh"], entry["aux_sh"],
                    _cand(kind, k, device),
                    torch.zeros((D,), dtype=f.V.dtype, device=device))
            return run, args, {}
        fs = [_function(fname, be, policy, device, seed=b)
              for b in range(batch)]
        st = dist.stage_sharded_batch(fs, mesh=sh, pool_plan=pool_plan)
        run = dist.make_selection_scan_batched(sh, sh.axes, **kw)
        pool = st["pool"] if pool_plan == "replicated" else st["V"]
        args = (st["V"], pool, st["seed"], st["aux"],
                _cand(kind, k, device, batch), st["w0"],
                torch.full((batch,), k, dtype=torch.long, device=device))
        return run, args, {}

    # Collectives per round, from make_selection_scan(_batched)'s body:
    #   every scored batch: ONE all-gather (ordered_sum) of the (B, m + 1)
    #     gain partials and stat sums;
    #   graph cut's fold: ONE owner gather (all-reduce) of the winner's
    #     entry, (B,) batched;
    #   sharded pool: one owner gather per candidate block of bm columns
    #     and one for the round's winner row.
    # CELF: per re-score iteration, the scored batch's collectives; per
    # round, the fold's and the winner's. The batched mesh CELF takes its
    # values from the re-scores and tests its stopping rule from the
    # second iteration on: no breaking test beyond the iterations.
    m = {"dense": N, "stochastic": M_STOCH, "lazy": TOP_B}[kind]
    if pool_plan == "replicated":
        per_batch = Counter({"allgather_": 1})
        per_round = Counter({"allreduce_": gc})
        blocks = 1
        max_bytes = nb * (_m_scored_max(kind) + 1) * 4
    else:
        blocks = -(-m // bm)
        per_batch = Counter({"allgather_": 1, "allreduce_": blocks})
        per_round = Counter({"allreduce_": 1 + gc})
        max_bytes = max(nb * (_m_scored_max(kind) + 1) * 4, nb * bm * D * 4)
    first_test = 0 if batch is not None else 1
    if kind == "lazy":
        exp = _rounds_expect(
            kind, spec, be, policy, batch, first_test=first_test,
            per_round_coll=+per_round, per_iter_coll=+per_batch,
            iter_blocks=blocks if pool_plan == "sharded" else 1,
            max_bytes=max_bytes, derivation="CELF over the mesh")
    else:
        exp = _rounds_expect(
            kind, spec, be, policy, batch,
            fused_route=pool_plan == "replicated",
            per_round_coll=+(per_round + per_batch), blocks=blocks,
            max_bytes=max_bytes, derivation="one scored batch per round")
    exp.derivation += f"; {plan}: bound {max_bytes} B"
    bs = "" if batch is None else f".batched[B={batch}]"
    return AuditCase(
        contract=f"distributed.selection_scan{'_batched' if batch else ''}"
                 f"[{pool_plan}]",
        label=f"{plan}{bs}.{kind}.{fname}.{be}.{policy}",
        build=build, expect=exp, mesh=True)


def _greedi_case(fname, backend, policy, device, p):
    from repro_torch.core import distributed as dist

    spec = SPECS[fname]
    be = _eff_backend(spec, backend)
    gc = int(fname == "graph_cut")

    def build(k):
        sh = _shards()
        f = _function(fname, be, policy, device)
        entry = dist._placed_sharded(f, sh)
        run = dist.make_greedi_scan(
            sh, sh.axes, fn=spec, k=k, n_total=N, block_m=BLOCK_M,
            distance="sqeuclidean", policy=f.cfg.resolved_policy(),
            backend=be, rbf_gamma=None)
        return run, (entry["V_sh"], entry["seed_sh"], entry["aux_sh"],
                     torch.zeros((D,), dtype=f.V.dtype, device=device)), {}

    # A round more adds: one phase-1 round (no collective); p folds of the
    # global valuation of the partition solutions (one all-gather of the
    # stat sum each, graph cut one owner gather each); one merge round
    # (one all-gather of gains + stat, graph cut one owner gather). The
    # largest operand is a rank's (k, d) solution rows in the all-gather of
    # the p·k pool, or the merge round's (p·k + 1) gains.
    exp = _rounds_expect("dense", spec, be, policy, None,
                         derivation="GreeDi")
    if exp.launches:
        exp.launches = {k: 2 for k in exp.launches}   # phase 1 + merge
    exp.batches_per_round = 2
    exp.collectives, exp.max_collective_bytes = greedi_collectives(p, bool(gc))
    return AuditCase(
        contract="distributed.greedi_scan",
        label=f"greedi.dense.{fname}.{be}.{policy}",
        build=build, expect=exp, mesh=True)


def greedi_collectives(p: int, graph_cut: bool) -> tuple[Counter, int]:
    """GreeDi's collectives per round and its byte bound at p ranks."""
    gc = int(graph_cut)
    return (+Counter({"allgather_": p + 1, "allreduce_": gc * (p + 1)}),
            max(K * D * 4, (p * K + 1) * 4, K * 8))


# --- streaming --------------------------------------------------------------


def _stream_case(variant, fname, backend, device, plan):
    from repro_torch.core import streaming as st

    fspec = SPECS[fname]
    be = backend if fx.kernel_template(fspec) is not None else "torch"
    rng = np.random.default_rng(11)
    X = rng.standard_normal((B_BLOCK + 2, D)).astype(np.float32)

    def build(k):
        f = _function(fname, be, "fp32", device)
        if plan == "batched":
            eng = st.make_batched_sieve_engine(f, SIEVE_K, SIEVE_EPS,
                                               SIEVE_P, variant=variant,
                                               backend=be)
            dm = eng._distance_rows(torch.as_tensor(X[:k], device=device))
            dmb = torch.stack([dm] * SIEVE_P, dim=1).contiguous()
            idx = torch.arange(k * SIEVE_P, dtype=torch.int32,
                               device=device).reshape(k, SIEVE_P)
            valid = torch.ones((k, SIEVE_P), dtype=torch.bool, device=device)
            return st._offer_block_batched, (
                eng.spec, eng._c, eng.states, idx, dmb, valid, k), {}
        mesh = _shards() if plan == "sharded" else None
        eng = st.make_sieve_engine(f, SIEVE_K, SIEVE_EPS, variant=variant,
                                   mode="device", backend=be, mesh=mesh)
        dm = eng._distance_rows(torch.as_tensor(X[:k], device=device))
        idx = torch.arange(k, dtype=torch.int32, device=device)
        return eng._offer_fn, (eng.state, eng._c, idx, dm, k), {}

    spec = st.make_spec(SIEVE_K, SIEVE_EPS, variant, backend=be, fn=fspec)
    kernel = None
    if be == "cuda":
        kernel = "sieve_gain_eval_batched" if plan == "batched" \
            else "sieve_gain_eval"
    # Per element: no host sync; one sieve kernel launch (cuda route) whose
    # table operand is the one (S_max, n) buffer. Sharded: the element's
    # seed + table gains and (but for Salsa, which reads no values) the
    # table's stat sums in ONE all-gather of (1 + 2·S_max) floats; ++ adds
    # one all-gather of its S_max post-fold stat sums.
    coll, max_bytes = Counter(), None
    if plan == "sharded":
        coll = Counter({"allgather_": 2 if variant == "pp" else 1})
        S = spec.s_max
        max_bytes = (1 + S + (0 if variant == "salsa" else S)) * 4
    exp = Expect(rounds=B_BLOCK, launches={kernel: 1} if kernel else {},
                 collectives=coll, max_collective_bytes=max_bytes,
                 cache_allocs=0 if kernel else None, table_in_place=True,
                 derivation="one element per round")
    contract = {"device": "streaming.offer_scan",
                "sharded": "streaming.offer_scan[sharded]",
                "batched": "streaming.offer_scan_batched"}[plan]
    plan_lbl = f"batched[P={SIEVE_P}]" if plan == "batched" else plan
    return AuditCase(contract=contract,
                     label=f"sieve_{variant}.{plan_lbl}.{fname}.{be}",
                     build=build, expect=exp, mesh=plan == "sharded")


# --- memory-bounded cases (the card only) ------------------------------------

#: The reference's shapes for the analytic-byte check: the full (n, m)
#: distance matrix (4 MiB) is an order of magnitude above the blocked tile.
MEM_N, MEM_D, MEM_BM = 1024, 8, 64


def tile_bound(n: int, bm: int, batch: int = 1) -> int:
    """The working-set bound of a selection call on the ``torch`` route:
    6 (B·n, bm) float32 tiles + 1 MiB (the reference's bound); a full
    (n, m) matrix of a regression costs B·n·m·4 and trips it."""
    return 6 * batch * n * bm * 4 + (1 << 20)


#: Slack of :func:`kernel_bound`: the O(B·n) vectors of a round (the taken
#: mask, CELF's bounds, the fold's distance column) and the caching
#: allocator's rounding (a large block keeps an unsplit tail under 1 MiB).
KERNEL_SLACK = 8 << 20


def kernel_bound(n: int, m: int, d: int, elem: int, batch: int = 1,
                 fresh_candidates: bool = False) -> int:
    """The working-set bound of a selection call on the ``cuda`` route: B
    requests of (n, d) payloads of ``elem`` bytes an element, m candidates
    scored per launch. The sum of what the kernel path holds:

    * the gain kernels' partials workspace, B·⌈n/SEG⌉·m·4;
    * the gathered candidate payload, B·m·d·elem; twice when the
      candidates change every round (stochastic: the next round's gather
      is made while this round's is still held);
    * the two ping-pong caches, 2·B·n·4, and the gains with their masked
      copy, 2·B·m·4;
    * the explicit fold's ‖v‖² (the final trajectory point; CELF folds so
      every round): one payload-sized fp32 temporary, B·n·d·4, and one
      widened row block of a half payload, WIDEN_BLOCK_ROWS·d·4;
    * :data:`KERNEL_SLACK`.

    A full (n, m) fp32 matrix, B·n·m·4 (10 GB at n = m = 50 000), is over
    it by two orders of magnitude."""
    from repro_torch.core.distances import WIDEN_BLOCK_ROWS
    from repro_torch.kernels._build import n_segments

    gathered = batch * m * d * elem * (2 if fresh_candidates else 1)
    return (batch * n_segments(n) * m * 4 + gathered + 2 * batch * n * 4
            + 2 * batch * m * 4 + batch * n * d * 4 + WIDEN_BLOCK_ROWS * d * 4
            + KERNEL_SLACK)


def _memory_case(device, batch=None):
    from repro_torch.core import engine as eng
    from repro_torch.core.evaluator import EvalConfig

    nb = batch or 1

    def build(k):
        rng = np.random.default_rng(3)
        fs = [fx.ExemplarClustering(
            torch.as_tensor(rng.standard_normal((MEM_N, MEM_D)).astype(
                np.float32), device=device), EvalConfig(), device=device)
            for _ in range(nb)]
        kw = dict(fn=FnSpec(), kind="dense", k=k, top_b=0,
                  distance="sqeuclidean", policy=fs[0].cfg.resolved_policy(),
                  block_m=MEM_BM, backend="torch", rbf_gamma=None)
        cand = torch.arange(MEM_N, device=device)[None, :]
        if batch is None:
            f = fs[0]
            return eng._select_scan, (f.V, f.cache_seed, f.row_aux, cand,
                                      torch.zeros(MEM_D, device=device)), kw
        pl = eng._stack_batch_payload(fs)
        return eng._select_scan_batched, (
            pl["V"], pl["seed"], pl["aux"],
            cand[None].expand(batch, 1, MEM_N).contiguous(), pl["w0"],
            torch.full((batch,), k, dtype=torch.long, device=device)), kw

    return AuditCase(
        contract="engine.select_scan" if batch is None
        else "engine.select_scan_batched",
        label=f"memory.{'device' if batch is None else f'batched[B={batch}]'}"
              f".dense.exemplar.torch.fp32",
        build=build,
        expect=Expect(rounds=K, memory_bound=tile_bound(MEM_N, MEM_BM, nb),
                      derivation="blocked (B·n, bm) tiles, never (n, m)"))


# --- paper-size cases (the card) ----------------------------------------------


def paper_selection_case(kind: str, policy: str, X, device, *, k: int = 10,
                         eps: float = 0.1, batch: int = 1) -> AuditCase:
    """``engine.select_scan`` (``batch`` = 1) or ``select_scan_batched`` on
    exemplar clustering of the payload ``X`` (n, d), or of each of the
    ``batch`` payloads of a list ``X``, at k rounds on the
    ``cuda`` backend, the candidates the optimizers would pass (dense: all
    n; stochastic: the ⌈n/k·ln(1/ε)⌉ sample of ``stochastic_greedy``;
    lazy: the default top_b of 256, seeded by one launch over all n). Its
    memory bound is :func:`kernel_bound`."""
    from repro_torch.core import engine as eng
    from repro_torch.core.evaluator import EvalConfig

    Xs = list(X) if isinstance(X, (list, tuple)) else [X] * batch
    n, d = Xs[0].shape
    m = {"dense": n, "stochastic": min(n, int(np.ceil(n / k * np.log(
        1.0 / eps)))), "lazy": n}[kind]
    Vs = [torch.as_tensor(x, device=device) for x in Xs]
    cfg = EvalConfig(backend="cuda", policy=policy)

    def build(kk):
        fs = [fx.ExemplarClustering(V, cfg, device=device) for V in Vs]
        rng = np.random.default_rng(0)
        if kind == "dense":
            cand = np.arange(n)[None, :]
        elif kind == "stochastic":
            cand = np.stack([rng.permutation(n)[:m] for _ in range(kk)])
        else:
            cand = np.zeros((1, 0), np.int64)
        kw = dict(fn=FnSpec(), kind=kind, k=kk,
                  top_b=min(256, n), distance="sqeuclidean",
                  policy=cfg.resolved_policy(),
                  block_m=eng._device_block_m(n, m, n_batch=batch),
                  backend="cuda", rbf_gamma=None)
        if batch == 1:
            f = fs[0]
            return eng._select_scan, (
                f.V, f.cache_seed, f.row_aux,
                torch.as_tensor(cand, device=device),
                torch.zeros(d, device=device)), kw
        pl = eng._stack_batch_payload(fs)
        c = np.broadcast_to(cand[None], (batch,) + cand.shape)
        return eng._select_scan_batched, (
            pl["V"], pl["seed"], pl["aux"],
            torch.as_tensor(np.array(c), device=device), pl["w0"],
            torch.full((batch,), kk, dtype=torch.long, device=device)), kw

    exp = _rounds_expect(kind, FnSpec(), "cuda", policy,
                         None if batch == 1 else batch)
    exp.rounds = k
    if exp.widen_elems is not None:
        exp.widen_elems = 2 * batch * n + 16
    exp.memory_bound = kernel_bound(n, m, d, Vs[0].element_size(), batch,
                                    fresh_candidates=kind == "stochastic")
    name = "engine.select_scan" if batch == 1 \
        else "engine.select_scan_batched"
    where = "device" if batch == 1 else f"batched[B={batch}]"
    return AuditCase(contract=name,
                     label=f"paper.{where}.{kind}.exemplar.cuda.{policy}",
                     build=build, expect=exp)


def paper_sieve_case(X, stream, device, *, k: int = 10,
                     eps: float = 0.1) -> AuditCase:
    """``streaming.offer_scan``: the device sieve engine of exemplar
    clustering of ``X`` on the ``cuda`` backend, offered the stream rows
    ``stream`` as one block (its elements are the rounds: the census runs
    len(stream) − 2, − 1 and all of them)."""
    from repro_torch.core import streaming as st
    from repro_torch.core.evaluator import EvalConfig

    Vt = torch.as_tensor(X, device=device)
    rows = torch.as_tensor(stream, device=device)

    def build(kk):
        f = fx.ExemplarClustering(Vt, EvalConfig(backend="cuda"),
                                  device=device)
        engine = st.make_sieve_engine(f, k, eps, mode="device")
        dm = engine._distance_rows(rows[:kk])
        idx = torch.arange(kk, dtype=torch.int32, device=device)
        return engine._offer_fn, (engine.state, engine._c, idx, dm, kk), {}

    return AuditCase(
        contract="streaming.offer_scan",
        label=f"paper.sieve_sieve.device.exemplar.cuda[{len(stream)}]",
        build=build,
        expect=Expect(rounds=len(stream) - 2,
                      launches={"sieve_gain_eval": 1}, cache_allocs=0,
                      table_in_place=True))


def paper_sharded_case(X, device, *, k: int = 10) -> AuditCase:
    """``distributed.selection_scan[replicated]``: dense greedy of exemplar
    clustering of ``X`` under ``device_sharded`` on the default group,
    every rank running it."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import engine as eng
    from repro_torch.core.evaluator import EvalConfig

    n = X.shape[0]
    Vt = torch.as_tensor(X, device=device)

    def build(kk):
        sh = _shards()
        f = fx.ExemplarClustering(Vt, EvalConfig(backend="cuda"),
                                  device=device)
        entry = dist._placed_sharded(f, sh)
        run = dist.make_selection_scan(
            sh, sh.axes, fn=FnSpec(), kind="dense", k=kk, top_b=0,
            n_total=n, block_m=eng._device_block_m(sh.n_loc(n), n),
            distance="sqeuclidean", policy=f.cfg.resolved_policy(),
            backend="cuda", rbf_gamma=None)
        return run, (entry["V_sh"], f.V, entry["seed_sh"], entry["aux_sh"],
                     torch.arange(n, device=device)[None, :],
                     torch.zeros(X.shape[1], device=device)), {}

    return AuditCase(
        contract="distributed.selection_scan[replicated]",
        label="paper.device_sharded.dense.exemplar.cuda.fp32",
        build=build,
        expect=Expect(rounds=k, launches={"gain_update_eval": 1},
                      collectives=Counter({"allgather_": 1}),
                      max_collective_bytes=(n + 1) * 4, cache_allocs=0),
        mesh=True)


# --- the grid ---------------------------------------------------------------


def build_cases(device="cpu", quick: bool = False, mesh: bool = True,
                p: Optional[int] = None,
                memory: Optional[bool] = None) -> list[AuditCase]:
    """The audit grid on ``device``. ``quick`` keeps, per contract and
    kind, the first case on the ``cuda`` backend (else the first case);
    ``mesh=False`` leaves out the cases that need a process group; ``p``
    is the number of ranks the mesh cases run on (default: the default
    group's size, or 1); ``memory`` keeps the two memory cases, whose
    claim is the peak device memory (default: on the card only)."""
    import torch.distributed as dist

    device = torch.device(device)
    if memory is None:
        memory = device.type == "cuda"
    if p is None:
        p = dist.get_world_size() if dist.is_initialized() else 1
    cases: list[AuditCase] = []
    for kind in KINDS:
        for fname in SPECS:
            for backend in BACKENDS:
                for policy in POLICIES:
                    if _eff_backend(SPECS[fname], backend) != backend:
                        continue    # satcov normalizes to torch: skip the dup
                    cases.append(_device_case(kind, fname, backend, policy,
                                              device))
                    for batch in (1, 64):
                        cases.append(_device_case(kind, fname, backend,
                                                  policy, device, batch))
                    for pool_plan in ("replicated", "sharded"):
                        cases.append(_sharded_case(kind, fname, backend,
                                                   policy, pool_plan, device,
                                                   p))
                        for batch in (1, 4):
                            cases.append(_sharded_case(
                                kind, fname, backend, policy, pool_plan,
                                device, p, batch))
    for fname in SPECS:
        for backend in BACKENDS:
            for policy in POLICIES:
                if _eff_backend(SPECS[fname], backend) != backend:
                    continue
                cases.append(_greedi_case(fname, backend, policy, device,
                                          p))
    for variant in ("sieve", "pp", "salsa"):
        for fname in sorted(fx.SIEVE_ELIGIBLE):
            for backend in BACKENDS:
                if backend != "torch" and \
                        fx.kernel_template(SPECS[fname]) is None:
                    continue
                for plan in ("device", "sharded"):
                    cases.append(_stream_case(variant, fname, backend,
                                              device, plan))
                cases.append(_stream_case(variant, fname, backend, device,
                                          "batched"))
    if memory:
        cases.append(_memory_case(device))
        cases.append(_memory_case(device, batch=4))
    if not mesh:
        cases = [c for c in cases if not c.mesh]
    if quick:
        seen: dict = {}
        for c in cases:
            key = (c.contract, c.kind)
            if key not in seen or (seen[key].backend != "cuda"
                                   and c.backend == "cuda"):
                seen[key] = c
        cases = [c for c in cases if seen.get((c.contract, c.kind)) is c]
    return cases


# --- runtime checks ---------------------------------------------------------


@dataclasses.dataclass
class RuntimeCheck:
    name: str
    run: Callable[[], tuple[bool, str]]
    #: the contract this check is the audit of ("" for checks that back
    #: contracts the grid covers too)
    contract: str = ""


def _problem(device, seed, n=32, d=4, backend="cuda"):
    from repro_torch.core.evaluator import EvalConfig

    rng = np.random.default_rng(seed)
    V = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                        device=device)
    return fx.ExemplarClustering(V, EvalConfig(backend=backend),
                                 device=device), rng


def _no_rebuild(run) -> tuple[bool, str]:
    """Run twice; the second same-shape call must load no kernel library
    and build nothing."""
    from repro_torch.kernels import _build

    run()
    libs, built = set(_build._LIBS), dict(_build.BUILD_INFO)
    run()
    new = set(_build._LIBS) - libs
    rebuilt = [k for k in _build.BUILD_INFO if k not in built]
    if new or rebuilt:
        return False, f"second same-shape call loaded {sorted(new)} and " \
                      f"built {rebuilt}"
    return True, (f"second same-shape call: no rebuild, "
                  f"{len(_build._LIBS)} libraries loaded")


def _rt_retrace_device(device) -> tuple[bool, str]:
    from repro_torch.core import engine as eng

    def run():
        f, _ = _problem(device, 0)
        eng.run_selection(f, kind="dense", k=3,
                          cand_rounds=np.arange(32)[None, :], plan="device")
    return _no_rebuild(run)


def _rt_retrace_batched(device) -> tuple[bool, str]:
    from repro_torch.core import engine as eng

    def run():
        fs = [_problem(device, b)[0] for b in range(4)]
        eng.run_selection_batch(fs, kind="dense", k=3)
    return _no_rebuild(run)


def _rt_retrace_sharded(device) -> tuple[bool, str]:
    from repro_torch.core import engine as eng

    def run():
        f, _ = _problem(device, 2)
        eng.run_selection(f, kind="dense", k=3,
                          cand_rounds=np.arange(32)[None, :],
                          plan="device_sharded")
    return _no_rebuild(run)


def _rt_retrace_sieve(device) -> tuple[bool, str]:
    from repro_torch.core.streaming import make_sieve_engine

    f, rng = _problem(device, 3)
    engine = make_sieve_engine(f, 3, 0.2, variant="sieve", mode="device",
                               block_size=8)
    X = rng.standard_normal((16, 4)).astype(np.float32)
    blocks = iter([(np.arange(8), X[:8]), (np.arange(8, 16), X[8:])])
    return _no_rebuild(lambda: engine.offer(*next(blocks)))


def _rt_reuse_live(device) -> tuple[bool, str]:
    """The fused kernel's new cache goes to one of the two buffers the
    engine holds, on every round, and the function's resident seed is never
    written."""
    from repro_torch.analysis.census import take_census
    from repro_torch.core import engine as eng

    f, _ = _problem(device, 4)
    seed_before = f.cache_seed.clone()
    _, c = take_census(
        eng._select_scan, f.V, f.cache_seed, f.row_aux,
        torch.arange(32, device=device)[None, :],
        torch.zeros((4,), device=device), fn=f.spec, kind="dense", k=6,
        top_b=0, distance="sqeuclidean", policy=f.cfg.resolved_policy(),
        block_m=32, backend="cuda", rbf_gamma=None)
    if c.fresh_cache_outs:
        return False, f"{c.fresh_cache_outs} fused calls allocated their cache"
    if len(c.cache_buffers) != 2:
        return False, f"{len(c.cache_buffers)} cache buffers over 6 rounds " \
                      f"(want the 2 ping-pong buffers)"
    if not torch.equal(f.cache_seed, seed_before):
        return False, "the function's resident cache seed was written"
    return True, "6 rounds on 2 ping-pong cache buffers; resident seed intact"


def _rt_reuse_sieve(device) -> tuple[bool, str]:
    """After a block the engine's table is the very tensor it held before:
    updated in place, not replaced."""
    from repro_torch.core.streaming import make_sieve_engine

    f, rng = _problem(device, 6)
    engine = make_sieve_engine(f, 3, 0.2, variant="sieve", mode="device",
                               block_size=8)
    old = engine.state.caches
    ptr = old.data_ptr()
    engine.offer(np.arange(8), rng.standard_normal((8, 4)).astype(np.float32))
    if engine.state.caches is not old or old.data_ptr() != ptr:
        return False, "the sieve table was replaced by a new tensor"
    return True, "sieve table updated in place across the block"


def _rt_overlap_sieve(device) -> tuple[bool, str]:
    """The overlapped offer must be free: identical members, value and
    evaluations to the serialized one, with no extra kernel launch."""
    from repro_torch.core.evaluator import EvalConfig
    from repro_torch.core.streaming import make_sieve_engine
    from repro_torch.kernels import _build

    rng = np.random.default_rng(7)
    V = rng.standard_normal((32, 4)).astype(np.float32)
    stream = rng.standard_normal((40, 4)).astype(np.float32)
    results, calls = [], []
    for overlap in (False, True):
        f = fx.ExemplarClustering(torch.as_tensor(V, device=device),
                                  EvalConfig(backend="cuda"), device=device)
        engine = make_sieve_engine(f, 3, 0.2, variant="sieve",
                                   mode="device", block_size=8,
                                   overlap=overlap, max_in_flight=2)
        before = _build.CALLS["sieve_gain_eval"]
        acc = engine.offer(np.arange(len(stream)), stream)
        calls.append(_build.CALLS["sieve_gain_eval"] - before)
        results.append((engine.best(), engine.evaluations(), acc.tolist()))
    if calls[0] != calls[1]:
        return False, f"kernel calls serialized {calls[0]} vs overlapped " \
                      f"{calls[1]}"
    if results[0] != results[1]:
        return False, "overlap-on diverged from the serialized baseline"
    return True, (f"overlap-on == overlap-off (members/value/evals), "
                  f"{calls[1]} sieve kernel calls each")


def _rt_service_bucket(device) -> tuple[bool, str]:
    """One service round trip: 6 tenants in 2 bursts of 3 ride ONE batched
    dispatch per burst."""
    import asyncio

    from repro_torch.core.evaluator import EvalConfig
    from repro_torch.core.service import SelectionService

    rng = np.random.default_rng(5)

    async def serve():
        async with SelectionService(EvalConfig(backend="cuda"), max_batch=8,
                                    linger_s=0.05, device=device) as svc:
            for _ in range(2):
                await asyncio.gather(*[
                    svc.submit(rng.standard_normal((32, 4)), k=3)
                    for _ in range(3)])
            return svc.stats

    stats = asyncio.run(serve())
    if stats["dispatches"] != 2:
        return False, f"6 requests cost {stats['dispatches']} dispatches"
    return True, (f"{stats['batched_requests']} requests in "
                  f"{stats['dispatches']} dispatches")


def runtime_checks(device="cpu") -> list[RuntimeCheck]:
    """The runtime checks. ``retrace.sharded`` needs a process group."""
    device = torch.device(device)
    checks = (
        ("retrace.device", _rt_retrace_device),
        ("retrace.batched", _rt_retrace_batched),
        ("retrace.sharded", _rt_retrace_sharded),
        ("retrace.sieve", _rt_retrace_sieve),
        ("donation.live", _rt_reuse_live),
        ("donation.sieve", _rt_reuse_sieve),
        ("overlap.sieve", _rt_overlap_sieve),
        ("service.bucket", _rt_service_bucket),
    )
    return [RuntimeCheck(name, lambda fn=fn: fn(device),
                         "service.bucket_dispatch"
                         if name == "service.bucket" else "")
            for name, fn in checks]
