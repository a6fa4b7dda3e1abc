"""The selection engine (single-device part).

Every optimizer in the greedy family is the same machine viewed through two
choices:

* a **round-candidate strategy** — which candidates get scored each round:

  - ``dense``       every (validated) candidate, every round.
  - ``stochastic``  k pre-sampled candidate rows (one per round), drawn up
                    front so host and device paths consume identical
                    randomness.
  - ``lazy`` (CELF) stale upper bounds carried as an (n,) tensor; each round
                    re-scores the top-B stale candidates and stops when the
                    fresh-top invariant certifies the winner.

* an **execution plan** — where the rounds run: ``host`` (the reference loop
  in :mod:`repro_torch.core.optimizers`, one gains call per round) or
  ``device`` (:func:`_select_scan`: the k rounds as a Python loop whose
  cache, taken mask, winner row, argmax and trajectory all stay on the
  device). The mesh plans of the reference are not ported yet.

The reference runs all k rounds as ONE jitted ``lax.scan``. Here the dense
and stochastic rounds enqueue their work with no host sync until the loop
ends (no ``.item()``, ``.cpu()`` or ``bool(tensor)`` inside it); on the
``cuda`` backend each such round is ONE launch of the fused gain-update
kernel, which folds the previous winner into the cache in-tile and writes
the new cache into the other of two ping-pong buffers. CELF's inner loop
takes one scalar sync per iteration to test its stopping rule.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import distances as dist_mod
from repro_torch.core import functions as fx
from repro_torch.core.evaluator import free_memory_bytes
from repro_torch.core.functions import FnSpec, SubmodularFunction
from repro_torch.core.precision import PrecisionPolicy


@dataclasses.dataclass
class OptResult:
    indices: list[int]
    value: float
    trajectory: list[float]
    evaluations: int

    def exemplars(self, V) -> np.ndarray:
        V = V.cpu().numpy() if isinstance(V, torch.Tensor) else np.asarray(V)
        return V[self.indices]


#: Fraction of probed free device memory the gain tile may occupy.
GAIN_TILE_MEMORY_FRACTION = 0.25


def validate_candidates(candidates, n: int) -> np.ndarray:
    """Validate a candidate-index subset at the engine boundary.

    Out-of-range indices raise; duplicates are dropped keeping first
    occurrence (a duplicated index would otherwise be scored twice and could
    even be *selected* twice by the device argmax, which masks ``taken`` by
    index, not by position).
    """
    cand = np.asarray(candidates).reshape(-1)
    if not np.issubdtype(cand.dtype, np.integer):
        raise ValueError(
            f"candidate indices must be integers, got dtype {cand.dtype}")
    cand = cand.astype(np.int64)
    if cand.size == 0:
        raise ValueError("candidates must be non-empty")
    if cand.min() < 0 or cand.max() >= n:
        raise ValueError(
            f"candidate indices must lie in [0, {n}), got range "
            f"[{cand.min()}, {cand.max()}]")
    _, first = np.unique(cand, return_index=True)
    return cand[np.sort(first)]


_GAIN_TILE_CAP_ELEMS: Optional[int] = None


def _gain_tile_cap_elems(itemsize: int = 4) -> int:
    """Max gain-tile elements, probed ONCE per process and then frozen, so
    the block size (and with it the torch backend's summation grouping) does
    not float with live allocator state. Devices without a probe (CPU) fall
    back to the 128 MiB heuristic (2^25 float32 elements)."""
    global _GAIN_TILE_CAP_ELEMS
    if _GAIN_TILE_CAP_ELEMS is None:
        free = free_memory_bytes()
        if free is not None:
            _GAIN_TILE_CAP_ELEMS = max(
                int(free * GAIN_TILE_MEMORY_FRACTION) // itemsize, 1)
        else:
            _GAIN_TILE_CAP_ELEMS = 1 << 25
    return _GAIN_TILE_CAP_ELEMS


def _device_block_m(n: int, m: int) -> int:
    """Candidate block size bounding the torch backend's (n, Bm) gain tile,
    autotuned from the free-memory probe ``plan_chunks`` uses. The floor of
    8 lets the cap be exceeded only where chunking V itself is the right
    tool."""
    cap_elems = _gain_tile_cap_elems()
    if n * m <= cap_elems:
        return m
    return max(8, min(m, cap_elems // max(n, 1)))


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d device index, without a host sync."""
    return torch.index_select(x, 0, i.reshape(1))[0]


# ---------------------------------------------------------------------------
# Scoring core of the device plan
# ---------------------------------------------------------------------------


def _score_blocked(V, C, sc, pair, policy, block_m: int,
                   n_total: Optional[int] = None, fn: FnSpec = FnSpec(),
                   row_aux=None) -> torch.Tensor:
    """Gains of candidate payload C against score-cache rows ``sc`` in
    (n, block_m) tiles (``functions.gains_formula_spec`` is shared with the
    host path, which keeps the per-column reduction identical)."""
    bm = max(1, min(block_m, C.shape[0]))
    return torch.cat([
        fx.gains_formula_spec(fn, V, C[s:s + bm], sc, row_aux, pair, policy,
                              n_total=n_total)
        for s in range(0, C.shape[0], bm)])


def _make_score_payload(V, pair, policy, backend, rbf_gamma, block_m,
                        fn: FnSpec, row_aux, n_total=None):
    """Build ``score(sc, C) -> gains`` over candidate payload rows: the
    shared min/max CUDA kernel template when the function has one and the
    backend is ``cuda``, else the blocked torch reduction. Gains exclude the
    index-addressed extra term."""
    tmpl = fx.kernel_template(fn)
    if backend == "cuda" and tmpl is not None:
        from repro_torch.kernels import ops as kops

        def score(sc, C):
            return kops.marginal_gain(
                V, C, sc, policy=policy, rbf_gamma=rbf_gamma,
                fold=tmpl[0], score_affine=tmpl[1], n_total=n_total)
    else:

        def score(sc, C):
            return _score_blocked(V, C, sc, pair, policy, block_m,
                                  n_total=n_total, fn=fn, row_aux=row_aux)

    return score


def _make_fold_and_score(V, policy, rbf_gamma, fn: FnSpec = FnSpec(),
                         n_total=None):
    """Build the fused dense/stochastic step of a fused-eligible function on
    the ``cuda`` backend: ``step(vec, w_row, w_ok, C, out) -> (gains,
    new_vec)`` folds the previous winner's row in (gated by the device float
    ``w_ok`` — round 0 has no winner, and the max fold is not idempotent)
    and scores candidate payload ``C`` against the folded cache, in ONE
    launch of the fused gain kernel, which writes the new cache into ``out``
    (a buffer distinct from ``vec``)."""
    from repro_torch.kernels import ops as kops

    fold, affine = fx.kernel_template(fn)

    def fold_and_score(vec, w_row, w_ok, C, out=None):
        return kops.fused_gain_update(
            V, C, vec, w_row, policy=policy, rbf_gamma=rbf_gamma, fold=fold,
            score_affine=affine, n_total=n_total, w_valid=w_ok,
            cache_out=out)

    return fold_and_score


# ---------------------------------------------------------------------------
# Round-step builders — the ONE definition of a selection round
# ---------------------------------------------------------------------------


def make_rounds_step(take, fold_score_val):
    """Dense/stochastic round over one row of candidate indices.

    ``fold_score_val(cache, w_prev, cand_t) -> (gains, new_cache, value)``
    folds the previous winner and scores the round's candidates;
    ``take(idx)`` resolves a winner index to its ``(payload row, index)``
    carry. Nothing here reads a device value on the host.
    """

    def step(carry, cand_t):
        cache, taken, w_prev = carry
        gains, cache, val = fold_score_val(cache, w_prev, cand_t)
        live = ~torch.index_select(taken, 0, cand_t)
        gains = torch.where(live, gains, -torch.inf)
        p = torch.argmax(gains)  # first maximum, as jnp.argmax
        j = _at(cand_t, p)
        # a round whose candidates are all taken has no legitimate argmax:
        # emit the -1 sentinel (the engine boundary raises on it)
        j_out = torch.where(_at(gains, p) > -torch.inf, j, -1)
        taken.index_fill_(0, j.reshape(1), True)
        # cache includes winners 0..t-1 here → val is trajectory[t-1]
        return ((cache, taken, take(j)),
                (j_out, val, torch.sum(live).to(torch.int32)))

    return step


def celf_max_iters(n: int, top_b: int) -> int:
    """CELF loop backstop: ⌈n/B⌉ iterations re-score every candidate (the
    loop has then degenerated to a full re-score), +1 slack."""
    return -(-n // top_b) + 1


def make_lazy_step(take, n_pool, fold, score_idx_val, top_b: int,
                   max_iters: int):
    """CELF round: a loop of top-B re-scoring over stale bounds.

    ``fold(cache, w)`` folds the previous winner once per round;
    ``score_idx_val(cache, idx) -> (gains, value)`` scores candidate
    indices. The loop body runs ≥ once per round (nothing starts fresh), so
    ``val`` is always the round's f(S_t); it stops when the fresh-top
    invariant — best re-scored gain ≥ every remaining stale bound —
    certifies the winner, or after ``max_iters`` iterations. Each test of
    that rule is one scalar host sync (a fixed-trip or graph-captured loop
    is later work). Ties in the top-B order break by lowest index, as
    ``jax.lax.top_k`` and the host's stable argsort do.
    """

    def step(carry):
        cache, taken, w_prev, ub = carry
        cache = fold(cache, w_prev)
        dev = ub.device
        fresh = torch.zeros((n_pool,), dtype=torch.bool, device=dev)
        scored = torch.zeros((), dtype=torch.int32, device=dev)
        val = torch.zeros((), dtype=torch.float32, device=dev)
        it = 0
        while it < max_iters:
            stale = torch.where(fresh | taken, -torch.inf, ub)
            fresh_best = torch.max(torch.where(fresh & ~taken, ub, -torch.inf))
            if not bool(fresh_best < torch.max(stale)):  # one sync
                break
            top_ub, top_idx = torch.sort(stale, descending=True, stable=True)
            top_ub, top_idx = top_ub[:top_b], top_idx[:top_b]
            live = top_ub > -torch.inf
            gains_b, val = score_idx_val(cache, top_idx)
            gains_b = torch.where(live, gains_b, -torch.inf)
            ub = ub.scatter(0, top_idx, torch.where(
                live, gains_b, torch.index_select(ub, 0, top_idx)))
            fresh = fresh.scatter(
                0, top_idx, live | torch.index_select(fresh, 0, top_idx))
            scored = scored + torch.sum(live).to(torch.int32)
            it += 1
        j = torch.argmax(torch.where(fresh & ~taken, ub, -torch.inf))
        taken.index_fill_(0, j.reshape(1), True)
        # cache includes winners 0..t-1 here → val is trajectory[t-1]
        return (cache, taken, take(j), ub), (j, val, scored)

    return step


def drive_selection_scan(*, kind, k, top_b, pool, cand_rounds, cache0, w0,
                         fold, score_idx_val, fold_score_val, value_of):
    """Run k selection rounds given the plan's callbacks.

    CELF's bound seeding, the dense one-row vs stochastic per-round
    candidates, ``n_scored`` accounting, the final fold and the trajectory
    all live here. The cache is the function's ``(vec, aux)`` pair; the
    winner carry is a ``(payload row, index)`` pair whose index is −1 before
    round 0 (folds gate on it).

    Returns ``(sel, traj, n_scored)`` as device tensors.
    """
    n_pool = pool.shape[0]

    def take(idx):
        return (_at(pool, idx), idx)

    taken = torch.zeros((n_pool,), dtype=torch.bool, device=pool.device)
    sel, vals, scored = [], [], []
    if kind == "lazy":
        step = make_lazy_step(take, n_pool, fold, score_idx_val, top_b,
                              celf_max_iters(n_pool, top_b))
        # round -1: fresh singleton gains seed the bounds (counts one eval
        # per pool row, exactly like host CELF's initial full scoring)
        ub0, _ = score_idx_val(
            cache0, torch.arange(n_pool, device=pool.device))
        carry = (cache0, taken, w0, ub0)
        for _ in range(k):
            carry, (j, val, sc) = step(carry)
            sel.append(j)
            vals.append(val)
            scored.append(sc)
        cache, _, w_last, _ = carry
        n_scored = n_pool + torch.sum(torch.stack(scored))
    else:
        step = make_rounds_step(take, fold_score_val)
        carry = (cache0, taken, w0)
        cand_row = cand_rounds[0]  # dense: one row object for every round
        for t in range(k):
            cand_t = cand_row if kind == "dense" else cand_rounds[t]
            carry, (j, val, sc) = step(carry, cand_t)
            sel.append(j)
            vals.append(val)
            scored.append(sc)
        cache, _, w_last = carry
        n_scored = torch.sum(torch.stack(scored))

    # one final fold for the last trajectory point
    final_val = value_of(fold(cache, w_last))
    traj = torch.stack(vals[1:] + [final_val])
    return torch.stack(sel), traj, n_scored


def _select_scan(V, seed, row_aux, cand_rounds, w0, *, fn: FnSpec, kind: str,
                 k: int, top_b: int, distance: str, policy: PrecisionPolicy,
                 block_m: int, backend: str, rbf_gamma: Optional[float]):
    """All k selection rounds on the device, for any vec-cache function.

    ``seed`` is the function's (n,) cache seed, copied here (it may alias
    the function's resident ``d_e0``); ``cand_rounds`` holds the candidate
    indices — (1, m) dense (one row for every round), (k, m) stochastic,
    (1, 0) lazy. On the ``cuda`` backend with a fused-eligible function the
    dense/stochastic fold rides inside the fused gain kernel, which
    ping-pongs two cache buffers; lazy folds once per round explicitly
    because its loop re-scores variable candidate batches against the
    already-folded cache. Per-round outputs are ``(selected index,
    trajectory value, #actually-scored candidates)``.
    """
    pair = dist_mod.resolve_pairwise(distance)
    n = V.shape[0]
    seedf = seed.to(torch.float32).clone()
    v0 = torch.mean(fx.stat_rows(fn, seedf, row_aux))

    def value_of(cache):
        vec, aux = cache
        return fx.value_from_stat(
            fn, v0, torch.mean(fx.stat_rows(fn, vec, row_aux)), aux, n)

    def fold(cache, w):
        vec, aux = cache
        row, idx = w
        dw = pair(V, row[None, :], policy)[:, 0]
        folded = fx.fold_vec_rows(fn, vec, dw.to(torch.float32))
        new_aux = fx.fold_aux(fn, vec, aux, idx, 0, n)
        ok = idx >= 0
        return (torch.where(ok, folded, vec), torch.where(ok, new_aux, aux))

    score = _make_score_payload(V, pair, policy, backend, rbf_gamma,
                                block_m, fn, row_aux)
    # the dense strategy scores one candidate row every round: its payload
    # is gathered once (the row object is kept, so identity is safe)
    gathered = [None, None]

    def candidates(idx):
        if gathered[0] is not idx:
            gathered[:] = [idx, torch.index_select(V, 0, idx)]
        return gathered[1]

    def score_idx(cache, idx):
        vec, _aux = cache
        gains = score(fx.score_cache_rows(fn, vec, row_aux), candidates(idx))
        extra = fx.gains_index_extra(fn, vec, idx, 0, n, n)
        return gains if extra is None else gains + extra

    def score_idx_val(cache, idx):
        return score_idx(cache, idx), value_of(cache)

    fold_score_val = None
    if kind != "lazy":
        if backend == "cuda" and fx.kernel_fused_ok(fn) \
                and fx.kernel_template(fn) is not None:
            fold_and_score = _make_fold_and_score(V, policy, rbf_gamma, fn=fn)
            # the fused kernel reads one cache buffer and writes the other
            bufs = (seedf, torch.empty_like(seedf))

            def fold_score_val(cache, w_prev, cand_t):
                vec, aux = cache
                row, idx = w_prev
                out = bufs[1] if vec is bufs[0] else bufs[0]
                gains, vec2 = fold_and_score(
                    vec, row, (idx >= 0).to(torch.float32),
                    candidates(cand_t), out)
                cache2 = (vec2, aux)  # fused-eligible functions carry no aux
                return gains, cache2, value_of(cache2)
        else:

            def fold_score_val(cache, w_prev, cand_t):
                cache2 = fold(cache, w_prev)
                return score_idx(cache2, cand_t), cache2, value_of(cache2)

    w0c = (w0.to(V.dtype), torch.tensor(-1, device=V.device))
    cache0 = (seedf, torch.zeros((), dtype=torch.float32, device=V.device))
    return drive_selection_scan(
        kind=kind, k=k, top_b=top_b, pool=V, cand_rounds=cand_rounds,
        cache0=cache0, w0=w0c, fold=fold, score_idx_val=score_idx_val,
        fold_score_val=fold_score_val, value_of=value_of)


# ---------------------------------------------------------------------------
# Engine entry point
# ---------------------------------------------------------------------------


def run_selection(
    f: SubmodularFunction,
    *,
    kind: str,                        # "dense" | "stochastic" | "lazy"
    k: int,
    cand_rounds: Optional[np.ndarray] = None,
    top_b: int = 0,
    plan: str = "device",
    block_m: Optional[int] = None,
) -> OptResult:
    """Run a round-candidate strategy under the ``device`` execution plan.

    ``cand_rounds`` carries the per-round candidate indices for the dense
    and stochastic strategies ((k, m), global indices); the lazy strategy
    derives its candidates on device and takes ``top_b`` instead (0 → the
    default re-score width of 256). A stochastic round whose sample row is
    entirely exhausted by earlier selections raises rather than silently
    re-selecting a taken index.
    """
    if plan in ("device_sharded", "device_sharded_pool", "greedi"):
        raise NotImplementedError(
            f"execution plan {plan!r} is not ported yet: the mesh plans on "
            f"torch.distributed are ROADMAP item A.7")
    if plan != "device":
        raise ValueError(f"unknown execution plan {plan!r}")
    if k == 0:
        return OptResult([], 0.0, [], 0)
    fn = f.spec
    if fn.name not in fx.DEVICE_PLAN_ELIGIBLE:
        raise ValueError(
            f"function {fn.name!r} has no n-aligned vec cache to scan over "
            f"— it runs on the host execution plans only")
    n_cand = f.n if kind == "lazy" or cand_rounds is None \
        else len(np.unique(cand_rounds[0] if kind == "dense" else cand_rounds))
    if k > n_cand:
        raise ValueError(
            f"cannot select k={k} exemplars from {n_cand} distinct "
            f"candidates — once every candidate is taken the argmax would "
            f"silently re-select one")
    policy = f.cfg.resolved_policy()
    backend = "cuda" if f.cfg.backend == "cuda" else "torch"
    if fx.kernel_template(fn) is None:
        backend = "torch"  # no kernel form: torch scoring on any backend
    if backend == "cuda" and f.cfg.distance not in dist_mod.MXU_ELIGIBLE:
        raise ValueError(
            f"device plans with the cuda backend support "
            f"{sorted(dist_mod.MXU_ELIGIBLE)}, got {f.cfg.distance!r}")
    rbf_gamma = dist_mod.RBF_GAMMA \
        if (backend == "cuda" and f.cfg.distance == "rbf") else None
    w0 = f.e0 if f.e0 is not None else torch.zeros(
        (f.dim,), dtype=f.V.dtype, device=f.device)

    if kind == "lazy":
        top_b = max(1, min(top_b or 256, f.n))
        cand_rounds = np.zeros((1, 0), np.int64)
        m_widest = f.n  # the bound-seeding pass scores all n candidates
    elif cand_rounds is None:
        raise ValueError(f"strategy {kind!r} needs cand_rounds")
    else:
        m_widest = cand_rounds.shape[1]

    bm = block_m if block_m is not None else _device_block_m(f.n, m_widest)
    sel, traj, n_scored = _select_scan(
        f.V, f.cache_seed, f.row_aux,
        torch.as_tensor(np.asarray(cand_rounds, np.int64), device=f.device),
        w0, fn=fn, kind=kind, k=k, top_b=top_b, distance=f.cfg.distance,
        policy=policy, block_m=bm, backend=backend, rbf_gamma=rbf_gamma)

    # the one host sync of a dense/stochastic selection
    sel = [int(x) for x in sel.cpu().tolist()]
    if any(s < 0 for s in sel):
        bad = sel.index(-1)
        raise ValueError(
            f"round {bad} had no untaken candidate (its sample row is "
            f"exhausted by earlier selections) — the argmax would silently "
            f"re-select a taken index")
    traj = [float(x) for x in traj.cpu().tolist()]
    return OptResult(sel, traj[-1] if traj else 0.0, traj, int(n_scored))
