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
  in :mod:`repro_torch.core.optimizers`, one gains call per round),
  ``device`` (:func:`_select_scan`: the k rounds as a Python loop whose
  cache, taken mask, winner row, argmax and trajectory all stay on the
  device), or one of the mesh plans of :mod:`repro_torch.core.distributed`
  (``device_sharded``, ``device_sharded_pool``, ``greedi``): the same
  rounds on every rank of a ``torch.distributed`` mesh, each rank holding
  n/p rows of V and of the cache.

:func:`run_selection_batch` runs B independent requests of one signature
per dispatch (the multi-tenant serving path of
:mod:`repro_torch.core.service`): the same strategies over (B, …) state,
ragged k as a per-request freeze mask.

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
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.contracts import contract
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


def _device_block_m(n: int, m: int, tiles_per_memory: int = 1,
                    n_batch: int = 1) -> int:
    """Candidate block size bounding the torch backend's (n, Bm) gain tile,
    autotuned from the free-memory probe ``plan_chunks`` uses. The floor of
    8 lets the cap be exceeded only where chunking V itself is the right
    tool.

    ``n`` is the height of the tile that materializes: a rank's own n/p
    rows under the mesh plans. ``tiles_per_memory`` divides the cap when
    several ranks' tiles live in one memory (all CPU ranks of a host, or
    several ranks on one card: :func:`mesh_tiles_per_memory`).
    ``n_batch`` scales the tile height: a batched dispatch of B requests
    keeps B (n, Bm) tiles' worth of state live, so a B = 1024 bucket sized
    as if B = 1 would over-commit memory B×.
    """
    cap_elems = _gain_tile_cap_elems() // max(tiles_per_memory, 1)
    rows = n * max(n_batch, 1)
    if rows * m <= cap_elems:
        return m
    return max(8, min(m, cap_elems // max(rows, 1)))


def mesh_tiles_per_memory(mesh, data_axes: Sequence[str] = ("data",),
                          device="cpu") -> int:
    """How many ranks of ``mesh``'s data group carve their gain tiles for
    tensors on ``device`` out of one memory: every CPU rank of a host, or
    the CUDA ranks that share one card. Read from one all-gather of each
    rank's memory identity when the mesh is first resolved (a collective:
    every rank resolves the mesh)."""
    from repro_torch.core import distributed

    return distributed.resolve_mesh(mesh, data_axes).tiles_per_memory(device)


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
            if not bool(fresh_best < torch.max(stale)):  # lint: allow(host-sync)
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


def drive_selection_scan(*, kind, k, top_b, cand_rounds, cache0, w0, fold,
                         score_idx_val=None, fold_score_val=None,
                         value_of=None, pool=None, take=None, n_pool=None,
                         taken0=None):
    """Run k selection rounds given the plan's callbacks.

    CELF's bound seeding, the dense one-row vs stochastic per-round
    candidates, ``n_scored`` accounting, the final fold and the trajectory
    all live here. The cache is the function's ``(vec, aux)`` pair; the
    winner carry is a ``(payload row, index)`` pair whose index is −1 before
    round 0 (folds gate on it).

    The candidate payload is addressed through ``take(idx) -> (row,
    index)``: pass a resident ``pool`` (``take`` defaults to ``(pool[idx],
    idx)``), or ``take`` and ``n_pool`` where no plan-wide payload exists
    (the sharded pool gathers the requested row from its owner) or where
    pool and global indices differ (GreeDi's merge round). ``taken0``
    pre-marks pool rows as taken (a GreeDi partition's padding rows).

    Returns ``(sel, traj, n_scored)`` as device tensors.
    """
    if take is None:
        n_pool = pool.shape[0]

        def take(idx):
            return (_at(pool, idx), idx)

    dev = cache0[0].device
    taken = taken0.clone() if taken0 is not None else torch.zeros(
        (n_pool,), dtype=torch.bool, device=dev)
    sel, vals, scored = [], [], []
    if kind == "lazy":
        step = make_lazy_step(take, n_pool, fold, score_idx_val, top_b,
                              celf_max_iters(n_pool, top_b))
        # round -1: fresh singleton gains seed the bounds (counts one eval
        # per pool row, exactly like host CELF's initial full scoring)
        ub0, _ = score_idx_val(cache0, torch.arange(n_pool, device=dev))
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


@contract(
    "engine.select_scan",
    host_syncs_per_round="celf",
    launches_per_round={"gain_update_eval": 1, "gain_eval": 1},
    reuse=("cache",),
    memory=True,
    claim="the k rounds enqueue with no host sync (CELF: one allowed "
          "scalar read per re-score); a dense or stochastic round is ONE "
          "launch of the fused gain kernel, which ping-pongs two cache "
          "buffers; collective-free; half payloads stay half")
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

    # torch.full, not torch.tensor: no host value is copied to the card
    w0c = (w0.to(V.dtype), torch.full((), -1, device=V.device))
    cache0 = (seedf, torch.zeros((), dtype=torch.float32, device=V.device))
    return drive_selection_scan(
        kind=kind, k=k, top_b=top_b, pool=V, cand_rounds=cand_rounds,
        cache0=cache0, w0=w0c, fold=fold, score_idx_val=score_idx_val,
        fold_score_val=fold_score_val, value_of=value_of)


# ---------------------------------------------------------------------------
# Batched rounds — B independent requests per dispatch
#
# Every carry leaf grows a leading B axis ((B, n) caches, (B, n) taken
# masks, (B, d) winner rows, (B, n) CELF bounds); gains, argmax, fold and
# top-B run per request. Ragged k rides as a per-request ``k_eff`` vector:
# rounds t ≥ k_eff[b] freeze request b's carry (its transient fold still
# produces the right trajectory value f(S_{k_eff})), emit the −1 sentinel
# and count zero evaluations, so bucket-padding slots (k_eff = 0) are
# inert. Per-request selections, trajectories and evaluation counts equal
# B unbatched runs: scoring goes through the grid-over-B kernels (bit for
# bit a request's unbatched launch) or a per-request torch reduction, and
# every per-request reduction (distance column, mean) is taken on that
# request's own row.
# ---------------------------------------------------------------------------


def _freeze_where(act, new, old):
    """Per-request carry gate: take ``new`` leaves where the request is
    active, keep ``old`` where it is frozen (``act`` is (B,) bool; every
    leaf carries a leading B axis). Each leaf comes out a fresh tensor."""
    if isinstance(new, tuple):
        return tuple(_freeze_where(act, a, b) for a, b in zip(new, old))
    return torch.where(act.reshape(act.shape + (1,) * (new.ndim - 1)), new,
                       old)


def _mark(taken, j):
    """``taken`` with column j[b] of each row b set (a new tensor)."""
    return taken.scatter(1, j[:, None], torch.ones_like(j[:, None],
                                                        dtype=torch.bool))


def make_batched_rounds_step(take, fold_score_val, k_eff):
    """Batched :func:`make_rounds_step` — dense/stochastic rounds over a
    leading request axis.

    ``fold_score_val(cache, w_prev, cand_t, act) -> (gains (B, m), cache,
    value (B,))`` folds each request's previous winner and scores its own
    candidate row; the cache it returns keeps the held cache of every
    request with ``act`` False (the fused kernel by its fold gate, so the
    carry can ping-pong two buffers; the others by ``torch.where``), while
    the gains and values of those requests are never read. ``take(idx
    (B,)) -> ((B, d) rows, idx)`` resolves the per-request winners.
    ``k_eff`` (B,) is the ragged-k mask: requests with t ≥ k_eff freeze.
    Nothing here reads a device value on the host.
    """

    def step(carry, cand_t, t: int):
        cache, taken, w_prev = carry
        act = k_eff > t
        gains, cache2, val = fold_score_val(cache, w_prev, cand_t, act)
        live = ~torch.gather(taken, 1, cand_t)
        gains = torch.where(live, gains, -torch.inf)
        p = torch.argmax(gains, dim=1)  # first maximum per request
        j = torch.gather(cand_t, 1, p[:, None])[:, 0]
        best = torch.gather(gains, 1, p[:, None])[:, 0]
        # exhausted sample row → −1 sentinel, as the unbatched step; frozen
        # rounds also emit −1 (the demux truncates them away)
        j_out = torch.where(act & (best > -torch.inf), j, -1)
        carry = (cache2, *_freeze_where(act, (_mark(taken, j), take(j)),
                                        (taken, w_prev)))
        scored = torch.where(act, torch.sum(live, dim=1).to(torch.int32), 0)
        return carry, (j_out, val, scored)

    return step


def make_batched_lazy_step(take, fold, score_idx_val, top_b: int,
                           max_iters: int, k_eff, value_of=None):
    """Batched :func:`make_lazy_step` — per-request CELF bound state.

    Each request carries its own (n,) stale bounds and freshness; the loop
    runs while ANY request still fails the fresh-top invariant (or until
    ``max_iters``). A certified or frozen request stops scoring at once (its
    ``live`` lanes mask out), so per-request evaluation counts equal the
    unbatched engine's: within a round a request is active for iterations
    0..c_b−1, and c_b is what its unbatched loop would run. Each test of
    the loop condition is one scalar host sync, as in the unbatched step.
    Top-B ties break by lowest index (a stable descending sort per row).

    ``score_idx_val(cache, idx (B, m)) -> ((B, m) gains, (B,) value)``
    re-scores. The trajectory value is that of the round's folded cache,
    which frozen requests (that skip the loop) need as well. With
    ``value_of`` (the device plan) it is ``value_of`` of that cache, taken
    once before the loop. Without it (the mesh plans, whose gain partials
    and stat sums cross the mesh in one collective) it is the value the
    re-score returns: the loop does not change the cache, so any iteration
    gives it. The loop then runs at least once, even when every request is
    frozen; that iteration is inert (``live`` masks every lane).
    """
    first = 0 if value_of is not None else 1

    def step(carry, t: int):
        cache, taken, w_prev, ub = carry
        cache2 = fold(cache, w_prev)
        act = k_eff > t
        val = value_of(cache2) if value_of is not None else None
        fresh = torch.zeros_like(taken)
        scored = torch.zeros_like(k_eff, dtype=torch.int32)
        ub_c = ub
        it = 0
        while it < max_iters:
            stale = torch.where(fresh | taken, -torch.inf, ub_c)
            fresh_best = torch.amax(torch.where(fresh & ~taken, ub_c,
                                                -torch.inf), dim=1)
            active = (fresh_best < torch.amax(stale, dim=1)) & act
            if it >= first and not bool(torch.any(active)):  # lint: allow(host-sync)
                break
            top_ub, top_idx = torch.sort(stale, dim=1, descending=True,
                                         stable=True)
            top_ub, top_idx = top_ub[:, :top_b], top_idx[:, :top_b]
            live = (top_ub > -torch.inf) & active[:, None]
            gains_b, v = score_idx_val(cache2, top_idx)
            if value_of is None:
                val = v
            gains_b = torch.where(live, gains_b, -torch.inf)
            ub_c = ub_c.scatter(1, top_idx, torch.where(
                live, gains_b, torch.gather(ub_c, 1, top_idx)))
            fresh = fresh.scatter(1, top_idx,
                                  torch.gather(fresh, 1, top_idx) | live)
            scored = scored + torch.sum(live, dim=1).to(torch.int32)
            it += 1
        j = torch.argmax(torch.where(fresh & ~taken, ub_c, -torch.inf), dim=1)
        carry = _freeze_where(act, (cache2, _mark(taken, j), take(j), ub_c),
                              carry)
        return carry, (torch.where(act, j, -1), val,
                       torch.where(act, scored, 0))

    return step


def drive_selection_scan_batched(*, kind, k, top_b, k_eff, cand_rounds,
                                 cache0, w0, fold, score_idx=None,
                                 score_idx_val=None, fold_score_val=None,
                                 value_of=None, pool=None, take=None,
                                 n_pool=None):
    """Batched :func:`drive_selection_scan` — k rounds of B requests.

    ``pool`` is the (B, n, d) stacked payload; ``cand_rounds`` is (B, k, m)
    (dense passes one row, (B, 1, m); lazy (B, 1, 0)); ``k_eff`` (B,) the
    per-request effective k (bucket-padding slots pass 0). The callbacks
    are the batched analogues of :func:`drive_selection_scan`'s:
    ``fold(cache, (rows, idx)) -> cache``, ``score_idx(cache, idx (B, m))
    -> (B, m)``, ``fold_score_val(cache, w_prev, cand_t, act) -> (gains,
    cache, (B,) value)`` (``act`` (B,): the requests still selecting),
    ``value_of(cache) -> (B,)``.

    As in the unbatched driver, plans with no resident per-request payload
    pass ``take(idx (B,)) -> ((B, d) rows, idx)`` and ``n_pool`` instead
    of ``pool``. The mesh plans pass ``score_idx_val(cache, idx) -> (gains,
    (B,) value)`` (gains and per-request values in one collective) where
    the device plan passes ``score_idx``; CELF then takes its values from
    the re-scores (:func:`make_batched_lazy_step`).

    Returns ``(sel (k, B), traj (k, B), n_scored (B,))`` as device tensors.
    """
    B = k_eff.shape[0]
    dev = k_eff.device
    if take is None:
        n_pool = pool.shape[1]
        rows = torch.arange(B, device=dev)

        def take(idx):
            return (pool[rows, idx], idx)

    taken = torch.zeros((B, n_pool), dtype=torch.bool, device=dev)
    sel, vals, scored = [], [], []
    if kind == "lazy":
        all_idx = torch.arange(n_pool, device=dev).expand(B, n_pool)
        step_value_of = None
        if score_idx_val is None:
            step_value_of = value_of

            def score_idx_val(cache, idx):
                return score_idx(cache, idx), None
        step = make_batched_lazy_step(
            take, fold, score_idx_val, top_b, celf_max_iters(n_pool, top_b),
            k_eff, value_of=step_value_of)
        # round -1: per-request singleton gains seed the bounds (one eval
        # per pool row for every request that runs ≥ 1 round)
        ub0, _ = score_idx_val(cache0, all_idx)
        carry = (cache0, taken, w0, ub0)
        for t in range(k):
            carry, (j, val, sc) = step(carry, t)
            sel.append(j)
            vals.append(val)
            scored.append(sc)
        cache, _, w_last, _ = carry
        n_scored = torch.where(
            k_eff > 0, n_pool + torch.sum(torch.stack(scored), dim=0), 0)
    else:
        step = make_batched_rounds_step(take, fold_score_val, k_eff)
        carry = (cache0, taken, w0)
        cand_row = cand_rounds[:, 0]  # dense: one row object every round
        for t in range(k):
            cand_t = cand_row if kind == "dense" else cand_rounds[:, t]
            carry, (j, val, sc) = step(carry, cand_t, t)
            sel.append(j)
            vals.append(val)
            scored.append(sc)
        cache, _, w_last = carry
        n_scored = torch.sum(torch.stack(scored), dim=0)

    # one final fold for the last trajectory point (frozen requests fold
    # their held winner transiently — still exactly f(S_{k_eff})). It is
    # request b's point k_eff[b] − 1 whatever k_eff[b] is: the round-k_eff
    # value of a frozen dense request came from the fused kernel's in-tile
    # fold, while its unbatched run takes its last point from this fold.
    final_val = value_of(fold(cache, w_last))
    traj = torch.stack(vals[1:] + [final_val])
    last = torch.clamp_min(k_eff - 1, 0)[None, :]
    traj = traj.scatter(0, last, final_val[None, :])
    return torch.stack(sel), traj, n_scored


@contract(
    "engine.select_scan_batched",
    host_syncs_per_round="celf",
    launches_per_round={"gain_update_eval_batched": 1,
                        "gain_eval_batched": 1},
    reuse=("cache",),
    memory=True,
    claim="k rounds of B requests with no host sync (CELF: one allowed "
          "read per re-score); a dense or stochastic round is ONE launch of "
          "the batched fused kernel whatever B is, ping-ponging two (B, n) "
          "cache buffers; collective-free")
def _select_scan_batched(V, seed, row_aux, cand_rounds, w0, k_eff, *,
                         fn: FnSpec, kind: str, k: int, top_b: int,
                         distance: str, policy: PrecisionPolicy, block_m: int,
                         backend: str, rbf_gamma: Optional[float]):
    """All k rounds of B independent requests on the device.

    The batched mirror of :func:`_select_scan`: ``V (B, n, d)``, ``seed /
    row_aux (B, n)``, ``cand_rounds (B, k, m)``, ``w0 (B, d)``, ``k_eff
    (B,)``. The cache-protocol helpers broadcast over the leading axis; the
    index-addressed ones (graph cut's ``gains_index_extra`` / ``fold_aux``)
    and the per-request reductions run request by request. On the ``cuda``
    backend scoring goes through the grid-over-B kernels, and a
    fused-eligible function's dense/stochastic round is ONE launch of
    ``gain_update_eval_batched`` whatever B is, which reads one of two
    (B, n) cache buffers and writes the other; a frozen request's fold gate
    is 0, so its cache is copied through unchanged. ``seed`` is copied
    here, so neither the staged payload nor a function's own
    ``cache_seed`` is ever written.
    """
    pair = dist_mod.resolve_pairwise(distance)
    B, n = V.shape[:2]
    dev = V.device
    rows = torch.arange(B, device=dev)
    seedf = seed.to(torch.float32).clone()

    def means(stat):
        # each request's mean over its own row, as its unbatched run takes it
        return torch.stack([torch.mean(stat[b]) for b in range(B)])

    v0 = means(fx.stat_rows(fn, seedf, row_aux))

    def value_of(cache):
        vec, aux = cache
        return fx.value_from_stat(fn, v0, means(fx.stat_rows(fn, vec, row_aux)),
                                  aux, n)

    def fold(cache, w):
        vec, aux = cache
        row, idx = w
        dw = torch.stack([pair(V[b], row[b][None, :], policy)[:, 0]
                          for b in range(B)])
        folded = fx.fold_vec_rows(fn, vec, dw.to(torch.float32))
        new_aux = aux if fn.name != "graph_cut" else torch.stack([
            fx.fold_aux(fn, vec[b], aux[b], idx[b], 0, n) for b in range(B)])
        ok = idx >= 0
        return (torch.where(ok[:, None], folded, vec),
                torch.where(ok, new_aux, aux))

    tmpl = fx.kernel_template(fn)
    if backend == "cuda" and tmpl is not None:
        from repro_torch.kernels import ops as kops

        def score(sc, C):
            return kops.marginal_gain(
                V, C, sc, policy=policy, rbf_gamma=rbf_gamma, fold=tmpl[0],
                score_affine=tmpl[1])
    else:

        def score(sc, C):
            return torch.stack([
                _score_blocked(V[b], C[b], sc[b], pair, policy, block_m,
                               fn=fn, row_aux=row_aux[b])
                for b in range(B)])

    # the dense strategy scores one candidate row every round: its payload
    # is gathered once (the row object is kept, so identity is safe)
    gathered = [None, None]

    def candidates(idx):
        if gathered[0] is not idx:
            gathered[:] = [idx, V[rows[:, None], idx]]
        return gathered[1]

    def score_idx(cache, idx):
        vec, _aux = cache
        gains = score(fx.score_cache_rows(fn, vec, row_aux), candidates(idx))
        if fn.name != "graph_cut":
            return gains
        return gains + torch.stack([
            fx.gains_index_extra(fn, vec[b], idx[b], 0, n, n)
            for b in range(B)])

    fold_score_val = None
    if kind != "lazy":
        if backend == "cuda" and fx.kernel_fused_ok(fn) and tmpl is not None:
            from repro_torch.kernels import ops as kops

            # the fused kernel reads one cache buffer and writes the other
            bufs = (seedf, torch.empty_like(seedf))

            def fold_score_val(cache, w_prev, cand_t, act):
                vec, aux = cache
                row, idx = w_prev
                out = bufs[1] if vec is bufs[0] else bufs[0]
                gains, vec2 = kops.fused_gain_update(
                    V, candidates(cand_t), vec, row, policy=policy,
                    rbf_gamma=rbf_gamma, fold=tmpl[0], score_affine=tmpl[1],
                    w_valid=((idx >= 0) & act).to(torch.float32),
                    cache_out=out)
                cache2 = (vec2, aux)  # fused-eligible functions carry no aux
                return gains, cache2, value_of(cache2)
        else:

            def fold_score_val(cache, w_prev, cand_t, act):
                cache2 = fold(cache, w_prev)
                return (score_idx(cache2, cand_t),
                        _freeze_where(act, cache2, cache), value_of(cache2))

    w0c = (w0.to(V.dtype), torch.full((B,), -1, dtype=torch.long, device=dev))
    cache0 = (seedf, torch.zeros((B,), dtype=torch.float32, device=dev))
    return drive_selection_scan_batched(
        kind=kind, k=k, top_b=top_b, pool=V, k_eff=k_eff,
        cand_rounds=cand_rounds, cache0=cache0, w0=w0c, fold=fold,
        score_idx=score_idx, fold_score_val=fold_score_val,
        value_of=value_of)


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
    plan: str = "device",             # "device" | "device_sharded" |
                                      # "device_sharded_pool" | "greedi"
    block_m: Optional[int] = None,
    mesh=None,
    data_axes: Sequence[str] = ("data",),
) -> OptResult:
    """Run a round-candidate strategy under a device execution plan.

    ``cand_rounds`` carries the per-round candidate indices for the dense
    and stochastic strategies ((k, m), global indices); the lazy strategy
    derives its candidates on device and takes ``top_b`` instead (0 → the
    default re-score width of 256). A stochastic round whose sample row is
    entirely exhausted by earlier selections raises rather than silently
    re-selecting a taken index.

    Plans: ``device`` (the k rounds on one device), and the mesh plans of
    :mod:`repro_torch.core.distributed`, run by every rank of ``mesh`` (a
    ``DeviceMesh``; None is a 1-D mesh over the default process group) with
    the same arguments: ``device_sharded`` (V and the cache row-sharded
    over ``data_axes``, the candidate payload replicated),
    ``device_sharded_pool`` (the payload row-shards too: candidate blocks
    and the round's winner are gathered from their owners), ``greedi``
    (dense only: each rank greedily solves its own partition, the p·k
    partial solutions are gathered, and a merge greedy runs under the
    sharded cache; selections carry the GreeDi bound instead of matching
    centralized greedy). Every rank returns the same result.
    """
    mesh_plans = ("device_sharded", "device_sharded_pool", "greedi")
    if plan != "device" and plan not in mesh_plans:
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

    cand_t = torch.as_tensor(np.asarray(cand_rounds, np.int64),
                             device=f.device)
    if plan == "device":
        bm = block_m if block_m is not None \
            else _device_block_m(f.n, m_widest)
        sel, traj, n_scored = _select_scan(
            f.V, f.cache_seed, f.row_aux, cand_t, w0, fn=fn, kind=kind, k=k,
            top_b=top_b, distance=f.cfg.distance, policy=policy, block_m=bm,
            backend=backend, rbf_gamma=rbf_gamma)
    elif plan == "greedi":
        from repro_torch.core import distributed

        if kind != "dense":
            raise ValueError(
                "plan 'greedi' partitions the *dense* greedy strategy; "
                f"strategy {kind!r} has no partition-then-merge form here")
        if cand_rounds.shape[1] != f.n:
            raise ValueError(
                "plan 'greedi' partitions the full ground set; candidate "
                "subsets are not supported (every V row must be eligible "
                "in its own partition)")
        sel, traj, n_scored = distributed.run_greedi_selection(
            f, w0, k=k, block_m=block_m, mesh=mesh, data_axes=data_axes,
            backend=backend, rbf_gamma=rbf_gamma)
    else:
        from repro_torch.core import distributed

        sel, traj, n_scored = distributed.run_sharded_selection(
            f, cand_t, w0, kind=kind, k=k, top_b=top_b, m_widest=m_widest,
            block_m=block_m, mesh=mesh, data_axes=data_axes,
            backend=backend, rbf_gamma=rbf_gamma,
            pool_plan="sharded" if plan == "device_sharded_pool"
            else "replicated")

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


def _stack_batch_payload(fs: Sequence[SubmodularFunction]) -> dict:
    """Stack B same-signature requests into one (B, …) payload on their
    device: ``torch.stack`` of the functions' resident tensors, so V never
    leaves the device. The stacked seed is a fresh buffer (a function's
    ``cache_seed`` may alias its resident ``d_e0``, and the engine must not
    write it)."""
    f0 = fs[0]
    dev = f0.device
    w0 = [f.e0 if f.e0 is not None else torch.zeros(
        (f.dim,), dtype=f0.V.dtype, device=dev) for f in fs]
    return {"V": torch.stack([f.V for f in fs]),
            "seed": torch.stack([f.cache_seed.to(torch.float32) for f in fs]),
            "aux": torch.stack([f.row_aux for f in fs]),
            "w0": torch.stack(w0).to(f0.V.dtype)}


def stage_selection_batch(fs: Sequence[SubmodularFunction], *,
                          plan: str = "device", mesh=None,
                          data_axes: Sequence[str] = ("data",)
                          ) -> Optional[dict]:
    """Stack a bucket's payload ahead of its dispatch (single use: one
    ``run_selection_batch(..., staged=...)`` call with the same ``fs`` and
    plan). Under the batched mesh plans each rank stacks its own (B, n/p)
    rows (:func:`repro_torch.core.distributed.stage_sharded_batch`).

    The stacking is enqueued on the calling thread's current CUDA stream,
    so it is ordered with any dispatch on that stream: no copy can race its
    use, and none overlaps a dispatch (that needs a second stream, an event
    and ``record_stream``, and is later work).
    """
    if not fs:
        return None
    if plan == "device":
        return _stack_batch_payload(fs)
    if plan in ("device_sharded", "device_sharded_pool"):
        from repro_torch.core import distributed

        return distributed.stage_sharded_batch(
            fs, mesh=mesh, data_axes=data_axes,
            pool_plan="sharded" if plan == "device_sharded_pool"
            else "replicated")
    raise ValueError(f"unknown batched execution plan {plan!r}")


def run_selection_batch(
    fs: Sequence[SubmodularFunction],
    *,
    kind: str,                        # "dense" | "stochastic" | "lazy"
    k: int,
    ks: Optional[Sequence[int]] = None,
    cand_rounds: Optional[np.ndarray] = None,
    top_b: int = 0,
    block_m: Optional[int] = None,
    plan: str = "device",
    mesh=None,
    data_axes: Sequence[str] = ("data",),
    staged: Optional[dict] = None,
) -> list[OptResult]:
    """Solve B independent selection requests in one batched dispatch.

    Every request in ``fs`` must share one signature — function spec,
    (n, d) payload shape and dtype, device and ``EvalConfig`` — which is
    what the serving layer's bucketing guarantees. ``k`` is the shared round
    count; ``ks`` optionally gives each request its own effective k ≤ k
    (request b freezes after ``ks[b]`` rounds and its result is truncated
    to ``ks[b]``; ``ks[b] = 0`` marks an inert bucket-padding slot).

    ``cand_rounds`` is (B, k, m) per-request candidate indices for the
    dense/stochastic strategies; dense may pass None for the whole ground
    set. Per-request selections, trajectories and evaluation counts equal B
    :func:`run_selection` calls — only the launches are shared. ``staged``
    optionally passes the payload :func:`stage_selection_batch` built for
    the same ``fs`` and plan.

    ``plan`` composes the batch axis with the execution plans: ``"device"``
    ((B, n) state on one device) or ``"device_sharded"`` /
    ``"device_sharded_pool"`` (run by every rank of ``mesh``: (B, n/p)
    state per rank, every request's gain partials in one collective per
    scored batch, and each request's result bit for bit its unbatched
    :func:`run_selection` under the same plan).
    """
    if not fs:
        return []
    if plan not in ("device", "device_sharded", "device_sharded_pool"):
        raise ValueError(f"unknown batched execution plan {plan!r}")
    f0 = fs[0]
    B = len(fs)
    fn = f0.spec
    for f in fs[1:]:
        if f.spec != fn:
            raise ValueError(
                f"batched requests must share one function spec, got "
                f"{fn} and {f.spec}")
        if f.V.shape != f0.V.shape or f.V.dtype != f0.V.dtype \
                or f.device != f0.device:
            raise ValueError(
                f"batched requests must share one (n, d) payload shape, "
                f"dtype and device, got {tuple(f0.V.shape)} {f0.V.dtype} "
                f"on {f0.device} and {tuple(f.V.shape)} {f.V.dtype} on "
                f"{f.device} — bucket by signature before dispatching")
        if f.cfg != f0.cfg:
            raise ValueError(
                "batched requests must share one EvalConfig (distance / "
                "policy / backend pick the dispatch)")
    ks = [int(k)] * B if ks is None else [int(x) for x in ks]
    if len(ks) != B:
        raise ValueError(f"ks has {len(ks)} entries for {B} requests")
    if any(kb < 0 or kb > k for kb in ks):
        raise ValueError(f"per-request k must lie in [0, {k}], got {ks}")
    if k == 0 or all(kb == 0 for kb in ks):
        return [OptResult([], 0.0, [], 0) for _ in fs]
    if fn.name not in fx.DEVICE_PLAN_ELIGIBLE:
        raise ValueError(
            f"function {fn.name!r} has no n-aligned vec cache to batch-scan "
            f"over — it runs on the host execution plans only")
    policy = f0.cfg.resolved_policy()
    backend = "cuda" if f0.cfg.backend == "cuda" else "torch"
    if fx.kernel_template(fn) is None:
        backend = "torch"
    if backend == "cuda" and f0.cfg.distance not in dist_mod.MXU_ELIGIBLE:
        raise ValueError(
            f"device plans with the cuda backend support "
            f"{sorted(dist_mod.MXU_ELIGIBLE)}, got {f0.cfg.distance!r}")
    rbf_gamma = dist_mod.RBF_GAMMA \
        if (backend == "cuda" and f0.cfg.distance == "rbf") else None
    n = f0.n

    if kind == "lazy":
        top_b = max(1, min(top_b or 256, n))
        cand_rounds = np.zeros((B, 1, 0), np.int64)
        m_widest = n
    else:
        if cand_rounds is None:
            if kind != "dense":
                raise ValueError(f"strategy {kind!r} needs cand_rounds")
            cand_rounds = np.broadcast_to(
                np.arange(n, dtype=np.int64)[None, None, :], (B, 1, n))
        cand_rounds = np.asarray(cand_rounds)
        if cand_rounds.ndim != 3 or cand_rounds.shape[0] != B:
            raise ValueError(
                f"batched cand_rounds must be (B, k, m), got "
                f"{cand_rounds.shape} for B={B}")
        if kind == "dense" and cand_rounds.shape[1] != 1:
            cand_rounds = cand_rounds[:, :1]
        for b, kb in enumerate(ks):
            if kb == 0:
                continue
            n_cand = len(np.unique(
                cand_rounds[b, 0] if kind == "dense" else cand_rounds[b]))
            if kb > n_cand:
                raise ValueError(
                    f"request {b}: cannot select k={kb} exemplars from "
                    f"{n_cand} distinct candidates")
        m_widest = cand_rounds.shape[2]

    dev = f0.device
    cand_t = torch.as_tensor(np.array(cand_rounds, np.int64), device=dev)
    k_eff = torch.as_tensor(ks, dtype=torch.long, device=dev)
    if plan == "device":
        bm = block_m if block_m is not None \
            else _device_block_m(n, m_widest, n_batch=B)
        payload = staged if staged is not None else _stack_batch_payload(fs)
        sel, traj, n_scored = _select_scan_batched(
            payload["V"], payload["seed"], payload["aux"], cand_t,
            payload["w0"], k_eff, fn=fn, kind=kind, k=k, top_b=top_b,
            distance=f0.cfg.distance, policy=policy, block_m=bm,
            backend=backend, rbf_gamma=rbf_gamma)
    else:
        from repro_torch.core import distributed

        sel, traj, n_scored = distributed.run_sharded_selection_batch(
            fs, cand_t, k_eff, kind=kind, k=k, top_b=top_b,
            m_widest=m_widest, block_m=block_m, mesh=mesh,
            data_axes=data_axes, backend=backend, rbf_gamma=rbf_gamma,
            pool_plan="sharded" if plan == "device_sharded_pool"
            else "replicated", staged=staged)
    sel = sel.cpu().numpy()            # (k, B)
    traj = traj.cpu().numpy()          # (k, B)
    n_scored = n_scored.cpu().numpy()  # (B,)
    out = []
    for b, kb in enumerate(ks):
        sb = [int(x) for x in sel[:kb, b]]
        if any(x < 0 for x in sb):
            bad = sb.index(-1)
            raise ValueError(
                f"request {b}, round {bad} had no untaken candidate (its "
                f"sample row is exhausted by earlier selections)")
        tb = [float(x) for x in traj[:kb, b]]
        out.append(OptResult(sb, tb[-1] if tb else 0.0, tb, int(n_scored[b])))
    return out
