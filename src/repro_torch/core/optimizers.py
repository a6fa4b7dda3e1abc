"""The greedy family of submodular maximizers on the evaluation engine.

Every optimizer here evaluates *many* sets per step — the paper's central
observation ("optimizer-aware", §IV-A). Three evaluation styles are used:

* **multiset** — the paper-faithful path: each step packs
  ``{S ∪ {c_1}, …, S ∪ {c_m}}`` and calls the work-matrix engine. O(n·k·l).
* **mincache** — the beyond-paper incremental path: gains against the
  min-distance cache. O(n·l·d) per step (k drops out).
* **device** — the mincache recurrence kept entirely on the device by the
  selection engine (:mod:`repro_torch.core.engine`): gains, argmax and the
  cache update never leave it, and dense/stochastic rounds never wait on
  the host.
* **mesh plans** — ``mode="device_sharded"`` / ``"device_sharded_pool"``
  (all three strategies) and ``"greedi"`` (greedy) run the same rounds on
  every rank of a ``torch.distributed`` mesh, with V and the cache
  row-sharded (:mod:`repro_torch.core.distributed`); the sieve family's
  ``mode="device_sharded"`` column-shards the sieve table. Every rank calls
  the optimizer with the same arguments.

The min-distance cache obeys the recurrence

    m_i^(0)   = d(v_i, e0)
    m_i^(t+1) = min(m_i^(t), d(v_i, s_{t+1}))          (s_{t+1} = round-t winner)
    Δ(c | S_t) = |V|⁻¹ Σ_i max(m_i^(t) − d(v_i, c), 0)
    f(S_t)     = L({e0}) − |V|⁻¹ Σ_i m_i^(t)

For the greedy family ``evaluations`` counts **actually-scored candidates**:
candidates whose gain entered a round's argmax (already-selected candidates
are masked out before the argmax and do not count). Host and device plans
count identically.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import OptResult, run_selection, validate_candidates
from repro_torch.core.functions import ExemplarClustering, SubmodularFunction

#: The mesh plans (:mod:`repro_torch.core.distributed`), routed through
#: :func:`run_selection` like ``"device"``.
_MESH_PLANS = ("device_sharded", "device_sharded_pool", "greedi")


def _require_exemplar(f: SubmodularFunction, what: str) -> ExemplarClustering:
    if f.spec.name != "exemplar":
        raise ValueError(
            f"{what} is exemplar-only (it evaluates through the packed "
            f"multiset / L0 interface); function {f.spec.name!r} runs on "
            f"the cache-protocol paths instead")
    return f


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().copy()


def greedy(
    f: SubmodularFunction,
    k: int,
    mode: str = "mincache",
    candidates: Optional[np.ndarray] = None,
    block_m: Optional[int] = None,
    mesh=None,
    data_axes: Sequence[str] = ("data",),
) -> OptResult:
    """Algorithm 1 of the paper. ``mode`` picks the evaluation style:

    ``"mincache"`` (alias ``"host"``) — host loop over rounds, device gains.
    ``"multiset"`` — paper-faithful: pack {S ∪ {c}} ∀c and call the engine.
    ``"device"``  — all k rounds on the device with no per-round host sync.
    ``"device_sharded"`` / ``"device_sharded_pool"`` / ``"greedi"`` — the
    mesh plans over ``mesh`` (a ``DeviceMesh``; None: 1-D over the default
    process group), V row-sharded over ``data_axes``.
    """
    n = f.n
    cand_idx = np.arange(n) if candidates is None \
        else validate_candidates(candidates, n)
    if k > len(cand_idx):
        raise ValueError(
            f"cannot select k={k} exemplars from {len(cand_idx)} distinct "
            f"candidates")
    if mode == "host":
        mode = "mincache"
    if mode == "device" or mode in _MESH_PLANS:
        # ONE candidate row: the engine scores it in every round
        return run_selection(f, kind="dense", k=k,
                             cand_rounds=cand_idx[None, :], plan=mode,
                             block_m=block_m, mesh=mesh, data_axes=data_axes)
    selected: list[int] = []
    traj: list[float] = []
    evals = 0
    if mode == "mincache":
        cache = f.init_cache()
        for _ in range(k):
            gains = _host(f.gains_from_cache(cache, cand_idx))
            masked = np.isin(cand_idx, selected)
            evals += len(cand_idx) - int(masked.sum())
            gains[masked] = -np.inf
            j = int(cand_idx[int(np.argmax(gains))])
            selected.append(j)
            cache = f.fold_winner(cache, j)
            traj.append(f.value_from_cache(cache))
    elif mode == "multiset":
        f = _require_exemplar(f, "greedy mode='multiset'")
        cand_t = torch.as_tensor(cand_idx, device=f.device)
        for _ in range(k):
            base = f.V[torch.as_tensor(selected, dtype=torch.long,
                                       device=f.device)]
            vals = _host(f.greedy_step_values(base, f.V[cand_t]))
            masked = np.isin(cand_idx, selected)
            evals += len(cand_idx) - int(masked.sum())
            vals[masked] = -np.inf
            j = int(cand_idx[int(np.argmax(vals))])
            selected.append(j)
            traj.append(float(vals.max()))
    else:
        raise ValueError(f"unknown greedy mode {mode!r}")
    return OptResult(selected, traj[-1] if traj else 0.0, traj, evals)


def lazy_greedy(
    f: SubmodularFunction,
    k: int,
    batch: int = 256,
    mode: str = "host",
    mesh=None,
    data_axes: Sequence[str] = ("data",),
) -> OptResult:
    """CELF: maintain stale upper bounds (submodularity ⇒ gains only shrink).

    ``mode="host"`` is the reference loop and the exact host-side mirror of
    the engine's rescore policy: stale bounds in an (n,) array, per round a
    loop re-scores the top-``batch`` stale candidates at once until the
    fresh-top invariant certifies the winner. Because host and device run
    the *same* policy, selections AND ``evaluations`` agree across modes.

    ``mode="device"`` runs CELF on the device: the stale bounds stay there
    and each iteration re-scores the top-``batch`` of them; the mesh plans
    row-shard V and the cache over ``mesh``, with the bound state
    replicated.
    """
    if k > f.n:
        raise ValueError(f"cannot select k={k} exemplars from n={f.n}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if k == 0:
        return OptResult([], 0.0, [], 0)
    if mode == "device" or mode in _MESH_PLANS:
        return run_selection(f, kind="lazy", k=k, top_b=batch, plan=mode,
                             mesh=mesh, data_axes=data_axes)
    if mode != "host":
        raise ValueError(f"unknown lazy_greedy mode {mode!r}")
    n = f.n
    B = max(1, min(batch, n))
    cache = f.init_cache()
    all_idx = np.arange(n)
    ub = np.asarray(_host(f.gains_from_cache(cache, all_idx)), np.float32)
    evals = n
    taken = np.zeros(n, bool)
    selected: list[int] = []
    traj: list[float] = []
    for _ in range(k):
        fresh = np.zeros(n, bool)
        while True:
            stale_vals = np.where(fresh | taken, -np.inf, ub)
            fresh_best = np.max(np.where(fresh & ~taken, ub, -np.inf))
            if fresh_best >= stale_vals.max():
                break  # fresh-top invariant: the fresh best is the argmax
            top_idx = np.argsort(-stale_vals, kind="stable")[:B]
            top_idx = top_idx[stale_vals[top_idx] > -np.inf]
            ub[top_idx] = _host(f.gains_from_cache(cache, top_idx))
            fresh[top_idx] = True
            evals += len(top_idx)
        j = int(np.argmax(np.where(fresh & ~taken, ub, -np.inf)))
        selected.append(j)
        taken[j] = True
        cache = f.fold_winner(cache, j)
        traj.append(f.value_from_cache(cache))
    return OptResult(selected, traj[-1] if traj else 0.0, traj, evals)


def stochastic_greedy(
    f: SubmodularFunction, k: int, eps: float = 0.05, seed: int = 0,
    mode: str = "host", block_m: Optional[int] = None,
    mesh=None, data_axes: Sequence[str] = ("data",),
) -> OptResult:
    """Sample ⌈(n/k)·ln(1/ε)⌉ candidates per round; (1−1/e−ε) in expectation.

    All k rounds' candidate samples are drawn up front from
    ``np.random.default_rng(seed)`` — the same draw as the JAX package, so a
    seed names the same samples in both — and host and device consume them
    identically; already-selected candidates are masked at scoring time.
    Each round draws k extra candidates so that after masking at most k
    selected ones, at least the required m fresh candidates remain.
    """
    n = f.n
    if k > n:
        raise ValueError(f"cannot select k={k} exemplars from n={n}")
    if k == 0:
        return OptResult([], 0.0, [], 0)
    rng = np.random.default_rng(seed)
    m = min(n, int(math.ceil(n / k * math.log(1.0 / eps))))
    m_draw = min(n, m + k)
    samples = np.stack(
        [rng.choice(n, size=m_draw, replace=False) for _ in range(k)])
    if mode == "device" or mode in _MESH_PLANS:
        return run_selection(f, kind="stochastic", k=k, cand_rounds=samples,
                             plan=mode, block_m=block_m, mesh=mesh,
                             data_axes=data_axes)
    if mode != "host":
        raise ValueError(f"unknown stochastic_greedy mode {mode!r}")
    cache = f.init_cache()
    selected: list[int] = []
    traj: list[float] = []
    evals = 0
    for t in range(k):
        cand = samples[t]
        gains = _host(f.gains_from_cache(cache, cand))
        masked = np.isin(cand, selected)
        evals += len(cand) - int(masked.sum())
        gains[masked] = -np.inf
        j = int(cand[int(np.argmax(gains))])
        selected.append(j)
        cache = f.fold_winner(cache, j)
        traj.append(f.value_from_cache(cache))
    return OptResult(selected, traj[-1], traj, evals)


# ---------------------------------------------------------------------------
# Streaming sieves — built on the streaming sieve engine
# (:mod:`repro_torch.core.streaming`): a fixed-capacity table of threshold
# sieves keyed by integer exponent, offered every arriving element. Like the
# greedy family, each algorithm composes one accept-rule *variant* with an
# execution plan: ``mode="host"`` steps the table one call per element and
# reads each accept flag back (the exact mirror), ``mode="device"`` runs each
# stream block of B elements back to back on the device with no host read
# between them.
# ---------------------------------------------------------------------------


def _stream_eval_count(n_elements: int, n_sieves: int) -> int:
    """Streaming ``evaluations`` unit, identical across the sieve family:
    each arriving element is scored against every live sieve in one engine
    call (min. 1 — the singleton gain is always computed)."""
    return n_elements * max(n_sieves, 1)


def _stream(f: SubmodularFunction, order: Optional[Sequence[int]],
            seed: int) -> np.ndarray:
    """The stream order: ``order`` as given, else a shuffle of the ground
    set drawn from ``np.random.default_rng(seed)`` — the JAX package's
    draw, so a seed names the same stream in both."""
    idx = np.arange(f.n)
    if order is None:
        np.random.default_rng(seed).shuffle(idx)
        return idx
    return np.asarray(order)


def _stream_blocks(f: ExemplarClustering, order: Optional[Sequence[int]],
                   seed: int, block: int):
    """Yield (indices, distance rows, singleton gains) per stream block, as
    numpy: one distance product per block of B stream elements. Exemplar
    only: the singleton gains read d_e0 directly."""
    idx = _stream(f, order, seed)
    d_e0 = _host(f.d_e0.to(torch.float32))
    for s in range(0, len(idx), block):
        ib = idx[s:s + block]
        dmat = _host(f.point_distances_block(
            f.V[torch.as_tensor(ib, device=f.device)]).to(torch.float32))
        singles = np.maximum(d_e0[None, :] - dmat, 0.0).mean(axis=1)
        yield ib, dmat, singles


def _run_sieve(f: SubmodularFunction, k: int, eps: float, variant: str,
               order, seed: int, block_size: int, mode: str,
               s_max: Optional[int], mesh=None,
               data_axes: Sequence[str] = ("data",)) -> OptResult:
    """Drive a sieve-table engine over the stream under the host, device or
    column-sharded plan (``mode="device_sharded"`` or a ``mesh``)."""
    from repro_torch.core.streaming import make_sieve_engine

    idx = _stream(f, order, seed)
    eng = make_sieve_engine(f, k, eps, variant=variant, mode=mode,
                            s_max=s_max, block_size=block_size, mesh=mesh,
                            data_axes=data_axes)
    for s in range(0, len(idx), block_size):
        ib = idx[s:s + block_size]
        eng.offer(ib, f.V[torch.as_tensor(ib, device=f.device)])
    members, value = eng.best()
    return OptResult(members, value, [value], eng.evaluations())


def sieve_streaming(
    f: SubmodularFunction, k: int, eps: float = 0.1,
    order: Optional[Sequence[int]] = None, seed: int = 0,
    block_size: int = 64, mode: str = "host",
    s_max: Optional[int] = None, mesh=None,
    data_axes: Sequence[str] = ("data",),
) -> OptResult:
    """SieveStreaming [4]: thresholds (1+ε)^i ∈ [m, 2km], m = max singleton.

    ``mode="device"`` runs each stream block on the device with no host read
    between its elements; ``mode="host"`` is the per-element mirror;
    ``mode="device_sharded"`` (or a ``mesh``) column-shards the sieve table
    over the mesh's ``data_axes``, O(S_max·n/p) state per rank.
    ``s_max`` overrides the sieve-table capacity (see
    :mod:`repro_torch.core.streaming`).
    """
    return _run_sieve(f, k, eps, "sieve", order, seed, block_size, mode,
                      s_max, mesh=mesh, data_axes=data_axes)


def sieve_streaming_pp(
    f: SubmodularFunction, k: int, eps: float = 0.1,
    order: Optional[Sequence[int]] = None, seed: int = 0,
    block_size: int = 64, mode: str = "host",
    s_max: Optional[int] = None, mesh=None,
    data_axes: Sequence[str] = ("data",),
) -> OptResult:
    """SieveStreaming++ [19]: prune sieves below LB = best current value.

    LB moves after every accept, so the grid window is re-derived per
    element, on the device under ``mode="device"`` (and on every rank under
    ``mode="device_sharded"``).
    """
    return _run_sieve(f, k, eps, "pp", order, seed, block_size, mode, s_max,
                      mesh=mesh, data_axes=data_axes)


def three_sieves(
    f: SubmodularFunction, k: int, eps: float = 0.1, T: int = 50,
    order: Optional[Sequence[int]] = None, seed: int = 0,
    block_size: int = 64,
) -> OptResult:
    """ThreeSieves [18]: one sieve, threshold lowered after T rejections.
    Runs on the host in numpy over the distance rows of each block."""
    f = _require_exemplar(f, "three_sieves")
    cache = _host(f.init_mincache())
    members: list[int] = []
    evals = 0
    m_seen = 0.0
    tau_idx: Optional[int] = None  # current exponent into the (1+eps) grid
    rejections = 0
    done = False
    for ib, dmat, singles in _stream_blocks(f, order, seed, block_size):
        for bi, idx in enumerate(ib):
            if singles[bi] > m_seen:
                m_seen = float(singles[bi])
                hi = k * m_seen
                tau_idx = math.floor(math.log(hi) / math.log1p(eps)) \
                    if hi > 0 else None
                rejections = 0
            if tau_idx is None or len(members) >= k:
                # no gain computed for a full/unarmed sieve — and none
                # counted: ``evaluations`` reflects work actually done
                continue
            dvec = dmat[bi]
            gain = float(np.maximum(cache - dvec, 0.0).mean())
            evals += _stream_eval_count(1, 1)
            tau = (1 + eps) ** tau_idx
            f_cur = f.L0 - float(cache.mean())
            need = (tau - f_cur) / max(k - len(members), 1)
            if gain >= need:
                members.append(int(idx))
                cache = np.minimum(cache, dvec)
                rejections = 0
            else:
                rejections += 1
                if rejections >= T:
                    tau_idx -= 1
                    rejections = 0
                    if (1 + eps) ** tau_idx < m_seen / (2 * k):
                        done = True  # threshold exhausted
                        break
        if done:
            break
    value = f.L0 - float(cache.mean())
    return OptResult(members, value, [value], evals)


def salsa(
    f: SubmodularFunction, k: int, eps: float = 0.1,
    order: Optional[Sequence[int]] = None, seed: int = 0,
    block_size: int = 64, mode: str = "host",
    s_max: Optional[int] = None, mesh=None,
    data_axes: Sequence[str] = ("data",),
) -> OptResult:
    """Salsa [20], simplified: an ensemble of dense-threshold passes.

    Per OPT guess on the (1+ε) grid, a *dense* policy accepts element e into
    sieve S when Δ(e|S) ≥ r·OPT_guess/k, with r = 1/2 for the first ⌈k/2⌉
    members and 1/(2e) after (so k=1 still applies the early rate); the
    best sieve is returned. Single pass, same memory as SieveStreaming. The
    grid is grow-only; under capacity pressure the sieve table evicts the
    lowest exponent (see :mod:`repro_torch.core.streaming`).
    """
    return _run_sieve(f, k, eps, "salsa", order, seed, block_size, mode,
                      s_max, mesh=mesh, data_axes=data_axes)


OPTIMIZERS = {
    "greedy": greedy,
    "lazy_greedy": lazy_greedy,
    "stochastic_greedy": stochastic_greedy,
    "sieve_streaming": sieve_streaming,
    "sieve_streaming_pp": sieve_streaming_pp,
    "three_sieves": three_sieves,
    "salsa": salsa,
}
