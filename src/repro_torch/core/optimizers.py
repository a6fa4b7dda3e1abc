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
from typing import Optional

import numpy as np
import torch

from repro_torch.core.engine import OptResult, run_selection, validate_candidates
from repro_torch.core.functions import ExemplarClustering, SubmodularFunction

#: Plans of the reference that this package does not run yet (ROADMAP A.7);
#: they reach :func:`run_selection`, which refuses them by name.
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
) -> OptResult:
    """Algorithm 1 of the paper. ``mode`` picks the evaluation style:

    ``"mincache"`` (alias ``"host"``) — host loop over rounds, device gains.
    ``"multiset"`` — paper-faithful: pack {S ∪ {c}} ∀c and call the engine.
    ``"device"``  — all k rounds on the device with no per-round host sync.
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
                             block_m=block_m)
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
) -> OptResult:
    """CELF: maintain stale upper bounds (submodularity ⇒ gains only shrink).

    ``mode="host"`` is the reference loop and the exact host-side mirror of
    the engine's rescore policy: stale bounds in an (n,) array, per round a
    loop re-scores the top-``batch`` stale candidates at once until the
    fresh-top invariant certifies the winner. Because host and device run
    the *same* policy, selections AND ``evaluations`` agree across modes.

    ``mode="device"`` runs CELF on the device: the stale bounds stay there
    and each iteration re-scores the top-``batch`` of them.
    """
    if k > f.n:
        raise ValueError(f"cannot select k={k} exemplars from n={f.n}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if k == 0:
        return OptResult([], 0.0, [], 0)
    if mode == "device" or mode in _MESH_PLANS:
        return run_selection(f, kind="lazy", k=k, top_b=batch, plan=mode)
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
                             plan=mode, block_m=block_m)
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


OPTIMIZERS = {
    "greedy": greedy,
    "lazy_greedy": lazy_greedy,
    "stochastic_greedy": stochastic_greedy,
}
