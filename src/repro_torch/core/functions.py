"""Submodular functions behind ONE cache-semantics protocol (paper Def. 5 +).

``ExemplarClustering`` is the paper's function

    f(S) = L({e0}) − L(S ∪ {e0})

wrapped around the multiset evaluation engine, plus the *optimizer-aware
incremental interface* (min-distance cache) used by Greedy.

Every execution plan consumes a function through its cache protocol:

* ``init_cache() -> (vec, aux)`` — the empty-set cache: a per-element (n,)
  float32 vector plus one scalar of winner-dependent state (0 for exemplar).
* ``gains_from_cache(cache, idx) -> (m,)`` — marginal gains of candidate
  *indices* against the cache.
* ``fold_winner(cache, j) -> cache`` — fold one accepted winner in.
* ``value_from_cache(cache) -> float`` — f(S) from the cache alone.

The protocol helpers below (``gains_rows`` / ``fold_vec_rows`` /
``stat_rows`` / ``value_from_stat`` / …) are the ONE definition of each
objective's arithmetic, dispatched on a hashable :class:`FnSpec`; the host
protocol methods and the device plan both call them, which is what makes
their selections agree. The helpers carry every objective of the reference's
zoo; this package ports ``ExemplarClustering`` (the other classes come in a
later slice).

Similarity objectives use ONE transform of the configured distance,
``s(x, y) = relu(SIM_ALPHA + SIM_BETA · d(x, y))``, which the CUDA gain
kernels evaluate in-tile (the ``fold="max"`` template).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import distances as dist_mod
from repro_torch.core.evaluator import EvalConfig, e0_distances, evaluate_multiset
from repro_torch.core.multiset import (PackedMultiset, pack_base_plus_candidates,
                                       pack_sets, resolve_device)

#: Similarity transform s = relu(SIM_ALPHA + SIM_BETA · d): the ONE affine
#: the kernels evaluate in-tile.
SIM_ALPHA = 1.0
SIM_BETA = -0.5
#: s(x, x) — the affine at d = 0 (every registered distance has d(x,x)=0).
SIM_SELF = 1.0

#: Functions the device execution plan can run: an (n,)-vec cache folded by
#: winner distances.
DEVICE_PLAN_ELIGIBLE = frozenset(
    {"exemplar", "facility_location", "graph_cut", "saturated_coverage"})


class FnSpec(NamedTuple):
    """Hashable identity of a submodular objective. ``lam`` (graph cut) and
    ``sat`` (saturated coverage) are the only per-function parameters that
    reach the arithmetic."""

    name: str = "exemplar"
    lam: float = 0.0
    sat: float = 0.0


# ---------------------------------------------------------------------------
# Protocol semantics, dispatched on the FnSpec.
# ---------------------------------------------------------------------------


def similarity(D):
    """s = relu(SIM_ALPHA + SIM_BETA · d) applied elementwise."""
    return torch.clamp_min(SIM_ALPHA + SIM_BETA * D, 0.0)


def kernel_template(spec: FnSpec):
    """The (fold, affine) parameterization of the shared CUDA gain-kernel
    template, or None when the function has no kernel form.

    ``fold="min"`` scores ``relu(cache − d)`` (the exemplar min-cache);
    ``fold="max"`` scores ``relu((α + β·d) − cache)`` — the max-cache dual,
    exact because the cache is ≥ 0 so the inner relu of the similarity is
    redundant inside the outer one.
    """
    if spec.name == "exemplar":
        return ("min", None)
    if spec.name in ("facility_location", "graph_cut"):
        return ("max", (SIM_ALPHA, SIM_BETA))
    return None


def kernel_fused_ok(spec: FnSpec) -> bool:
    """Whether the fused fold-and-score kernel applies: the fold must be the
    min/max of the template (graph cut scores through the max template but
    folds by addition, outside)."""
    return spec.name in ("exemplar", "facility_location")


def score_cache_rows(spec: FnSpec, vec, row_aux):
    """The per-row baseline the gain formula subtracts against — what the
    kernel template receives as its ``cache`` operand (graph cut scores
    against its static row_aux)."""
    if spec.name == "graph_cut":
        return row_aux
    return vec


def gains_rows(spec: FnSpec, sc, D, row_aux):
    """(n, m) per-row gain contributions (pre-normalizer) of candidates with
    distance columns ``D`` against score-cache rows ``sc``."""
    if spec.name == "exemplar":
        return torch.clamp_min(sc[:, None] - D, 0.0)
    if spec.name in ("facility_location", "graph_cut"):
        return torch.clamp_min((SIM_ALPHA + SIM_BETA * D) - sc[:, None], 0.0)
    if spec.name == "saturated_coverage":
        s = similarity(D)
        cap = row_aux[:, None]
        return torch.minimum(sc[:, None] + s, cap) - torch.minimum(sc[:, None], cap)
    raise ValueError(f"no row-gain form for function {spec.name!r}")


def gains_formula_spec(spec: FnSpec, V, cands, sc, row_aux, pair, policy,
                       n_total=None):
    """Candidate gains (m,). ``n_total`` overrides the |V| normalizer.
    Graph cut's winner-indexed penalty is NOT included here — callers add
    :func:`gains_index_extra`."""
    D = pair(V, cands, policy)  # (n, m)
    rows = gains_rows(spec, sc, D, row_aux)
    return torch.sum(rows, dim=0) / (V.shape[0] if n_total is None else n_total)


def gains_index_extra(spec: FnSpec, vec, gidx, off, n_loc, n_total):
    """Per-candidate additive gain term that reads the candidate's OWN cache
    entry (graph cut's redundancy penalty −(λ/n)(2·cov_S(c) + s_cc)); None
    for every other function."""
    if spec.name != "graph_cut":
        return None
    rel = gidx - off
    own = (rel >= 0) & (rel < n_loc)
    vc = vec[torch.clamp(rel, 0, n_loc - 1)]
    return torch.where(own, -(spec.lam / n_total) * (2.0 * vc + SIM_SELF),
                       0.0).to(torch.float32)


def fold_vec_rows(spec: FnSpec, vec, dw):
    """Fold one winner's float32 distance column ``dw`` into the cache rows."""
    if spec.name == "exemplar":
        return torch.minimum(vec, dw)
    if spec.name == "facility_location":
        return torch.maximum(vec, similarity(dw))
    if spec.name in ("graph_cut", "saturated_coverage"):
        return vec + similarity(dw)
    raise ValueError(f"no vec fold for function {spec.name!r}")


def fold_aux(spec: FnSpec, vec, aux, gidx, off, n_loc):
    """Advance the scalar aux state for winner index ``gidx`` (computed from
    the cache BEFORE the winner's column folds in). Graph cut accumulates
    its pairwise penalty P ← P + 2·cov_S(w) + s_ww; every other function
    returns ``aux`` unchanged."""
    if spec.name != "graph_cut":
        return aux
    rel = gidx - off
    own = (rel >= 0) & (rel < n_loc)
    vw = torch.where(own, vec[torch.clamp(rel, 0, n_loc - 1)], 0.0)
    return aux + 2.0 * vw + SIM_SELF


def stat_rows(spec: FnSpec, vec, row_aux):
    """The per-row statistic whose global mean enters the trajectory value;
    dead (padding) rows are masked through ``row_aux``."""
    if spec.name == "exemplar":
        return vec
    if spec.name in ("facility_location", "graph_cut"):
        return torch.where(torch.isinf(row_aux), 0.0, vec)
    if spec.name == "saturated_coverage":
        return torch.minimum(vec, row_aux)
    raise ValueError(f"no stat form for function {spec.name!r}")


def value_from_stat(spec: FnSpec, v0, mean_stat, aux=0.0, n_total=1):
    """f(S) from the global stat mean: exemplar's L0 − mean(cache), the
    coverage functions' mean directly, graph cut's mean minus the aux
    penalty. ``v0`` is the empty-set baseline."""
    if spec.name == "exemplar":
        return v0 - mean_stat
    if spec.name == "graph_cut":
        return mean_stat - spec.lam * aux / n_total
    return mean_stat


def _index(idx, device) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


# ---------------------------------------------------------------------------
# The function classes
# ---------------------------------------------------------------------------


class SubmodularFunction:
    """Base of the function zoo: the cache-semantics protocol over (V, cfg).

    ``V`` given as numpy goes to ``device`` (``"cuda"`` unless the caller
    names another; with no GPU and no device this raises). ``V`` given as a
    tensor stays where it is unless ``device`` is named.
    """

    spec: FnSpec = FnSpec()

    def __init__(self, V, cfg: EvalConfig = EvalConfig(), e0=None,
                 device=None):
        if isinstance(V, torch.Tensor):
            dev = V.device if device is None else torch.device(device)
            self.V = V.to(dev)
        else:
            dev = resolve_device(device)
            self.V = torch.as_tensor(np.asarray(V), device=dev)
        self.device = dev
        self.cfg = cfg
        self.e0 = None if e0 is None else torch.as_tensor(e0, device=dev)
        self._row_aux: Optional[torch.Tensor] = None
        self._cache_seed: Optional[torch.Tensor] = None

    # -- per-function state -------------------------------------------------

    @property
    def cache_seed(self) -> torch.Tensor:
        """(n,) float32 empty-set cache vector (0 for coverage caches).
        Memoized and shared: callers that write must copy."""
        if self._cache_seed is None:
            self._cache_seed = torch.zeros((self.n,), dtype=torch.float32,
                                           device=self.device)
        return self._cache_seed

    @property
    def row_aux(self) -> torch.Tensor:
        """(n,) float32 static per-row auxiliary (caps / score baseline)."""
        if self._row_aux is None:
            self._row_aux = torch.zeros((self.n,), dtype=torch.float32,
                                        device=self.device)
        return self._row_aux

    @property
    def v0(self) -> float:
        """Empty-set baseline f-value term (mean of the real seed rows)."""
        return 0.0

    # -- the cache-semantics protocol ---------------------------------------

    def init_cache(self):
        """The empty-set cache ``(vec, aux)``, float32 regardless of policy:
        the cache seeds n-sized reductions, which overflow in f16 for large
        n even though the distances were computed at policy precision."""
        return (self.cache_seed,
                torch.zeros((), dtype=torch.float32, device=self.device))

    def gains_from_cache(self, cache, idx) -> torch.Tensor:
        """Δ(c | S) for candidate *indices* ``idx`` against the cache.

        The ``cuda`` backend routes through the shared min/max gain-kernel
        template when the function has one (see :func:`kernel_template`).
        """
        vec, _aux = cache
        idx = _index(idx, self.device)
        policy = self.cfg.resolved_policy()
        tmpl = kernel_template(self.spec)
        if self.cfg.backend == "cuda" and tmpl is not None:
            if self.cfg.distance not in dist_mod.MXU_ELIGIBLE:
                raise ValueError(
                    f"kernel marginal gains support "
                    f"{sorted(dist_mod.MXU_ELIGIBLE)}, got "
                    f"{self.cfg.distance!r}")
            from repro_torch.kernels import ops as kops

            g = kops.marginal_gain(
                self.V, self.V[idx],
                score_cache_rows(self.spec, vec, self.row_aux),
                policy=policy, fold=tmpl[0], score_affine=tmpl[1],
                rbf_gamma=dist_mod.RBF_GAMMA
                if self.cfg.distance == "rbf" else None)
        else:
            pair = dist_mod.resolve_pairwise(self.cfg.distance)
            sc = score_cache_rows(self.spec, vec, self.row_aux)
            g = gains_formula_spec(self.spec, self.V, self.V[idx], sc,
                                   self.row_aux, pair, policy, n_total=self.n)
        extra = gains_index_extra(self.spec, vec, idx, 0, self.n, self.n)
        return g if extra is None else g + extra

    def fold_winner(self, cache, j):
        """cache after folding winner index ``j`` in."""
        vec, aux = cache
        j = int(j)
        pair = dist_mod.resolve_pairwise(self.cfg.distance)
        dw = pair(self.V, self.V[j:j + 1],
                  self.cfg.resolved_policy())[:, 0].to(torch.float32)
        jt = torch.tensor(j, device=self.device)
        new_aux = fold_aux(self.spec, vec, aux, jt, 0, self.n)
        return fold_vec_rows(self.spec, vec, dw), new_aux

    def value_from_cache(self, cache) -> float:
        vec, aux = cache
        mean = torch.mean(stat_rows(self.spec, vec, self.row_aux))
        return float(value_from_stat(self.spec, self.v0, mean, aux, self.n))

    # -- metadata ------------------------------------------------------------

    @property
    def n(self) -> int:
        return self.V.shape[0]

    @property
    def dim(self) -> int:
        return self.V.shape[1]


class ExemplarClustering(SubmodularFunction):
    """Monotone submodular exemplar-clustering function over a ground set V.

    Args:
      V: (n, d) ground set (numpy or tensor).
      cfg: evaluation configuration (distance, precision, mode, backend).
      e0: auxiliary vector (paper: the all-zero vector). None → zeros.
      device: where numpy inputs go (default ``"cuda"``).
    """

    spec = FnSpec(name="exemplar")

    def __init__(self, V, cfg: EvalConfig = EvalConfig(), e0=None,
                 device=None):
        super().__init__(V, cfg, e0, device)
        # L({e0}) is S-independent; computed "conventionally" once (§IV-B-1)
        self.d_e0 = e0_distances(self.V, self.e0, cfg.distance, cfg.policy)
        self.L0 = float(torch.mean(self.d_e0.to(torch.float32)))

    @property
    def cache_seed(self) -> torch.Tensor:
        if self._cache_seed is None:
            self._cache_seed = self.d_e0.to(torch.float32)
        return self._cache_seed

    @property
    def v0(self) -> float:
        return self.L0

    # -- generic multiset interface (the paper's engine) --------------------

    def loss_multi(self, packed: PackedMultiset) -> torch.Tensor:
        """L(S_j ∪ {e0}) for all sets — (l,)."""
        return evaluate_multiset(self.V, packed, self.cfg, d_e0=self.d_e0)

    def value_multi(self, packed: PackedMultiset) -> torch.Tensor:
        """f(S_j) for all sets — (l,)."""
        return self.L0 - self.loss_multi(packed)

    def value(self, S) -> float:
        """f(S) for a single (k, d) set. Empty S → 0 (paper §IV)."""
        S = torch.as_tensor(S, device=self.device)
        if S.ndim != 2:
            raise ValueError(f"S must be (k, d), got {tuple(S.shape)}")
        if S.shape[0] == 0:
            return 0.0
        packed = PackedMultiset(
            S[None], torch.tensor([S.shape[0]], dtype=torch.int32,
                                  device=self.device))
        return float(self.value_multi(packed)[0])

    def value_sets(self, sets: Sequence[np.ndarray]) -> torch.Tensor:
        return self.value_multi(pack_sets(
            sets, dtype=self.cfg.resolved_policy().compute_dtype,
            device=self.device))

    def greedy_step_values(self, base: torch.Tensor,
                           candidates: torch.Tensor) -> torch.Tensor:
        """Paper-faithful greedy step: f(S ∪ {c_j}) for all candidates."""
        packed = pack_base_plus_candidates(base, candidates)
        return self.value_multi(packed)

    # -- optimizer-aware incremental interface (beyond paper) ---------------

    def init_mincache(self) -> torch.Tensor:
        """m_i = d(v_i, e0): the min-dist cache of S = ∅ (e0 always included)."""
        return self.d_e0.to(torch.float32).clone()

    def marginal_gains(self, candidates: torch.Tensor,
                       mincache: torch.Tensor, use_kernel: bool = False,
                       n_total: Optional[int] = None) -> torch.Tensor:
        """Δ(c_j | S) for all candidates given S's min-dist cache. O(n·m·d)."""
        policy = self.cfg.resolved_policy()
        if use_kernel or self.cfg.backend == "cuda":
            if self.cfg.distance not in dist_mod.MXU_ELIGIBLE:
                raise ValueError(
                    f"kernel marginal gains support "
                    f"{sorted(dist_mod.MXU_ELIGIBLE)}, got "
                    f"{self.cfg.distance!r}")
            from repro_torch.kernels import ops as kops

            return kops.marginal_gain(
                self.V, candidates, mincache, policy=policy,
                rbf_gamma=dist_mod.RBF_GAMMA
                if self.cfg.distance == "rbf" else None,
                n_total=n_total)
        pair = dist_mod.resolve_pairwise(self.cfg.distance)
        return gains_formula_spec(self.spec, self.V, candidates, mincache,
                                  None, pair, policy, n_total=n_total)

    def update_mincache(self, mincache: torch.Tensor,
                        new_point: torch.Tensor) -> torch.Tensor:
        pair = dist_mod.resolve_pairwise(self.cfg.distance)
        D = pair(self.V, new_point[None, :], self.cfg.resolved_policy())[:, 0]
        return torch.minimum(mincache, D)

    def value_from_mincache(self, mincache: torch.Tensor) -> float:
        return self.L0 - float(torch.mean(mincache))
