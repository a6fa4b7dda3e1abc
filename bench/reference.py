"""The plain reference: exemplar clustering and greedy selection from the
paper's definitions, in float64 torch, in blocks.

    L(S) = |V|⁻¹ Σ_i min_{s ∈ S ∪ {e0}} ‖v_i − s‖²,   e0 = 0
    f(S) = L(∅) − L(S)
    Δ(c | S) = f(S ∪ {c}) − f(S) = |V|⁻¹ Σ_i max(m_i − ‖v_i − c‖², 0),
    m_i = min_{s ∈ S ∪ {e0}} ‖v_i − s‖²

It reads only what the benchmark drew (the ground set, the sets' indices)
and, to judge them, the program's answers. Each precision names how the
payload is rounded before the float64 arithmetic: ``fp32`` (as drawn),
``fp16`` and ``bf16`` (the half policies, which round V and the sets once
and accumulate in float32), and the controls one step below them: ``tf32``
(the products' operands rounded to TF32, the norms kept) and ``fp8``
(float8 e4m3).
"""
from __future__ import annotations

import math

import torch

PRECISIONS = ("fp32", "fp16", "bf16", "tf32", "fp8")
#: Columns of the distance matrix held at once: n × COLS float64.
COLS = 2048


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def payload(x: torch.Tensor, precision: str) -> torch.Tensor:
    """The float64 values that ``precision`` computes with."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    dtype = {"fp16": torch.float16, "bf16": torch.bfloat16,
             "fp8": torch.float8_e4m3fn}.get(precision)
    x = x.to(torch.float32)
    if dtype is not None:
        x = x.to(dtype)
    return x.to(torch.float64)


class Ground:
    """A ground set as one precision sees it, with its norms and L(∅)."""

    def __init__(self, V: torch.Tensor, precision: str):
        self.P = payload(V, precision)
        # the products' operands: TF32 rounds them, the norms stay exact
        self.Q = tf32(V).to(torch.float64) if precision == "tf32" else self.P
        self.norms = torch.sum(self.P * self.P, dim=1)
        self.n = self.P.shape[0]
        self.L0 = float(torch.mean(self.norms))

    def dists(self, cols: torch.Tensor) -> torch.Tensor:
        """(n, len(cols)) squared distances to the ground-set rows ``cols``."""
        D = self.norms[:, None] + self.norms[cols][None, :]
        D.addmm_(self.Q, self.Q[cols].T, alpha=-2.0)
        return D.clamp_min_(0.0)

    def gains(self, cache: torch.Tensor) -> torch.Tensor:
        """(n,) Δ(c | S) of every ground-set row c against the cache m."""
        out = torch.empty(self.n, dtype=torch.float64, device=self.P.device)
        for s in range(0, self.n, COLS):
            cols = torch.arange(s, min(s + COLS, self.n), device=self.P.device)
            D = self.dists(cols)
            out[s:s + COLS] = torch.sub(cache[:, None], D, out=D) \
                .clamp_min_(0.0).sum(dim=0) / self.n
        return out


def multiset_values(V: torch.Tensor, idx: torch.Tensor,
                    precision: str) -> torch.Tensor:
    """(l,) float64 f(S_j) of the sets S_j = V[idx[j]]."""
    return _values(Ground(V, precision), idx)


def _values(g: Ground, idx: torch.Tensor) -> torch.Tensor:
    l, k = idx.shape
    per = max(1, COLS // k)
    out = []
    for s in range(0, l, per):
        block = idx[s:s + per]
        D = g.dists(block.reshape(-1)).view(g.n, block.shape[0], k)
        m = torch.minimum(torch.amin(D, dim=2), g.norms[:, None])
        out.append(g.L0 - torch.mean(m, dim=0))
    return torch.cat(out)


def multiset_gap(V: torch.Tensor, idx: torch.Tensor, values,
                 precision: str) -> float:
    """Widest gap between the program's f(S_j) and the reference's, as a
    share of L(∅)."""
    g = Ground(V, precision)
    ref = _values(g, idx)
    got = torch.as_tensor(values, dtype=torch.float64, device=ref.device)
    if got.shape != ref.shape or not bool(torch.all(torch.isfinite(got))):
        return math.inf
    return float(torch.max(torch.abs(got - ref))) / g.L0


def greedy_gap(V: torch.Tensor, picks, values, precision: str,
               exact: bool = True) -> float:
    """Judge one selection: ``picks`` and ``values`` (f after each pick).

    Follows the program's picks. Round t reads two gaps, as shares of L(∅):
    how far the program's f(S_{t+1}) lies from the reference's, and (for an
    exact greedy, ``exact``) how far the pick's gain lies below the best
    gain of any candidate not yet taken. Returns the widest."""
    g = Ground(V, precision)
    if len(picks) != len(values) or len(set(picks)) != len(picks) \
            or any(not 0 <= p < g.n for p in picks) \
            or not all(math.isfinite(v) for v in values):
        return math.inf
    cache = g.norms.clone()
    taken = torch.zeros(g.n, dtype=torch.bool, device=g.P.device)
    f_t, worst = 0.0, 0.0
    for p, v in zip(picks, values):
        if exact:
            gains = g.gains(cache).masked_fill_(taken, -math.inf)
            best = float(torch.max(gains))
        cache = torch.minimum(
            cache, g.dists(torch.tensor([p], device=g.P.device))[:, 0])
        f_next = g.L0 - float(torch.mean(cache))
        worst = max(worst, abs(v - f_next) / g.L0)
        if exact:
            worst = max(worst, (f_t + best - f_next) / g.L0)
        taken[p] = True
        f_t = f_next
    return worst


def greedy_select(V: torch.Tensor, k: int, precision: str):
    """The reference's own greedy: k picks and f after each (the control
    runs it one precision below the configuration's)."""
    g = Ground(V, precision)
    cache = g.norms.clone()
    taken = torch.zeros(g.n, dtype=torch.bool, device=g.P.device)
    picks, values = [], []
    for _ in range(k):
        p = int(torch.argmax(g.gains(cache).masked_fill_(taken, -math.inf)))
        cache = torch.minimum(
            cache, g.dists(torch.tensor([p], device=g.P.device))[:, 0])
        picks.append(p)
        values.append(g.L0 - float(torch.mean(cache)))
        taken[p] = True
    return picks, values
