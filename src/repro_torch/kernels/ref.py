"""Plain-torch oracles for every CUDA kernel in this package.

These mirror the *mathematical* definition, not the kernels' tiling, so a
tiling bug cannot cancel out. Norms widen the rounded payload wholesale: an
oracle favours plainness over memory traffic. The plain versions beside the
kernels (memory-bounded, in the kernels' rounding order) are held against
these in tests/test_torch_kernels.py, and the kernels themselves on the card
in chip_smoke.py, for every policy that accumulates in float32 (fp16_strict
rounds in an order of its own, which only the plain versions follow).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.distances import fp32_is_ieee
from repro_torch.core.precision import FP32, PrecisionPolicy


def _pair_sqdist(V, S, policy: PrecisionPolicy):
    fp32_is_ieee()
    acc = policy.accum_dtype
    Vc = V.to(policy.compute_dtype).to(acc)
    Sc = S.to(policy.compute_dtype).to(acc)
    g = Vc @ Sc.T
    vn = torch.sum(Vc ** 2, -1)
    sn = torch.sum(Sc ** 2, -1)
    return torch.clamp_min(vn[:, None] + sn[None, :] - 2.0 * g, 0.0)


def _maybe_rbf(D, rbf_gamma):
    if rbf_gamma is None:
        return D
    return 2.0 * (1.0 - torch.exp(-rbf_gamma * D))


def _min_dists(V, S, lengths, d_e0, policy, rbf_gamma):
    n = V.shape[0]
    l, k, d = S.shape
    D = _pair_sqdist(V, S.reshape(l * k, d), policy).reshape(n, l, k)
    D = _maybe_rbf(D, rbf_gamma)
    mask = torch.arange(k, device=D.device)[None, :] < lengths[:, None]
    D = torch.where(mask[None, :, :], D, torch.finfo(D.dtype).max)
    return torch.minimum(torch.amin(D, dim=-1), d_e0[:, None].to(D.dtype))


def exemplar_eval_ref(
    V: torch.Tensor,
    S: torch.Tensor,           # (l, k, d)
    lengths: torch.Tensor,     # (l,)
    d_e0: torch.Tensor,        # (n,) final (possibly transformed) dist to e0
    policy: PrecisionPolicy = FP32,
    rbf_gamma: Optional[float] = None,
) -> torch.Tensor:
    """L(S_j ∪ {e0}) for all j — (l,) float32."""
    dmin = _min_dists(V, S, lengths, d_e0, policy, rbf_gamma)
    return torch.sum(dmin.to(torch.float32), dim=0) / V.shape[0]


def work_matrix_ref(
    V: torch.Tensor, S: torch.Tensor, lengths: torch.Tensor,
    d_e0: torch.Tensor, policy: PrecisionPolicy = FP32,
    rbf_gamma: Optional[float] = None,
) -> torch.Tensor:
    """The paper's W — (l, n): min-dist(v_i, S_j ∪ {e0}) / n."""
    dmin = _min_dists(V, S, lengths, d_e0, policy, rbf_gamma)
    return (dmin.T / V.shape[0]).to(torch.float32)


def marginal_gain_ref(
    V: torch.Tensor,
    C: torch.Tensor,           # (m, d) candidates
    mincache: torch.Tensor,    # (n,)
    policy: PrecisionPolicy = FP32,
    rbf_gamma: Optional[float] = None,
    fold: str = "min",
    affine: Optional[tuple] = None,
) -> torch.Tensor:
    """Δ(c_j | S) = |V|⁻¹ Σ_i relu(m_i − d(v_i, c_j)) — (m,) float32; with
    ``fold="max"``, |V|⁻¹ Σ_i relu((α + β·d(v_i, c_j)) − c_i)."""
    D = _maybe_rbf(_pair_sqdist(V, C, policy), rbf_gamma)
    if fold == "min":
        g = torch.clamp_min(mincache[:, None].to(D.dtype) - D, 0.0)
    else:
        a, b = affine
        g = torch.clamp_min(a + b * D - mincache[:, None].to(D.dtype), 0.0)
    return torch.sum(g.to(torch.float32), dim=0) / V.shape[0]


def fold_winner_ref(
    V: torch.Tensor,
    w: torch.Tensor,           # (d,) the winner
    cache: torch.Tensor,       # (n,)
    policy: PrecisionPolicy = FP32,
    rbf_gamma: Optional[float] = None,
    fold: str = "min",
    affine: Optional[tuple] = None,
) -> torch.Tensor:
    """The cache after the winner joins S — (n,) float32: min(m_i, d_iw),
    or with ``fold="max"`` max(c_i, relu(α + β·d_iw))."""
    dw = _maybe_rbf(_pair_sqdist(V, w[None, :], policy), rbf_gamma)[:, 0]
    dw = dw.to(torch.float32)
    if fold == "min":
        return torch.minimum(cache, dw)
    a, b = affine
    return torch.maximum(cache, torch.clamp_min(a + b * dw, 0.0))
