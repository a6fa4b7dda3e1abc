"""Dissimilarity functions for exemplar-based clustering.

Exemplar clustering only requires non-negativity of ``d`` (paper §IV), not the
triangle inequality. All functions here are exposed in two forms:

* ``pairwise(X, Y) -> (n, m)`` — the full cross matrix, used by the
  work-matrix evaluator. Inner-product-expressible distances (squared
  Euclidean, cosine, RBF) route the heavy term through one matrix product.
* ``point(x, y) -> scalar`` — the direct definition, used by oracles/tests.

Gram-based distances clamp at zero: the expansion ``‖x‖²+‖y‖²−2⟨x,y⟩`` can go
slightly negative in floating point.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.precision import FP32, PrecisionPolicy

#: Rows widened at a time when a half payload meets a float32 accumulator.
WIDEN_BLOCK_ROWS = 8192


def fp32_is_ieee() -> None:
    """The fp32 policy must be real fp32: TF32 keeps ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dot(X: torch.Tensor, Y: torch.Tensor, accum_dtype) -> torch.Tensor:
    """(n,d)·(m,d)ᵀ accumulated (and returned) in ``accum_dtype``.

    A half payload meeting a float32 accumulator is widened one row block at
    a time: the product of two half values is exact in float32, so this is
    float32 accumulation of the half products, and no payload-sized float32
    copy of either operand ever exists.
    """
    fp32_is_ieee()
    if X.dtype == accum_dtype:
        return X @ Y.T
    out = torch.empty((X.shape[0], Y.shape[0]), dtype=accum_dtype,
                      device=X.device)
    B = WIDEN_BLOCK_ROWS
    for ys in range(0, Y.shape[0], B):
        Yb = Y[ys:ys + B].to(accum_dtype)
        for xs in range(0, X.shape[0], B):
            out[xs:xs + B, ys:ys + B] = X[xs:xs + B].to(accum_dtype) @ Yb.T
    return out


def sq_norms(X: torch.Tensor, accum_dtype=torch.float32) -> torch.Tensor:
    """Row-wise ‖x‖² with explicit accumulation dtype.

    A half payload must NOT be up-cast wholesale (that materializes a
    payload-sized fp32 copy — the exact traffic the compute/accum split
    avoids): only one row block at a time is widened, so just the
    accumulator is wide.
    """
    if X.dtype == accum_dtype:
        return torch.sum(X * X, dim=-1)
    flat = X.reshape(-1, X.shape[-1])
    parts = [torch.sum(blk.to(accum_dtype) ** 2, dim=-1)
             for blk in torch.split(flat, WIDEN_BLOCK_ROWS)]
    return torch.cat(parts).reshape(X.shape[:-1])


def sqeuclidean_pairwise(
    X: torch.Tensor, Y: torch.Tensor, policy: PrecisionPolicy = FP32
) -> torch.Tensor:
    """‖x−y‖² for all pairs via the Gram expansion (one matrix product)."""
    Xc = X.to(policy.compute_dtype)
    Yc = Y.to(policy.compute_dtype)
    g = _dot(Xc, Yc, policy.accum_dtype)
    xn = sq_norms(Xc, policy.accum_dtype)
    yn = sq_norms(Yc, policy.accum_dtype)
    d2 = xn[:, None] + yn[None, :] - 2.0 * g
    return torch.clamp_min(d2, 0.0)


def sqeuclidean_point(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    diff = x.to(torch.float32) - y.to(torch.float32)
    return torch.sum(diff * diff)


def manhattan_pairwise(
    X: torch.Tensor, Y: torch.Tensor, policy: PrecisionPolicy = FP32
) -> torch.Tensor:
    """Σ|x−y| — not inner-product-expressible; direct broadcast."""
    Xc = X.to(policy.accum_dtype)
    Yc = Y.to(policy.accum_dtype)
    return torch.sum(torch.abs(Xc[:, None, :] - Yc[None, :, :]), dim=-1)


def manhattan_point(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x.to(torch.float32) - y.to(torch.float32)))


def cosine_pairwise(
    X: torch.Tensor, Y: torch.Tensor, policy: PrecisionPolicy = FP32
) -> torch.Tensor:
    """1 − cos(x, y) ∈ [0, 2]; Gram-based. Zero vectors map to dissimilarity 1."""
    Xc = X.to(policy.compute_dtype)
    Yc = Y.to(policy.compute_dtype)
    g = _dot(Xc, Yc, policy.accum_dtype)
    xn = torch.sqrt(sq_norms(Xc, policy.accum_dtype))
    yn = torch.sqrt(sq_norms(Yc, policy.accum_dtype))
    denom = torch.clamp_min(xn[:, None] * yn[None, :], 1e-30)
    return torch.clamp_min(1.0 - g / denom, 0.0)


def cosine_point(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    denom = torch.clamp_min(torch.linalg.norm(x) * torch.linalg.norm(y), 1e-30)
    return torch.clamp_min(1.0 - torch.dot(x, y) / denom, 0.0)


#: Default RBF bandwidth — the single source of truth shared by the torch
#: pairwise form and the CUDA kernel paths (host/device parity depends on
#: both sides using the same gamma).
RBF_GAMMA = 1.0


def rbf_pairwise(
    X: torch.Tensor, Y: torch.Tensor, policy: PrecisionPolicy = FP32,
    gamma: float = RBF_GAMMA,
) -> torch.Tensor:
    """Kernel-induced dissimilarity d(x,y) = 2·(1 − exp(−γ‖x−y‖²)) ≥ 0."""
    d2 = sqeuclidean_pairwise(X, Y, policy)
    return 2.0 * (1.0 - torch.exp(-gamma * d2))


def rbf_point(x: torch.Tensor, y: torch.Tensor,
              gamma: float = RBF_GAMMA) -> torch.Tensor:
    return 2.0 * (1.0 - torch.exp(-gamma * sqeuclidean_point(x, y)))


PAIRWISE: dict[str, Callable] = {
    "sqeuclidean": sqeuclidean_pairwise,
    "manhattan": manhattan_pairwise,
    "cosine": cosine_pairwise,
    "rbf": rbf_pairwise,
}

POINT: dict[str, Callable] = {
    "sqeuclidean": sqeuclidean_point,
    "manhattan": manhattan_point,
    "cosine": cosine_point,
    "rbf": rbf_point,
}

#: Distances whose pairwise form routes the dominant term through a matrix
#: product and therefore through the CUDA kernels (kernels assume sqeuclidean,
#: optionally followed by the rbf transform).
MXU_ELIGIBLE = frozenset({"sqeuclidean", "rbf"})


def resolve_pairwise(name: str) -> Callable:
    try:
        return PAIRWISE[name]
    except KeyError as e:
        raise ValueError(f"unknown distance {name!r}; options {sorted(PAIRWISE)}") from e
