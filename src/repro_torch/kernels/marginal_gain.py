"""Optimizer-aware greedy marginal gains: CUDA kernels and plain versions.

Replaces the Pallas TPU kernels ``gain_eval`` (``_gain_kernel``) and
``gain_update_eval`` (``_gain_update_kernel``) of
``repro/kernels/marginal_gain.py``. The kernels live in
``csrc/marginal_gain.cu``; see the note there for what bounds them on Hopper
(the fp32 FMA rate: a dense round is an n × m Gram product) and what the
design does about it.

ONE template serves the function zoo, parameterized by the fold direction
and an in-tile affine of the distance:

* ``fold="min"`` — the exemplar min-distance cache:
  ``Δ(c_j | S) = n_total⁻¹ Σ_i relu(m_i − d(v_i, c_j))``
* ``fold="max"`` + ``affine=(α, β)`` — the max-similarity dual:
  ``Δ(c_j | S) = n_total⁻¹ Σ_i relu((α + β·d(v_i, c_j)) − c_i)``

:func:`gain_update_eval` first folds the previous winner ``w`` into the cache
(min: ``m_i ← min(m_i, d_iw)``; max: ``c_i ← max(c_i, relu(α + β·d_iw))``),
gated by a device-resident ``w_valid`` so the engine's round loop never waits
on the host, writes the folded cache into a buffer distinct from its input,
and scores the candidates against it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import _build
from repro_torch.kernels.exemplar_eval import PLAIN_BLOCK_ELEMS, dist_plain


def _score_plain(cache, D, n_total, fold, affine):
    """(m,) gains of distance columns ``D`` (n, m) against the cache: the
    min relu runs in the distance dtype, the max affine in the distance
    dtype and its subtraction in float32; the sum is float32."""
    if fold == "min":
        g = torch.clamp_min(cache[:, None].to(D.dtype) - D, 0.0)
    else:  # α and β round to the distance dtype, as the kernels' affine
        a, b = (torch.tensor(x, dtype=D.dtype, device=D.device)
                for x in affine)
        g = torch.clamp_min((a + b * D).to(torch.float32)
                            - cache[:, None].to(torch.float32), 0.0)
    return torch.sum(g.to(torch.float32), dim=0) / n_total


def _fold_plain(cache, dw, fold, affine):
    """Fold one winner's distance column into the float32 cache."""
    if fold == "min":
        return torch.minimum(cache, dw.to(torch.float32))
    a, b = affine
    return torch.maximum(cache,
                         torch.clamp_min(a + b * dw.to(torch.float32), 0.0))


def gain_eval_plain(V, C, cache, *, n_total: int, policy: PrecisionPolicy,
                    rbf_gamma: Optional[float] = None, fold: str = "min",
                    affine: Optional[tuple] = None) -> torch.Tensor:
    """Plain version of :func:`gain_eval` — (m,) float32."""
    n, m = V.shape[0], C.shape[0]
    step = max(1, PLAIN_BLOCK_ELEMS // max(1, n))
    out = torch.empty(m, dtype=torch.float32, device=V.device)
    for s in range(0, m, step):
        D = dist_plain(V, C[s:s + step], policy, rbf_gamma)
        out[s:s + step] = _score_plain(cache, D, n_total, fold, affine)
    return out


def gain_update_eval_plain(V, C, cache, winner, w_valid, *, n_total: int,
                           policy: PrecisionPolicy,
                           rbf_gamma: Optional[float] = None,
                           fold: str = "min", affine: Optional[tuple] = None):
    """Plain version of :func:`gain_update_eval` — (gains, new_cache)."""
    dw = dist_plain(V, winner[None, :], policy, rbf_gamma, lanes=True)[:, 0]
    new_cache = torch.where(w_valid.reshape(()) > 0,
                            _fold_plain(cache, dw, fold, affine), cache)
    gains = gain_eval_plain(V, C, new_cache, n_total=n_total, policy=policy,
                            rbf_gamma=rbf_gamma, fold=fold, affine=affine)
    return gains, new_cache


def _check_gain_operands(V, C, cache, policy, fold, affine):
    dev = V.device
    for name, t in (("C", C), ("cache", cache)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, V on {dev}")
    if V.ndim != 2 or C.ndim != 2 or C.shape[1] != V.shape[1]:
        raise ValueError(f"V (n, d) and C (m, d) expected, got {tuple(V.shape)}"
                         f" and {tuple(C.shape)}")
    if not (V.is_contiguous() and C.is_contiguous() and cache.is_contiguous()):
        raise ValueError("V, C and cache must be contiguous")
    if C.dtype != V.dtype:
        raise ValueError(f"C dtype {C.dtype} differs from V dtype {V.dtype}")
    if cache.dtype != torch.float32 or cache.shape != (V.shape[0],):
        raise ValueError("cache must be an (n,) float32 tensor")
    if fold not in ("min", "max"):
        raise ValueError(f"fold must be 'min' or 'max', got {fold!r}")
    if fold == "max" and affine is None:
        raise ValueError("fold='max' needs the score affine (alpha, beta)")
    a, b = affine if affine is not None else (0.0, 0.0)
    return (_build.operand_code(V.dtype, policy), int(fold == "max"),
            float(a), float(b))


def gain_eval(
    V: torch.Tensor,          # (n, d) float32 or the policy's compute dtype
    C: torch.Tensor,          # (m, d) V's dtype
    cache: torch.Tensor,      # (n,) float32 (transformed if rbf)
    *,
    n_total: int,
    policy: PrecisionPolicy,
    rbf_gamma: Optional[float] = None,
    fold: str = "min",
    affine: Optional[tuple] = None,
) -> torch.Tensor:
    """Marginal gains of every candidate against a fixed cache — (m,)."""
    if not V.is_cuda:
        return gain_eval_plain(V, C, cache, n_total=n_total, policy=policy,
                               rbf_gamma=rbf_gamma, fold=fold, affine=affine)
    code, fmax, a, b = _check_gain_operands(V, C, cache, policy, fold, affine)
    n, d = V.shape
    m = C.shape[0]
    gains = torch.empty(m, dtype=torch.float32, device=V.device)
    if m == 0:
        return gains
    _build.launch(
        "gain_eval", "marginal_gain", "repro_gain_eval", V.data_ptr(),
        C.data_ptr(), cache.data_ptr(), gains.data_ptr(), n, m, d,
        float(n_total), -1.0 if rbf_gamma is None else float(rbf_gamma),
        fmax, a, b, _build.POLICY_CODES[policy.name], code,
        _build.stream_ptr(V.device))
    return gains


def gain_update_eval(
    V: torch.Tensor,          # (n, d)
    C: torch.Tensor,          # (m, d)
    cache: torch.Tensor,      # (n,) float32 — cache *before* the winner
    winner: torch.Tensor,     # (d,) previous round's winning candidate
    w_valid: torch.Tensor,    # one float32 on the device — 0 disables the fold
    *,
    n_total: int,
    policy: PrecisionPolicy,
    rbf_gamma: Optional[float] = None,
    fold: str = "min",
    affine: Optional[tuple] = None,
    cache_out: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused greedy step: fold ``winner`` into the cache, score all
    candidates. Returns ``(gains (m,), new_cache (n,))``, both float32; the
    new cache goes to ``cache_out`` when given (it must not be ``cache``)."""
    if not V.is_cuda:
        gains, new_cache = gain_update_eval_plain(
            V, C, cache, winner, w_valid, n_total=n_total, policy=policy,
            rbf_gamma=rbf_gamma, fold=fold, affine=affine)
        if cache_out is None:
            return gains, new_cache
        return gains, cache_out.copy_(new_cache)
    code, fmax, a, b = _check_gain_operands(V, C, cache, policy, fold, affine)
    n, d = V.shape
    m = C.shape[0]
    if winner.shape != (d,) or winner.dtype != V.dtype or winner.device != V.device \
            or not winner.is_contiguous():
        raise ValueError("winner must be a contiguous (d,) tensor of V's dtype "
                         "and device")
    if w_valid.numel() != 1 or w_valid.dtype != torch.float32 \
            or w_valid.device != V.device:
        raise ValueError("w_valid must be one float32 on V's device")
    if cache_out is None:
        cache_out = torch.empty_like(cache)
    elif cache_out.data_ptr() == cache.data_ptr() or cache_out.shape != cache.shape \
            or cache_out.dtype != torch.float32 or not cache_out.is_contiguous():
        raise ValueError("cache_out must be a distinct contiguous (n,) float32 "
                         "buffer")
    gains = torch.empty(m, dtype=torch.float32, device=V.device)
    _build.launch(
        "gain_update_eval", "marginal_gain", "repro_gain_update_eval",
        V.data_ptr(), C.data_ptr(), cache.data_ptr(), winner.data_ptr(),
        w_valid.data_ptr(), gains.data_ptr(), cache_out.data_ptr(), n, m, d,
        float(n_total), -1.0 if rbf_gamma is None else float(rbf_gamma),
        fmax, a, b, _build.POLICY_CODES[policy.name], code,
        _build.stream_ptr(V.device))
    return gains, cache_out
