"""Optimizer-aware greedy marginal gains: CUDA kernels and plain versions.

Replaces the Pallas TPU kernels ``gain_eval`` (``_gain_kernel``) and
``gain_update_eval`` (``_gain_update_kernel``) of
``repro/kernels/marginal_gain.py``. The kernels live in
``csrc/marginal_gain.cu``; see the note there for what bounds them on Hopper
(the fp32 FMA rate: a dense round is an n × m Gram product) and what the
design does about it: a fixed split of n into SEG-row segments (one per
block, so CELF's 256-candidate re-score still fills the card), 128 (or,
at wide d, 32) candidates staged per block, an 8 × 8 (or 8 × 2) register
tile fed by 128-bit shared loads, V prefetched through registers into a
double buffer. Each block writes per-segment partial sums into a workspace
the wrapper allocates; a second pass in the same C call adds them in
segment order and divides by ``n_total``, so a candidate's gain is the same
bits at every m, in every batch. That is the SIMT tile of fp32 and
fp16_strict; at bf16 and fp16 the Gram products run on the tensor cores
(``csrc/tc_tile.cuh``: a row pass for the norms and the winner's fold, then
``wgmma`` over 256 candidates a block), with the same segments and the same
C entries.

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

:func:`gain_eval_batched` and :func:`gain_update_eval_batched` replace the
grid-over-B Pallas kernels (``_gain_kernel_batched``,
``_gain_update_kernel_batched``): B independent requests in one launch of
the same kernel body, one request per ``blockIdx.z``, each with its own
winner and ``w_valid`` gate. A request's outputs are bit for bit those of
its own unbatched launch (the multi-tenant engine's batched == unbatched
contract rests on it).

:func:`sieve_gain_eval` and :func:`sieve_gain_eval_batched` replace the
streaming engine's Pallas kernels (``_sieve_gain_kernel``,
``_sieve_gain_kernel_batched``): the same min/max template, scored for
every row of a sieve-cache table against one stream element's distance row
(no Gram product: the distances come in precomputed). They live in
``csrc/sieve_gain.cu``, whose note says what bounds them (device memory)
and what the design does about it: each row is a thread-block cluster of
8 blocks over a fixed split of n (:func:`sieve_span`), whose partials
block rank 0 adds in rank order through distributed shared memory, so a
row's gain is the same bits in every launch. The function's seed row comes
in through its own pointer (``seed=``) and scores as row 0.
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


def gain_eval_batched_plain(V, C, cache, *, n_total: int,
                            policy: PrecisionPolicy,
                            rbf_gamma: Optional[float] = None,
                            fold: str = "min",
                            affine: Optional[tuple] = None) -> torch.Tensor:
    """Plain version of :func:`gain_eval_batched` — (B, m) float32: each
    request's row is its own :func:`gain_eval_plain` call."""
    kw = dict(n_total=n_total, policy=policy, rbf_gamma=rbf_gamma, fold=fold,
              affine=affine)
    out = torch.empty(C.shape[:2], dtype=torch.float32, device=V.device)
    for b in range(V.shape[0]):
        out[b] = gain_eval_plain(V[b], C[b], cache[b], **kw)
    return out


def gain_update_eval_batched_plain(V, C, cache, winner, w_valid, *,
                                   n_total: int, policy: PrecisionPolicy,
                                   rbf_gamma: Optional[float] = None,
                                   fold: str = "min",
                                   affine: Optional[tuple] = None):
    """Plain version of :func:`gain_update_eval_batched` — (gains (B, m),
    new_cache (B, n)): each request's rows are its own
    :func:`gain_update_eval_plain` call with its own winner and gate."""
    kw = dict(n_total=n_total, policy=policy, rbf_gamma=rbf_gamma, fold=fold,
              affine=affine)
    gains = torch.empty(C.shape[:2], dtype=torch.float32, device=V.device)
    new_cache = torch.empty_like(cache, dtype=torch.float32)
    for b in range(V.shape[0]):
        gains[b], new_cache[b] = gain_update_eval_plain(
            V[b], C[b], cache[b], winner[b], w_valid[b], **kw)
    return gains, new_cache


def _check_gain_operands(V, C, cache, policy, fold, affine, batched=False):
    dev = V.device
    for name, t in (("C", C), ("cache", cache)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, V on {dev}")
    lead = V.shape[:1] if batched else ()
    nd = 3 if batched else 2
    if V.ndim != nd or C.ndim != nd or C.shape[-1] != V.shape[-1] \
            or C.shape[:-2] != lead:
        want = "V (B, n, d) and C (B, m, d)" if batched \
            else "V (n, d) and C (m, d)"
        raise ValueError(f"{want} expected, got {tuple(V.shape)} and "
                         f"{tuple(C.shape)}")
    if not (V.is_contiguous() and C.is_contiguous() and cache.is_contiguous()):
        raise ValueError("V, C and cache must be contiguous")
    if C.dtype != V.dtype:
        raise ValueError(f"C dtype {C.dtype} differs from V dtype {V.dtype}")
    if cache.dtype != torch.float32 or cache.shape != V.shape[:-1]:
        raise ValueError(f"cache must be a {tuple(V.shape[:-1])} float32 "
                         f"tensor")
    if fold not in ("min", "max"):
        raise ValueError(f"fold must be 'min' or 'max', got {fold!r}")
    if fold == "max" and affine is None:
        raise ValueError("fold='max' needs the score affine (alpha, beta)")
    a, b = affine if affine is not None else (0.0, 0.0)
    return (_build.operand_code(V.dtype, policy), int(fold == "max"),
            float(a), float(b))


def _partials(B: int, n: int, m: int, d: int, policy, device) -> torch.Tensor:
    """The gain kernels' workspace, from PyTorch's caching allocator: the
    (B, n_segs, m) per-segment partial sums, then the tensor-core kernels'
    row pass (``_build.workspace_floats``)."""
    return torch.empty(_build.workspace_floats(B * _build.n_segments(n) * m,
                                               B, n, d,
                                               _build.tensor_cores(policy)),
                       dtype=torch.float32, device=device)


@_build.kernel_call("gain_eval")
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
    part = _partials(1, n, m, d, policy, V.device)
    _build.launch(
        "gain_eval", "marginal_gain", "repro_gain_eval", V.data_ptr(),
        C.data_ptr(), cache.data_ptr(), part.data_ptr(), gains.data_ptr(), n,
        m, d,
        float(n_total), -1.0 if rbf_gamma is None else float(rbf_gamma),
        fmax, a, b, _build.POLICY_CODES[policy.name], code,
        _build.stream_ptr(V.device))
    return gains


@_build.kernel_call("gain_update_eval")
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
    cache_out = _check_winner(V, winner, w_valid, cache, cache_out)
    n, d = V.shape
    m = C.shape[0]
    gains = torch.empty(m, dtype=torch.float32, device=V.device)
    part = _partials(1, n, m, d, policy, V.device)
    _build.launch(
        "gain_update_eval", "marginal_gain", "repro_gain_update_eval",
        V.data_ptr(), C.data_ptr(), cache.data_ptr(), winner.data_ptr(),
        w_valid.data_ptr(), part.data_ptr(), gains.data_ptr(),
        cache_out.data_ptr(), n, m, d,
        float(n_total), -1.0 if rbf_gamma is None else float(rbf_gamma),
        fmax, a, b, _build.POLICY_CODES[policy.name], code,
        _build.stream_ptr(V.device))
    return gains, cache_out


def _check_winner(V, winner, w_valid, cache, cache_out):
    """Winner rows (…, d), gates (…,) and the new-cache buffer of a fused
    launch, with … = () unbatched and (B,) batched."""
    lead, d = V.shape[:-2], V.shape[-1]
    if winner.shape != (*lead, d) or winner.dtype != V.dtype \
            or winner.device != V.device or not winner.is_contiguous():
        raise ValueError(f"winner must be a contiguous {(*lead, d)} tensor of "
                         f"V's dtype and device")
    if w_valid.numel() != max(1, lead.numel()) \
            or w_valid.dtype != torch.float32 or w_valid.device != V.device \
            or not w_valid.is_contiguous():
        raise ValueError(f"w_valid must be {lead.numel() or 1} contiguous "
                         f"float32 on V's device")
    if cache_out is None:
        return torch.empty_like(cache)
    if cache_out.data_ptr() == cache.data_ptr() or cache_out.shape != cache.shape \
            or cache_out.dtype != torch.float32 or not cache_out.is_contiguous():
        raise ValueError("cache_out must be a distinct contiguous float32 "
                         "buffer of the cache's shape")
    return cache_out


@_build.kernel_call("gain_eval_batched")
def gain_eval_batched(
    V: torch.Tensor,          # (B, n, d) float32 or the policy's compute dtype
    C: torch.Tensor,          # (B, m, d) V's dtype
    cache: torch.Tensor,      # (B, n) float32
    *,
    n_total: int,
    policy: PrecisionPolicy,
    rbf_gamma: Optional[float] = None,
    fold: str = "min",
    affine: Optional[tuple] = None,
) -> torch.Tensor:
    """:func:`gain_eval` for B independent requests in one launch — (B, m)."""
    if not V.is_cuda:
        return gain_eval_batched_plain(V, C, cache, n_total=n_total,
                                       policy=policy, rbf_gamma=rbf_gamma,
                                       fold=fold, affine=affine)
    code, fmax, a, b = _check_gain_operands(V, C, cache, policy, fold, affine,
                                            batched=True)
    B, n, d = V.shape
    m = C.shape[1]
    gains = torch.empty((B, m), dtype=torch.float32, device=V.device)
    if m == 0 or B == 0:
        return gains
    part = _partials(B, n, m, d, policy, V.device)
    _build.launch(
        "gain_eval_batched", "marginal_gain", "repro_gain_eval_batched",
        V.data_ptr(), C.data_ptr(), cache.data_ptr(), part.data_ptr(),
        gains.data_ptr(), B, n, m, d, float(n_total), -1.0 if rbf_gamma is None else float(rbf_gamma),
        fmax, a, b, _build.POLICY_CODES[policy.name], code,
        _build.stream_ptr(V.device))
    return gains


@_build.kernel_call("gain_update_eval_batched")
def gain_update_eval_batched(
    V: torch.Tensor,          # (B, n, d)
    C: torch.Tensor,          # (B, m, d)
    cache: torch.Tensor,      # (B, n) float32 — caches *before* the winners
    winner: torch.Tensor,     # (B, d) each request's previous winner
    w_valid: torch.Tensor,    # (B,) float32 on the device — 0 disables a fold
    *,
    n_total: int,
    policy: PrecisionPolicy,
    rbf_gamma: Optional[float] = None,
    fold: str = "min",
    affine: Optional[tuple] = None,
    cache_out: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`gain_update_eval` for B independent requests in one launch.
    Returns ``(gains (B, m), new_cache (B, n))``; the new caches go to
    ``cache_out`` when given (it must not be ``cache``)."""
    if not V.is_cuda:
        gains, new_cache = gain_update_eval_batched_plain(
            V, C, cache, winner, w_valid, n_total=n_total, policy=policy,
            rbf_gamma=rbf_gamma, fold=fold, affine=affine)
        if cache_out is None:
            return gains, new_cache
        return gains, cache_out.copy_(new_cache)
    code, fmax, a, b = _check_gain_operands(V, C, cache, policy, fold, affine,
                                            batched=True)
    cache_out = _check_winner(V, winner, w_valid, cache, cache_out)
    B, n, d = V.shape
    m = C.shape[1]
    gains = torch.empty((B, m), dtype=torch.float32, device=V.device)
    if B == 0:
        return gains, cache_out
    part = _partials(B, n, m, d, policy, V.device)
    # m = 0 still launches one candidate tile per request: it folds
    _build.launch(
        "gain_update_eval_batched", "marginal_gain",
        "repro_gain_update_eval_batched", V.data_ptr(), C.data_ptr(),
        cache.data_ptr(), winner.data_ptr(), w_valid.data_ptr(),
        part.data_ptr(), gains.data_ptr(), cache_out.data_ptr(), B, n, m, d,
        float(n_total),
        -1.0 if rbf_gamma is None else float(rbf_gamma), fmax, a, b,
        _build.POLICY_CODES[policy.name], code, _build.stream_ptr(V.device))
    return gains, cache_out


# ---------------------------------------------------------------------------
# sieve_gain — the streaming engine's table × element scoring
# ---------------------------------------------------------------------------


#: csrc/sieve_gain.cu: each row is one thread-block cluster of
#: ``SIEVE_CLUSTER`` blocks along n; a block's span is a whole number of
#: steps of ``SIEVE_STEP`` columns (256 threads × 4 columns), and a block
#: loads ``SIEVE_GROUP`` columns of it at once (4 steps).
SIEVE_CLUSTER = 8
SIEVE_STEP = 1024
SIEVE_GROUP = 4 * SIEVE_STEP


def sieve_span(n: int) -> int:
    """Columns of n one block of a row's cluster takes — csrc/sieve_gain.cu
    ``sieve_span``: ceil(n / 8) rounded up to a whole step, a function of n
    alone. Block c takes ``[c·span, (c + 1)·span) ∩ [0, n)``."""
    per = -(-n // SIEVE_CLUSTER)
    return -(-per // SIEVE_STEP) * SIEVE_STEP


def _with_seed(T, seed):
    """The table with the seed row in front of every partition's rows."""
    if seed is None:
        return T
    return torch.cat([seed.expand(*T.shape[:-2], 1, T.shape[-1]), T], dim=-2)


def sieve_gain_eval_plain(T, dvec, *, n_total: int, fold: str = "min",
                          affine: Optional[tuple] = None,
                          seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`sieve_gain_eval` — (r,) float32, or
    (r + 1,) with ``seed``: the gains of the table with the seed row in
    front. The affine rounds as the kernel's does: a product, then a
    sum."""
    T = _with_seed(T, seed)
    if fold == "min":
        g = torch.clamp_min(T - dvec[None, :], 0.0)
    else:
        a, b = affine
        g = torch.clamp_min((a + b * dvec)[None, :] - T, 0.0)
    return torch.sum(g, dim=1) / n_total


def sieve_gain_eval_batched_plain(T, dvec, *, n_total: int, fold: str = "min",
                                  affine: Optional[tuple] = None,
                                  seed: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Plain version of :func:`sieve_gain_eval_batched` — (P, r) float32,
    or (P, r + 1) with ``seed`` in front of every partition's rows: each
    partition's row is its own :func:`sieve_gain_eval_plain` call."""
    T = _with_seed(T, seed)
    out = torch.empty(T.shape[:2], dtype=torch.float32, device=T.device)
    for p in range(T.shape[0]):
        out[p] = sieve_gain_eval_plain(T[p], dvec[p], n_total=n_total,
                                       fold=fold, affine=affine)
    return out


def _check_sieve_operands(T, dvec, fold, affine, batched, seed=None):
    nd = 3 if batched else 2
    if T.ndim != nd or dvec.shape != (*T.shape[:-2], T.shape[-1]):
        want = "T (P, r, n) and dvec (P, n)" if batched \
            else "T (r, n) and dvec (n,)"
        raise ValueError(f"{want} expected, got {tuple(T.shape)} and "
                         f"{tuple(dvec.shape)}")
    if dvec.device != T.device:
        raise ValueError(f"dvec is on {dvec.device}, T on {T.device}")
    if T.dtype != torch.float32 or dvec.dtype != torch.float32:
        raise ValueError("T and dvec must be float32")
    if not (T.is_contiguous() and dvec.is_contiguous()):
        raise ValueError("T and dvec must be contiguous")
    if seed is not None:
        if seed.shape != T.shape[-1:]:
            raise ValueError(f"seed must be one ({T.shape[-1]},) row, got "
                             f"{tuple(seed.shape)}")
        if seed.dtype != torch.float32 or not seed.is_contiguous():
            raise ValueError("seed must be a contiguous float32 row")
        if seed.device != T.device:
            raise ValueError(f"seed is on {seed.device}, T on {T.device}")
    if fold not in ("min", "max"):
        raise ValueError(f"fold must be 'min' or 'max', got {fold!r}")
    if fold == "max" and affine is None:
        raise ValueError("fold='max' needs the score affine (alpha, beta)")
    a, b = affine if affine is not None else (0.0, 0.0)
    return int(fold == "max"), float(a), float(b)


@_build.kernel_call("sieve_gain_eval")
def sieve_gain_eval(
    T: torch.Tensor,          # (r, n) float32 cache-table rows
    dvec: torch.Tensor,       # (n,) float32 distance row of one element
    *,
    n_total: int,
    fold: str = "min",
    affine: Optional[tuple] = None,
    seed: Optional[torch.Tensor] = None,   # (n,) float32, scored as row 0
) -> torch.Tensor:
    """Per-row gains of a cache table against one stream element — (r,),
    or (r + 1,) with ``seed``, whose gain (the singleton gain Δ(e | ∅))
    comes first: the gains of the table with the seed row in front, read
    through the seed's own pointer with no copy of the table.

    Rows are arbitrary caches (live sieves, stale slots, or the seed);
    callers mask rows downstream. The kernel masks the ragged n edge
    itself: no padding columns.
    """
    if not T.is_cuda:
        return sieve_gain_eval_plain(T, dvec, n_total=n_total, fold=fold,
                                     affine=affine, seed=seed)
    fmax, a, b = _check_sieve_operands(T, dvec, fold, affine, batched=False,
                                       seed=seed)
    r, n = T.shape
    rows = r + (seed is not None)
    out = torch.empty(rows, dtype=torch.float32, device=T.device)
    if rows == 0:
        return out
    _build.launch(
        "sieve_gain_eval", "sieve_gain", "repro_sieve_gain_eval", T.data_ptr(),
        None if seed is None else seed.data_ptr(), dvec.data_ptr(),
        out.data_ptr(), r, n, float(n_total), fmax, a, b,
        _build.stream_ptr(T.device))
    return out


@_build.kernel_call("sieve_gain_eval_batched")
def sieve_gain_eval_batched(
    T: torch.Tensor,          # (P, r, n) float32 per-partition tables
    dvec: torch.Tensor,       # (P, n) float32 per-partition element rows
    *,
    n_total: int,
    fold: str = "min",
    affine: Optional[tuple] = None,
    seed: Optional[torch.Tensor] = None,   # (n,) float32, shared by all P
) -> torch.Tensor:
    """:func:`sieve_gain_eval` for P stream partitions in one launch —
    (P, r), or (P, r + 1) with one ``seed`` row scored first in every
    partition; each partition's row is bit for bit its own unbatched
    launch."""
    if not T.is_cuda:
        return sieve_gain_eval_batched_plain(T, dvec, n_total=n_total,
                                             fold=fold, affine=affine,
                                             seed=seed)
    fmax, a, b = _check_sieve_operands(T, dvec, fold, affine, batched=True,
                                       seed=seed)
    P, r, n = T.shape
    rows = r + (seed is not None)
    out = torch.empty((P, rows), dtype=torch.float32, device=T.device)
    if P == 0 or rows == 0:
        return out
    _build.launch(
        "sieve_gain_eval_batched", "sieve_gain",
        "repro_sieve_gain_eval_batched", T.data_ptr(),
        None if seed is None else seed.data_ptr(), dvec.data_ptr(),
        out.data_ptr(), P, r, n, float(n_total), fmax, a, b,
        _build.stream_ptr(T.device))
    return out
