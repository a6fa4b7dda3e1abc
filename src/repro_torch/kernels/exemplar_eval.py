"""Multiset exemplar-clustering evaluation: CUDA kernels and plain versions.

Replaces the Pallas TPU kernels of ``repro/kernels/exemplar_eval.py``
(``fused_eval`` with its ``_fused_flat_kernel`` / ``_fused_loop_kernel``
bodies, and ``two_pass_eval``). The kernels live in ``csrc/exemplar_eval.cu``;
see the note there for what bounds them on Hopper (the fp32 FMA rate: they
are Gram products, compute-bound by far) and how the design keeps the FMA
pipes fed: a fixed split of n into SEG-row segments, one per block, so the
grid fills the card; each block's 32 sets staged once, feature-major;
V streamed past them in double-buffered chunks prefetched through
registers; an 8-row × 2-set × 2-slot register tile fed by 128-bit shared
loads. ``fused_eval`` sums each set over its segment and a second pass
adds the per-segment partials in segment order (no atomics), so a set's
value depends on n and its own inputs only, not on l. That is the SIMT
tile of fp32 and fp16_strict; at bf16 and fp16 the Gram products run on
the tensor cores (``csrc/tc_tile.cuh``: a row pass for the norms, then
``wgmma`` over 32 sets' k slots a block), with the same segments.

Two layouts of S, one kernel: ``layout="flat"`` is the k-major ``(k, l, d)``
buffer (the analogue of the paper's round-robin interleave), ``"loop"`` the
``(l, k, d)`` buffer; the kernel reads either through strides.

Each wrapper runs the kernel for CUDA tensors and the plain PyTorch version
for CPU tensors; the plain version is also the kernel's oracle on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.distances import sqeuclidean_pairwise
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import _build

#: Plain versions bound their (n, ·, k) distance block to this many elements.
PLAIN_BLOCK_ELEMS = 1 << 26
#: Lanes that split a row's features in the kernels' row-norm pass (TX and
#: DC of csrc/tile.cuh: each staged 16-feature chunk gives lane t its
#: feature t): lane t sums features t, t+16, ... and an xor butterfly joins
#: the 16 partials.
NORM_LANES = 16


def _rn16(x: torch.Tensor) -> torch.Tensor:
    """Round float64 values to the nearest fp16 value (ties to even, past
    65504 to inf), kept in float64. Applied to an exact a·b + c of fp16
    values it rounds once, as ``__hfma`` does; rounding through float32
    first would round twice."""
    _, e = torch.frexp(x)
    ulp = torch.clamp_min(e.to(torch.int64) - 11, -24)
    scale = ((ulp + 1023) << 52).view(torch.float64)   # 2**ulp, exactly
    r = torch.round(x / scale) * scale
    return torch.where(r.abs() >= 65520.0, x * torch.inf, r)


def _lane_sum16(T: torch.Tensor) -> torch.Tensor:
    """(n,) row sums of exact fp16 products T (n, d) (in float64) taken as
    the kernels' row-norm pass takes them: 16 lane partials by fp16 FMA,
    then the butterfly."""
    n, d = T.shape
    P = torch.zeros((n, NORM_LANES), dtype=torch.float64, device=T.device)
    for q in range(0, d, NORM_LANES):
        t = T[:, q:q + NORM_LANES]
        P[:, :t.shape[1]] = _rn16(P[:, :t.shape[1]] + t)
    h = NORM_LANES // 2
    while h:
        P = _rn16(P[:, :h] + P[:, h:2 * h])
        h //= 2
    return P[:, 0]


def _strict_dist(V, X, rbf_gamma: Optional[float], lanes: bool = False):
    """fp16_strict distances (n, m) float16 in the kernels' own order. fp16
    accumulation depends on the order of its terms, so the plain version
    follows it: row norms by :func:`_lane_sum16`, column norms and the Gram
    product by one fp16 FMA per feature in feature order (``lanes=True``:
    the Gram column of the single winner row X, which the fused update
    kernel accumulates in the row-norm pass), then the fp16 epilogue."""
    h = torch.float16
    Vh = V.to(h).to(torch.float64)
    Xh = X.to(h).to(torch.float64)
    n, d = Vh.shape
    vn = _lane_sum16(Vh * Vh)
    sn = torch.zeros(Xh.shape[0], dtype=torch.float64, device=V.device)
    for f in range(d):
        sn = _rn16(sn + Xh[:, f] * Xh[:, f])
    if lanes:
        G = _lane_sum16(Vh * Xh[0])[:, None]
    else:
        G = torch.zeros((n, Xh.shape[0]), dtype=torch.float64, device=V.device)
        for f in range(d):
            G = _rn16(G + Vh[:, f, None] * Xh[None, :, f])
    d2 = torch.clamp_min((vn.to(h)[:, None] + sn.to(h)[None, :])
                         - 2.0 * G.to(h), 0.0)
    if rbf_gamma is None:
        return d2
    e = torch.exp(torch.tensor(-rbf_gamma, dtype=h, device=V.device) * d2)
    return 2.0 * (1.0 - e)


def dist_plain(V, X, policy: PrecisionPolicy, rbf_gamma: Optional[float],
               lanes: bool = False):
    """(n, m) distances in the accumulation dtype, as the kernels' tile
    epilogue computes them: payload rounded to the compute dtype, Gram
    product accumulated in the accumulation dtype, norms of the rounded
    payload, clamp at 0, then the optional rbf transform. fp16_strict
    follows the kernels' accumulation order (:func:`_strict_dist`)."""
    if policy.name == "fp16_strict":
        return _strict_dist(V, X, rbf_gamma, lanes)
    d2 = sqeuclidean_pairwise(V, X, policy)
    if rbf_gamma is None:
        return d2
    return 2.0 * (1.0 - torch.exp(-rbf_gamma * d2))


def _as_sets(S, layout: str):
    if layout not in ("flat", "loop"):
        raise ValueError(f"unknown layout {layout!r}")
    return S.permute(1, 0, 2) if layout == "flat" else S


def _min_dists_plain(V, S, lengths, d_e0, policy, rbf_gamma):
    """Yields (start, (n, l_c) min-dists) over chunks of the (l, k, d) sets."""
    n = V.shape[0]
    l, k, d = S.shape
    acc = policy.accum_dtype
    e0 = d_e0.to(acc)[:, None]
    step = max(1, PLAIN_BLOCK_ELEMS // max(1, n * k))
    for s in range(0, l, step):
        Sc = S[s:s + step]
        lc = Sc.shape[0]
        D = dist_plain(V, Sc.reshape(lc * k, d), policy, rbf_gamma)
        D = D.reshape(n, lc, k)
        mask = torch.arange(k, device=D.device)[None, :] < lengths[s:s + step, None]
        D = torch.where(mask[None], D, torch.inf)  # the kernels skip these slots
        yield s, torch.minimum(torch.amin(D, dim=-1), e0)


def fused_eval_plain(V, S, lengths, d_e0, *, n_total: int,
                     policy: PrecisionPolicy, layout: str = "flat",
                     rbf_gamma: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`fused_eval` — (l,) float32."""
    S = _as_sets(S, layout)
    out = torch.empty(S.shape[0], dtype=torch.float32, device=V.device)
    for s, dmin in _min_dists_plain(V, S, lengths, d_e0, policy, rbf_gamma):
        out[s:s + dmin.shape[1]] = torch.sum(dmin.to(torch.float32), dim=0) / n_total
    return out


def two_pass_eval_plain(V, S, lengths, d_e0, *, n_total: int,
                        policy: PrecisionPolicy,
                        rbf_gamma: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`two_pass_eval` — W (l, n) float32."""
    W = torch.empty((S.shape[0], V.shape[0]), dtype=torch.float32,
                    device=V.device)
    for s, dmin in _min_dists_plain(V, S, lengths, d_e0, policy, rbf_gamma):
        W[s:s + dmin.shape[1]] = (dmin.to(torch.float32) / n_total).T
    return W


def _check_eval_operands(V, S, lengths, d_e0, policy, layout):
    dev = V.device
    for name, t in (("S", S), ("lengths", lengths), ("d_e0", d_e0)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, V on {dev}")
    if V.ndim != 2 or S.ndim != 3 or not V.is_contiguous():
        raise ValueError("V must be a contiguous (n, d) tensor and S (·, ·, d)")
    if S.stride(2) != 1:
        raise ValueError("S must be contiguous along d")
    if S.dtype != V.dtype:
        raise ValueError(f"S dtype {S.dtype} differs from V dtype {V.dtype}")
    n, d = V.shape
    l, k, ds = _as_sets(S, layout).shape
    if ds != d:
        raise ValueError(f"S has d={ds}, V has d={d}")
    if lengths.dtype != torch.int32 or lengths.shape != (l,) \
            or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous (l,) int32 tensor")
    if d_e0.dtype != torch.float32 or d_e0.shape != (n,) \
            or not d_e0.is_contiguous():
        raise ValueError("d_e0 must be a contiguous (n,) float32 tensor")
    code = _build.operand_code(V.dtype, policy)
    if layout == "flat":
        s_set, s_slot = S.stride(1), S.stride(0)
    else:
        s_set, s_slot = S.stride(0), S.stride(1)
    return n, l, k, d, s_set, s_slot, code


def _launch_eval(kernel, fn, out, part, V, S, lengths, d_e0, n_total,
                 policy, k_chunk, layout, rbf_gamma):
    n, l, k, d, s_set, s_slot, code = _check_eval_operands(
        V, S, lengths, d_e0, policy, layout)
    if l == 0:
        return
    _build.launch(
        kernel, "exemplar_eval", fn, V.data_ptr(), S.data_ptr(),
        lengths.data_ptr(), d_e0.data_ptr(), out.data_ptr(),
        0 if part is None else part.data_ptr(), n, l, k, d,
        s_set, s_slot, int(k_chunk), float(n_total),
        -1.0 if rbf_gamma is None else float(rbf_gamma),
        _build.POLICY_CODES[policy.name], code, _build.stream_ptr(V.device))


@_build.kernel_call("fused_eval")
def fused_eval(
    V: torch.Tensor,          # (n, d) float32 or the policy's compute dtype
    S: torch.Tensor,          # flat: (k, l, d); loop: (l, k, d); V's dtype
    lengths: torch.Tensor,    # (l,) int32
    d_e0: torch.Tensor,       # (n,) float32 (already transformed)
    *,
    n_total: int,
    policy: PrecisionPolicy,
    k_chunk: Optional[int] = None,
    layout: str = "flat",
    rbf_gamma: Optional[float] = None,
) -> torch.Tensor:
    """L(S_j ∪ {e0}) for every set — (l,) float32. ``k_chunk`` (from
    :func:`repro_torch.kernels.ops.kernel_config`) is the number of k slots
    the kernel stages in shared memory at once; CUDA tensors need it."""
    if not V.is_cuda:
        return fused_eval_plain(V, S, lengths, d_e0, n_total=n_total,
                                policy=policy, layout=layout,
                                rbf_gamma=rbf_gamma)
    if k_chunk is None:
        raise ValueError("fused_eval on CUDA tensors needs k_chunk")
    l = _as_sets(S, layout).shape[0]
    out = torch.empty(l, dtype=torch.float32, device=V.device)
    # the per-segment partial sums the kernel's second pass adds up, then
    # the tensor-core kernel's row pass
    n, d = V.shape
    part = torch.empty(_build.workspace_floats(_build.n_segments(n) * l, 1, n,
                                               d, _build.tensor_cores(policy)),
                       dtype=torch.float32, device=V.device)
    _launch_eval("fused_eval", "repro_fused_eval", out, part, V, S, lengths,
                 d_e0, n_total, policy, k_chunk, layout, rbf_gamma)
    return out


@_build.kernel_call("two_pass_eval")
def two_pass_eval(
    V: torch.Tensor,          # (n, d)
    S: torch.Tensor,          # (l, k, d)
    lengths: torch.Tensor,    # (l,) int32
    d_e0: torch.Tensor,       # (n,) float32
    *,
    n_total: int,
    policy: PrecisionPolicy,
    k_chunk: Optional[int] = None,
    rbf_gamma: Optional[float] = None,
) -> torch.Tensor:
    """Paper-faithful: materialize W (l, n) float32; the caller reduces it."""
    if not V.is_cuda:
        return two_pass_eval_plain(V, S, lengths, d_e0, n_total=n_total,
                                   policy=policy, rbf_gamma=rbf_gamma)
    if k_chunk is None:
        raise ValueError("two_pass_eval on CUDA tensors needs k_chunk")
    W = torch.empty((S.shape[0], V.shape[0]), dtype=torch.float32,
                    device=V.device)
    # the tensor-core kernel's row pass
    rows = torch.empty(_build.workspace_floats(0, 1, *V.shape,
                                               _build.tensor_cores(policy)),
                       dtype=torch.float32, device=V.device)
    _launch_eval("two_pass_eval", "repro_two_pass_eval", W, rows, V, S,
                 lengths, d_e0, n_total, policy, k_chunk, "loop", rbf_gamma)
    return W
