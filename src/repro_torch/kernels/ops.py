"""Public wrappers around the CUDA kernels (the unbatched half of the
reference's ``kernels/ops.py``).

Handles what the CUDA host code in the paper handles:

* **kernel configuration** (paper's ``C = (D_g, D_b)`` formula, §IV-B-1):
  :func:`kernel_config` sizes the shared-memory staging from Hopper's budget
  β, as the paper chooses ``b_x = min(⌊1024/b_y⌋, ⌊β/γ⌋)``.
* **layout** (paper's vectorization routine §IV-B-2): the ``flat`` variant
  hands the kernel the k-major ``(k, l, d)`` transpose of the multiset. No
  padding: the kernels mask ragged n, l, m and d edges themselves.
* **chunking** (paper §IV-B-3): an optional memory budget splits the multiset.

Every wrapper runs its kernel on CUDA tensors (or raises) and its plain
PyTorch version on CPU tensors. :data:`LAUNCHES` counts kernel launches per
kernel name.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.evaluator import plan_chunks
from repro_torch.core.precision import FP32, PrecisionPolicy
from repro_torch.kernels import exemplar_eval as _ee
from repro_torch.kernels import marginal_gain as _mg
from repro_torch.kernels._build import LAUNCHES  # noqa: F401 — public counter

#: The tile shape compiled into csrc/tile.cuh: 256 threads, each owning
#: 4 rows × 2 columns of cells.
BLOCK_N = 64       # V rows per tile
BLOCK_L = 32       # sets (or candidates) per block
CHUNK_D = 32       # V features staged per step
#: β — shared memory one Hopper block may opt into (227 KB).
SMEM_BUDGET = 232448


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """The kernel configuration C = (D_g, D_b) of one exemplar-eval launch."""

    block_n: int    # V rows per tile (paper: b_x)
    block_l: int    # sets per block (paper: b_y)
    k_chunk: int    # k slots of the block's sets staged at once
    smem_bytes: int

    def grid(self, l: int) -> int:
        # paper eq. 8, g_y = ⌈|S_multi|/b_y⌉; the n axis is a loop in the block
        return -(-l // self.block_l)


def _round16(x: int) -> int:
    return (x + 15) & ~15


def smem_bytes(k_chunk: int, d: int, policy: PrecisionPolicy) -> int:
    """Dynamic shared memory of one block — csrc/tile.cuh ``smem_bytes``."""
    s = 2 if policy.name == "fp16_strict" else 4   # staged element
    a = policy.accum_dtype.itemsize
    sd = d | 1
    return (_round16(k_chunk * BLOCK_L * sd * s)
            + _round16(BLOCK_N * (CHUNK_D + 1) * s)
            + _round16(k_chunk * BLOCK_L * a) + 16 * BLOCK_L * 4)


def kernel_config(k: int, d: int, policy: PrecisionPolicy,
                  smem_budget: int = SMEM_BUDGET) -> KernelConfig:
    """The paper's rule, with the staged operand turned around.

    The paper stages b_x vectors of V per block, γ bytes each, under the
    shared-memory budget β: ``b_x = min(⌊1024/b_y⌋, ⌊β/γ⌋)``. Here the
    block's b_y = 32 sets stay staged while V streams past, so the rule picks
    how many of their k slots fit at once:
    ``k_chunk = min(k, ⌊β'/(b_y·γ)⌋)``, with γ = d·(staged element size) and
    β' what is left of β after the V chunk and the reduction buffers. When
    ``k_chunk = k`` the block reads its sets from device memory once.
    """
    fixed = smem_bytes(0, d, policy)
    per_slot = smem_bytes(1, d, policy) - fixed
    kc = min(k, max(0, (smem_budget - fixed) // per_slot + 1))
    while kc > 0 and smem_bytes(kc, d, policy) > smem_budget:
        kc -= 1
    if kc < 1:
        raise ValueError(
            f"d={d} is too wide for one staged k slot of {BLOCK_L} sets in "
            f"{smem_budget} bytes of shared memory at policy {policy.name}")
    return KernelConfig(block_n=BLOCK_N, block_l=BLOCK_L, k_chunk=kc,
                        smem_bytes=smem_bytes(kc, d, policy))


def _harmonize(policy: PrecisionPolicy, *xs):
    """The kernels take one payload dtype: float32, or the policy's compute
    dtype. A float32 operand beside a compute-dtype one is rounded to the
    compute dtype here — the same round-to-nearest the kernel applies
    in-tile, so the result is unchanged."""
    cd = policy.compute_dtype
    if any(x.dtype != torch.float32 for x in xs):
        return tuple(x.to(cd) for x in xs)
    return xs


# ---------------------------------------------------------------------------
# exemplar_eval
# ---------------------------------------------------------------------------


def exemplar_eval(
    V: torch.Tensor,
    S: torch.Tensor,            # (l, k, d)
    lengths: torch.Tensor,      # (l,)
    d_e0: torch.Tensor,         # (n,)
    *,
    policy: PrecisionPolicy = FP32,
    mode: str = "fused",
    variant: str = "flat",
    memory_budget_bytes: Optional[int | str] = None,  # int | None | "auto"
    rbf_gamma: Optional[float] = None,
) -> torch.Tensor:
    """L(S_j ∪ {e0}) for the packed multiset — (l,) float32."""
    if mode not in ("fused", "two_pass"):
        raise ValueError(f"unknown mode {mode!r}")
    n, d = V.shape
    l, k, _ = S.shape
    V, S = _harmonize(policy, V, S)
    lengths = lengths.to(torch.int32).contiguous()
    d_e0 = d_e0.to(torch.float32).contiguous()
    kc = kernel_config(k, d, policy).k_chunk if V.is_cuda else None
    outs = []
    for start, stop in plan_chunks(l, n, k, d, policy, mode,
                                   memory_budget_bytes):
        Sc, lc = S[start:stop], lengths[start:stop]
        if mode == "fused":
            if variant == "flat":
                Sc = Sc.permute(1, 0, 2).contiguous()  # k-major (interleave)
            outs.append(_ee.fused_eval(
                V, Sc, lc, d_e0, n_total=n, policy=policy, k_chunk=kc,
                layout=variant, rbf_gamma=rbf_gamma))
        else:
            W = _ee.two_pass_eval(V, Sc, lc, d_e0, n_total=n, policy=policy,
                                  k_chunk=kc, rbf_gamma=rbf_gamma)
            # second pass: the paper's W·1 row reduction
            outs.append(torch.sum(W, dim=1))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# marginal_gain
# ---------------------------------------------------------------------------


def marginal_gain(
    V: torch.Tensor,
    C: torch.Tensor,
    mincache: torch.Tensor,
    *,
    policy: PrecisionPolicy = FP32,
    rbf_gamma: Optional[float] = None,
    n_total: Optional[int] = None,
    fold: str = "min",
    score_affine: Optional[tuple] = None,
) -> torch.Tensor:
    """Δ(c_j | S) for all candidates — (m,) float32.

    ``n_total`` overrides the |V| normalizer (the global ground-set size
    when V is one row-shard). ``fold``/``score_affine`` select the kernel
    template: the default ``"min"`` scores the exemplar min-distance cache;
    ``("max", (α, β))`` scores relu((α + β·d) − cache) against a
    max-similarity cache.
    """
    V, C = _harmonize(policy, V, C)
    return _mg.gain_eval(
        V.contiguous(), C.contiguous(), mincache.to(torch.float32).contiguous(),
        n_total=n_total if n_total is not None else V.shape[0], policy=policy,
        rbf_gamma=rbf_gamma, fold=fold,
        affine=None if score_affine is None else tuple(score_affine))


def fused_gain_update(
    V: torch.Tensor,
    C: torch.Tensor,
    mincache: torch.Tensor,
    winner: torch.Tensor,        # (d,) previous round's winning candidate
    *,
    policy: PrecisionPolicy = FP32,
    rbf_gamma: Optional[float] = None,
    n_total: Optional[int] = None,
    fold: str = "min",
    score_affine: Optional[tuple] = None,
    w_valid: Optional[torch.Tensor] = None,
    cache_out: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused greedy step (device engine): fold ``winner`` into the cache
    (min: cache ← min(cache, d(·, w)); max: cache ← max(cache, s(·, w))),
    then Δ(c_j | S) against the updated cache. Returns ``(gains,
    new_cache)``.

    ``w_valid`` (a device float, default 1) gates the fold: pass 0 on the
    round-0 step where no previous winner exists. ``cache_out`` receives the
    new cache (a buffer distinct from ``mincache``, so a caller can
    ping-pong two buffers instead of allocating one per round).
    """
    V, C, winner = _harmonize(policy, V, C, winner)
    if w_valid is None:
        w_valid = torch.ones((), dtype=torch.float32, device=V.device)
    return _mg.gain_update_eval(
        V.contiguous(), C.contiguous(), mincache.to(torch.float32).contiguous(),
        winner.contiguous(), w_valid.to(torch.float32),
        n_total=n_total if n_total is not None else V.shape[0], policy=policy,
        rbf_gamma=rbf_gamma, fold=fold,
        affine=None if score_affine is None else tuple(score_affine),
        cache_out=cache_out)
