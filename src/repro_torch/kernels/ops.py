"""Public wrappers around the CUDA kernels (the exemplar-eval, gain and
sieve halves of the reference's ``kernels/ops.py``).

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
kernel name; :data:`CALLS` counts kernel calls per kernel name on either
route (on the card the two agree).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.evaluator import plan_chunks
from repro_torch.core.precision import FP32, PrecisionPolicy
from repro_torch.kernels import exemplar_eval as _ee
from repro_torch.kernels import marginal_gain as _mg
from repro_torch.kernels import _build
from repro_torch.kernels._build import CALLS, LAUNCHES  # noqa: F401 — public counters

#: The tile shape compiled into csrc/tile.cuh: 256 threads as 16 × 16, each
#: owning 8 rows × RC columns; V streams in double-buffered 128 × 16 chunks.
BLOCK_N = 128      # V rows per tile
BLOCK_L = 32       # sets per exemplar-eval block (8 rows × 2 sets a thread)
CHUNK_D = 16       # V features staged per step
SEG = _build.SEG   # rows per segment of n: one segment per block
#: Candidates per gain block: 128 (8 a thread) where they fit the shared
#: memory budget, else 32 (2 a thread).
GAIN_BLOCK_M = (128, 32)
#: β — shared memory one Hopper block may opt into (227 KB).
SMEM_BUDGET = 232448
n_segments = _build.n_segments
#: Segments one block walks (csrc/tile.cuh ``segs_per_block``): the largest
#: of 8, 4, 2, 1 that still launches ``MIN_BLOCKS`` blocks.
MAX_SPB = 8
MIN_BLOCKS = 1024


def segs_per_block(col_blocks: int, n_segs: int) -> int:
    spb = MAX_SPB
    while spb > 1 and col_blocks * -(-n_segs // spb) < MIN_BLOCKS:
        spb //= 2
    return spb


def segments(n: int) -> list[tuple[int, int]]:
    """The ``[start, stop)`` row ranges of the kernels' fixed split of n:
    SEG rows each, the last one ragged; one empty segment at n = 0."""
    return [(s * SEG, min(n, (s + 1) * SEG)) for s in range(n_segments(n))]


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """The kernel configuration C = (D_g, D_b) of one exemplar-eval launch."""

    block_n: int    # V rows per tile (paper: b_x)
    block_l: int    # sets per block (paper: b_y)
    k_chunk: int    # k slots of the block's sets staged at once
    smem_bytes: int

    def grid(self, l: int, n: int) -> tuple[int, int]:
        """(set tiles, blocks along n): paper eq. 8's g_y = ⌈|S_multi|/b_y⌉,
        and the fixed split of n that takes the TPU's sequential n axis,
        ``segs_per_block`` segments a block."""
        gx, segs = -(-l // self.block_l), n_segments(n)
        return gx, -(-segs // segs_per_block(gx, segs))


def _round16(x: int) -> int:
    return (x + 15) & ~15


def smem_bytes(k_chunk: int, d: int, policy: PrecisionPolicy,
               block_cols: int = BLOCK_L, winner: bool = False) -> int:
    """Dynamic shared memory of one block — csrc/tile.cuh ``smem_bytes``:
    k_chunk feature-major slots of ``block_cols`` columns (row stride
    block_cols + 4), the winner (gain update), the double-buffered V chunk,
    the column norms and the cross-row reduction buffer."""
    s = 2 if policy.name == "fp16_strict" else 4   # staged element
    a = policy.accum_dtype.itemsize
    return (_round16(k_chunk * d * (block_cols + 4) * s)
            + _round16((d if winner else 0) * s)
            + _round16(2 * CHUNK_D * (BLOCK_N + 4) * s)
            + _round16((k_chunk * block_cols + 1) * a) + 16 * block_cols * 4)


def gain_block_cols(d: int, policy: PrecisionPolicy,
                    update: bool = False) -> int:
    """Candidates per block of the gain kernels at width d (the C
    launcher's ``gain_rc`` rule)."""
    wide, narrow = GAIN_BLOCK_M
    return wide if smem_bytes(1, d, policy, wide, update) <= SMEM_BUDGET \
        else narrow


def gain_grid(n: int, m: int, d: int, policy: PrecisionPolicy,
              batch: int = 1, update: bool = False) -> tuple[int, int, int]:
    """(candidate tiles, blocks along n, requests) of one gain launch."""
    gx, segs = max(1, -(-m // gain_block_cols(d, policy, update))), \
        n_segments(n)
    return gx, -(-segs // segs_per_block(gx * batch, segs)), batch


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
    n_total: Optional[int] = None,
) -> torch.Tensor:
    """L(S_j ∪ {e0}) for the packed multiset — (l,) float32. ``n_total``
    overrides the |V| normalizer (the global ground-set size when V is one
    row-shard)."""
    if mode not in ("fused", "two_pass"):
        raise ValueError(f"unknown mode {mode!r}")
    n, d = V.shape
    l, k, _ = S.shape
    V, S = _harmonize(policy, V, S)
    lengths = lengths.to(torch.int32).contiguous()
    d_e0 = d_e0.to(torch.float32).contiguous()
    kc = kernel_config(k, d, policy).k_chunk if V.is_cuda else None
    n_total = n if n_total is None else n_total
    outs = []
    for start, stop in plan_chunks(l, n, k, d, policy, mode,
                                   memory_budget_bytes):
        Sc, lc = S[start:stop], lengths[start:stop]
        if mode == "fused":
            if variant == "flat":
                Sc = Sc.permute(1, 0, 2).contiguous()  # k-major (interleave)
            outs.append(_ee.fused_eval(
                V, Sc, lc, d_e0, n_total=n_total, policy=policy, k_chunk=kc,
                layout=variant, rbf_gamma=rbf_gamma))
        else:
            W = _ee.two_pass_eval(V, Sc, lc, d_e0, n_total=n_total,
                                  policy=policy, k_chunk=kc,
                                  rbf_gamma=rbf_gamma)
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

    Batched dispatch: ``V (B, n, d)``, ``C (B, m, d)`` and ``mincache
    (B, n)`` route to the grid-over-B kernel — one launch scores all B
    requests, each bit for bit as its own unbatched call — and return
    (B, m).
    """
    V, C = _harmonize(policy, V, C)
    gain = _mg.gain_eval_batched if V.ndim == 3 else _mg.gain_eval
    return gain(
        V.contiguous(), C.contiguous(), mincache.to(torch.float32).contiguous(),
        n_total=n_total if n_total is not None else V.shape[-2], policy=policy,
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

    Batched dispatch: ``V (B, n, d)``, ``C (B, m, d)``, ``mincache (B, n)``,
    ``winner (B, d)`` and ``w_valid (B,)`` (a device tensor, default all
    ones) fold and score all B requests in one launch; a request's
    ``w_valid`` lane is also its ragged-k gate.
    """
    V, C, winner = _harmonize(policy, V, C, winner)
    batched = V.ndim == 3
    if w_valid is None:
        w_valid = torch.ones(V.shape[:1] if batched else (),
                             dtype=torch.float32, device=V.device)
    update = _mg.gain_update_eval_batched if batched else _mg.gain_update_eval
    return update(
        V.contiguous(), C.contiguous(), mincache.to(torch.float32).contiguous(),
        winner.contiguous(), w_valid.to(torch.float32).contiguous(),
        n_total=n_total if n_total is not None else V.shape[-2], policy=policy,
        rbf_gamma=rbf_gamma, fold=fold,
        affine=None if score_affine is None else tuple(score_affine),
        cache_out=cache_out)


# ---------------------------------------------------------------------------
# sieve_gain — the streaming sieve engine's table × element scoring
# ---------------------------------------------------------------------------


def _seed_row(seed: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if seed is None else seed.to(torch.float32).contiguous()


def sieve_gains(
    table: torch.Tensor,      # (r, n) float32 per-element cache rows
    dvec: torch.Tensor,       # (n,) float32 one element's distances to V
    *,
    seed: Optional[torch.Tensor] = None,   # (n,) the function's seed row
    n_total: Optional[int] = None,
    fold: str = "min",
    score_affine: Optional[tuple] = None,
) -> torch.Tensor:
    """Per-row gains of a cache table vs one stream element — (r,), or
    (r + 1,) with ``seed``: the gains of ``cat([seed[None], table])``, the
    seed read through its own pointer with no copy of the table.

    min template (default): row r gets
    ``n_total⁻¹ Σ_i relu(table[r, i] − dvec[i])``; max template
    (``fold="max"``, ``score_affine=(α, β)``):
    ``n_total⁻¹ Σ_i relu((α + β·dvec[i]) − table[r, i])``. Row = a sieve's
    cache → its marginal gain Δ(e | S_r); row = the seed → the singleton
    gain Δ(e | ∅). ``n_total`` overrides the n normalizer. No padding: the
    kernel stops at n itself.
    """
    return _mg.sieve_gain_eval(
        table.to(torch.float32).contiguous(),
        dvec.to(torch.float32).contiguous(),
        n_total=n_total if n_total is not None else table.shape[-1],
        fold=fold,
        affine=None if score_affine is None else tuple(score_affine),
        seed=_seed_row(seed))


def sieve_gains_batched(
    tables: torch.Tensor,     # (P, r, n) float32 per-partition cache rows
    dvecs: torch.Tensor,      # (P, n) float32 per-partition element distances
    *,
    seed: Optional[torch.Tensor] = None,   # (n,) one seed row for all P
    n_total: Optional[int] = None,
    fold: str = "min",
    score_affine: Optional[tuple] = None,
) -> torch.Tensor:
    """Batched :func:`sieve_gains` — P partition tables scored against P
    stream elements in one launch; returns (P, r), or (P, r + 1) with one
    ``seed`` row scored first in every partition. Each partition's gains
    are bit for bit its own :func:`sieve_gains` call (the batched
    multi-stream sieve engine's parity rests on it)."""
    return _mg.sieve_gain_eval_batched(
        tables.to(torch.float32).contiguous(),
        dvecs.to(torch.float32).contiguous(),
        n_total=n_total if n_total is not None else tables.shape[-1],
        fold=fold,
        affine=None if score_affine is None else tuple(score_affine),
        seed=_seed_row(seed))
