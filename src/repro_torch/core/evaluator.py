"""The multiset evaluation engine — the paper's core contribution.

Given a ground set ``V`` (n, d) and a packed multiset ``S_multi`` (l, k, d),
computes ``L(S_j ∪ {e0})`` for all j at once by (conceptually) building the
work matrix

    W[j, i] = |V|⁻¹ · min_{s ∈ S_j ∪ {e0}} d(v_i, s)            (paper eq. 7)

and reducing rows. Two modes:

* ``two_pass`` — paper-faithful: materialize ``W`` (in chunks), then reduce.
* ``fused`` — beyond-paper: the row reduction is fused into the distance
  computation; ``W`` never exists in device memory.

Three backends:

* ``torch`` — plain PyTorch; the oracle and the counterpart of ``jnp``.
* ``naive`` — paper's Algorithm 2, a per-set loop (the single-thread
  baseline for the speedup benchmarks).
* ``cuda``  — the hand-written CUDA kernels (Gram tile + fused min/sum
  epilogue); on CPU tensors their plain PyTorch versions run.

Chunking (paper §IV-B-3): ``memory_budget_bytes`` bounds the per-chunk working
set; chunk count follows the paper's formula, and exhaustion raises with the
paper's remediation advice (lower precision / bigger device).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import distances as dist_mod
from repro_torch.core.multiset import PackedMultiset
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.precision import resolve as resolve_policy

BACKENDS = ("torch", "naive", "cuda")


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Configuration for multiset evaluation."""

    distance: str = "sqeuclidean"
    policy: str | PrecisionPolicy = "fp32"
    mode: str = "fused"  # "fused" | "two_pass"
    backend: str = "torch"  # "torch" | "naive" | "cuda"
    kernel_variant: str = "flat"  # cuda layout: "flat" (k-major) | "loop"
    #: None → no chunking; an int → hard byte budget; "auto" → derive from
    #: the free-memory probe φ (:func:`free_memory_bytes`).
    memory_budget_bytes: Optional[int | str] = None
    n_block: Optional[int] = None  # stream over V in blocks of this many rows

    def __post_init__(self):
        # Fail at construction, not deep inside the first dispatch.
        if self.distance not in dist_mod.PAIRWISE:
            raise ValueError(
                f"unknown distance {self.distance!r}; registered: "
                f"{sorted(dist_mod.PAIRWISE)}")
        if self.mode not in ("fused", "two_pass"):
            raise ValueError(
                f"mode must be 'fused' or 'two_pass', got {self.mode!r}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of "
                f"'torch', 'naive', 'cuda'")
        if self.kernel_variant not in ("flat", "loop"):
            raise ValueError(
                f"kernel_variant must be 'flat' or 'loop', "
                f"got {self.kernel_variant!r}")
        resolve_policy(self.policy)  # raises on unknown policy names
        if isinstance(self.memory_budget_bytes, str) \
                and self.memory_budget_bytes != "auto":
            raise ValueError(
                f"memory_budget_bytes must be an int, None, or 'auto'; "
                f"got {self.memory_budget_bytes!r}")

    def resolved_policy(self) -> PrecisionPolicy:
        return resolve_policy(self.policy)


#: Fraction of probed free memory an "auto" budget hands to the chunk planner
#: (headroom for temporaries and the output buffers).
AUTO_BUDGET_FRACTION = 0.8

#: Resolved "auto" budget, probed ONCE per process and then frozen: a budget
#: floating with live allocator state would change chunk boundaries (and so
#: the summation grouping) from call to call.
_AUTO_BUDGET_BYTES: "Optional[int] | bool" = False  # False = not yet probed


def free_memory_bytes(device=None) -> Optional[int]:
    """The paper's free-memory probe φ (§IV-B-3): free bytes on ``device``.

    ``torch.cuda.mem_get_info`` on a CUDA device; None on the CPU (callers
    fall back to their static heuristics). ``device=None`` probes the current
    CUDA device when one exists.
    """
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free)


def resolve_memory_budget(budget: Optional[int | str]) -> Optional[int]:
    """Resolve ``memory_budget_bytes``: pass ints/None through, probe "auto".

    The "auto" probe runs once per process and is then frozen. A probe that
    reports 0 free bytes resolves to a 0 budget (so the chunk planner raises
    :class:`ChunkingError` with the paper's remediation advice) rather than
    silently disabling chunking — only a probeless device degrades to
    unchunked.
    """
    global _AUTO_BUDGET_BYTES
    if budget == "auto":
        if _AUTO_BUDGET_BYTES is False:
            free = free_memory_bytes()
            _AUTO_BUDGET_BYTES = (
                int(free * AUTO_BUDGET_FRACTION) if free is not None else None)
        return _AUTO_BUDGET_BYTES
    if isinstance(budget, str):
        raise ValueError(
            f"memory_budget_bytes must be an int, None, or 'auto'; "
            f"got {budget!r}")
    return budget


class ChunkingError(MemoryError):
    """Raised when not even a single evaluation set fits the memory budget.

    The paper (§IV-B-3): "suggests either the use of lower floating-point
    precision … or better suited hardware with larger memory."
    """


def bytes_per_set(n: int, k_max: int, d: int, policy: PrecisionPolicy,
                  mode: str) -> int:
    """μ_s — device bytes needed per evaluation set (paper §IV-B-3).

    Counts the packed set payload, the Gram/distance block against all of V,
    and (two_pass only) the materialized W row. V itself is excluded — the
    paper pre-loads it at init and accounts it in the free-memory probe φ.
    """
    cs = policy.itemsize
    acc = policy.accum_dtype.itemsize  # Gram/W block width
    mu = k_max * d * cs + n * k_max * acc
    if mode == "two_pass":
        mu += n * acc
    return mu


def plan_chunks(
    l: int, n: int, k_max: int, d: int, policy: PrecisionPolicy, mode: str,
    budget_bytes: Optional[int | str],
) -> list[tuple[int, int]]:
    """Split l sets into chunks fitting the budget. Returns [start, stop) pairs.

    ``budget_bytes`` may be "auto", resolved via the free-memory probe φ.
    """
    budget_bytes = resolve_memory_budget(budget_bytes)
    if budget_bytes is None:
        return [(0, l)]
    mu = bytes_per_set(n, k_max, d, policy, mode)
    per_chunk = budget_bytes // mu  # n_chunk-size = ⌊φ μ_s⁻¹⌋
    if per_chunk == 0:
        raise ChunkingError(
            f"memory budget {budget_bytes}B cannot fit a single evaluation set "
            f"(μ_s={mu}B). Use a lower floating-point precision or a larger "
            f"memory budget (paper §IV-B-3)."
        )
    n_chunks = math.ceil(l / per_chunk)  # ⌈l · n_chunk-size⁻¹⌉
    return [(i * per_chunk, min((i + 1) * per_chunk, l)) for i in range(n_chunks)]


# ---------------------------------------------------------------------------
# torch backend
# ---------------------------------------------------------------------------


def _min_dists_block(V, data, lengths, d_e0, distance: str,
                     policy: PrecisionPolicy) -> torch.Tensor:
    """(n, l) matrix of min_{s∈S_j∪{e0}} d(v_i, s) for one chunk of sets."""
    l, k, d = data.shape
    pair = dist_mod.resolve_pairwise(distance)
    D = pair(V, data.reshape(l * k, d), policy)  # (n, l·k)
    D = D.reshape(V.shape[0], l, k)
    mask = torch.arange(k, device=D.device)[None, :] < lengths[:, None]
    big = torch.tensor(torch.finfo(D.dtype).max, dtype=D.dtype, device=D.device)
    D = torch.where(mask[None, :, :], D, big)
    dmin = torch.amin(D, dim=-1)  # (n, l)
    return torch.minimum(dmin, d_e0[:, None].to(D.dtype))


def _eval_torch(V, packed: PackedMultiset, d_e0, cfg: EvalConfig):
    policy = cfg.resolved_policy()
    chunks = plan_chunks(
        packed.num_sets, V.shape[0], packed.k_max, packed.dim, policy,
        cfg.mode, cfg.memory_budget_bytes,
    )
    n = V.shape[0]
    outs = []
    for start, stop in chunks:
        sub = packed.slice_sets(start, stop)
        if cfg.n_block is not None:
            outs.append(_eval_torch_nblocked(V, sub, d_e0, cfg, policy))
        else:
            # two_pass materializes the paper's W (transposed) here; fused
            # reduces the same block at once — in plain torch the two differ
            # only in what the caller may keep
            dmin = _min_dists_block(V, sub.data, sub.lengths, d_e0,
                                    cfg.distance, policy)
            outs.append(torch.sum(dmin, dim=0) / n)
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _eval_torch_nblocked(V, packed, d_e0, cfg, policy):
    """Stream over V in blocks (bounds the n×l·k Gram block)."""
    n = V.shape[0]
    total = torch.zeros((packed.num_sets,), dtype=torch.float32,
                        device=V.device)
    for s in range(0, n, cfg.n_block):
        dmin = _min_dists_block(V[s:s + cfg.n_block], packed.data,
                                packed.lengths, d_e0[s:s + cfg.n_block],
                                cfg.distance, policy)
        total = total + torch.sum(dmin, dim=0)
    return total / n


# ---------------------------------------------------------------------------
# naive backend — paper Algorithm 2 (single-set loop), the ST baseline
# ---------------------------------------------------------------------------


def _naive_single_set(V, sdata, slen: int, d_e0, distance, policy):
    pair = dist_mod.resolve_pairwise(distance)
    # inner loop of Algorithm 2: t = min(t, d(s, v)) over s ∈ S
    dd = pair(V, sdata, policy)  # (n, k)
    valid = torch.arange(sdata.shape[0], device=dd.device) < slen
    dd = torch.where(valid[None, :], dd, torch.finfo(dd.dtype).max)
    point_loss = torch.minimum(torch.amin(dd, dim=1), d_e0.to(dd.dtype))
    return torch.sum(point_loss) / V.shape[0]


def _eval_naive(V, packed, d_e0, cfg):
    policy = cfg.resolved_policy()
    lengths = packed.lengths.tolist()
    vals = [
        _naive_single_set(V, packed.data[j], lengths[j], d_e0, cfg.distance,
                          policy)
        for j in range(packed.num_sets)  # the un-parallelized outer loop
    ]
    return torch.stack(vals)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def e0_distances(
    V: torch.Tensor,
    e0: Optional[torch.Tensor],
    distance: str,
    policy: "str | PrecisionPolicy" = "fp32",
) -> torch.Tensor:
    """d(v_i, e0) for all i. e0 defaults to the all-zero auxiliary vector.

    ``policy`` is the caller's precision policy — half-precision sweeps must
    compute the e0 column with the same policy as the rest of the work matrix.
    """
    if e0 is None:
        e0 = torch.zeros((V.shape[-1],), dtype=V.dtype, device=V.device)
    pair = dist_mod.resolve_pairwise(distance)
    return pair(V, e0[None, :], resolve_policy(policy))[:, 0]


def evaluate_multiset(
    V: torch.Tensor,
    packed: PackedMultiset,
    cfg: EvalConfig = EvalConfig(),
    d_e0: Optional[torch.Tensor] = None,
    e0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """L(S_j ∪ {e0}) for every set in the multiset. Returns (l,) float32."""
    if d_e0 is None:
        d_e0 = e0_distances(V, e0, cfg.distance, cfg.policy)
    if cfg.backend == "torch":
        out = _eval_torch(V, packed, d_e0, cfg)
    elif cfg.backend == "naive":
        out = _eval_naive(V, packed, d_e0, cfg)
    else:
        from repro_torch.kernels import ops as kops  # lazy: no import cycle

        if cfg.distance not in dist_mod.MXU_ELIGIBLE:
            raise ValueError(
                f"cuda backend supports {sorted(dist_mod.MXU_ELIGIBLE)}, "
                f"got {cfg.distance!r}"
            )
        out = kops.exemplar_eval(
            V,
            packed.data,
            packed.lengths,
            d_e0,
            policy=cfg.resolved_policy(),
            mode=cfg.mode,
            variant=cfg.kernel_variant if cfg.mode == "fused" else "loop",
            memory_budget_bytes=cfg.memory_budget_bytes,
            rbf_gamma=dist_mod.RBF_GAMMA if cfg.distance == "rbf" else None,
        )
    return out.to(torch.float32)


def work_matrix(
    V: torch.Tensor,
    packed: PackedMultiset,
    cfg: EvalConfig = EvalConfig(mode="two_pass"),
    d_e0: Optional[torch.Tensor] = None,
    e0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The paper's W, shape (l, n): W[j,i] = min-dist / n. Materialized.

    Respects ``cfg.memory_budget_bytes`` via the same chunk planner as
    :func:`evaluate_multiset`.
    """
    if d_e0 is None:
        d_e0 = e0_distances(V, e0, cfg.distance, cfg.policy)
    policy = cfg.resolved_policy()
    chunks = plan_chunks(
        packed.num_sets, V.shape[0], packed.k_max, packed.dim, policy,
        "two_pass", cfg.memory_budget_bytes,
    )
    outs = []
    for start, stop in chunks:
        sub = packed.slice_sets(start, stop)
        outs.append(_min_dists_block(
            V, sub.data, sub.lengths, d_e0, cfg.distance, policy))  # (n, l_c)
    dmin = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return dmin.T / V.shape[0]
