"""AdamW with fp32 master weights + cosine schedule (no external deps).

The port of the JAX package's ``train/optimizer.py``, as plain functions on
tensors. True mixed precision: model params live in cfg.dtype (bf16), the
optimizer keeps fp32 master params and moments, one per parameter, in the
order of ``model.named_parameters()``.

Neither ``torch.optim.AdamW`` nor ``clip_grad_norm_`` computes the
reference's update: it divides by ``sqrt(v / bc2) + eps`` (not
``sqrt(v) / sqrt(bc2) + eps``), adds the weight decay inside ``delta``
before the ``lr`` product, and clips by ``min(1, clip / (gnorm + 1e-9))``.
So the update is written out here, op for op in the reference's order,
over ``torch._foreach_*`` lists (one launch per op and chunk of leaves, each
op rounding where the reference's rounds). The schedule, ``bc1`` and
``bc2`` are fp32 tensors computed on the device from the int32 ``step``, as
the reference's are.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The fp32 learning rate at an int32 ``step`` tensor (any shape)."""
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps).float()
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(model: torch.nn.Module) -> dict:
    """``{"master", "m", "v"}``: dicts of fp32 tensors keyed by parameter
    name (the master a copy, never an alias of an fp32 parameter), and
    ``"step"``, an int32 scalar on the parameters' device."""
    named = list(model.named_parameters())
    dev = named[0][1].device
    return {
        "master": {n: p.detach().to(torch.float32, copy=True)
                   for n, p in named},
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
              for n, p in named},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
              for n, p in named},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(grads) -> torch.Tensor:
    """√(Σ over leaves of Σ g²) in fp32, the reference's formula: each
    leaf's squares summed by one reduction (pairwise on the CPU, a tree
    on the card), the leaves' sums then added. Not ``_foreach_norm``: on
    the CPU it accumulates a leaf sequentially, which at a 155 M-element
    embedding gradient was 3e-5 low (2.6e-4 at xlstm's 103 M)."""
    sq = torch._foreach_mul(grads, grads)
    return torch.sqrt(torch.stack([torch.sum(s) for s in sq]).sum())


def mesh_global_norm(grads, first: list, sh) -> torch.Tensor:
    """:func:`global_norm` of a gradient placed on a mesh, each rank
    holding its blocks: each leaf's block summed as one reduction on each
    rank, counted only on the rank that holds the block's first replica
    (``first``, per leaf: True where this rank does), the ranks' sums
    gathered over ``sh`` (the shards of every mesh axis) and added in rank
    order, then the leaves' sums added as one device adds them. Every rank
    gets the same bits; on one rank, :func:`global_norm`'s."""
    sq = torch._foreach_mul(grads, grads)
    sums = torch.stack([torch.sum(s) for s in sq])
    keep = torch.tensor(first, dtype=torch.bool, device=sums.device)
    sums = torch.where(keep, sums, torch.zeros_like(sums))
    if sh.p > 1:
        from repro_torch.core.distributed import ordered_sum

        sums = ordered_sum(sh, sums)
    return torch.sqrt(sums.sum())


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads: list, opt_state: dict,
                 params: list, gnorm=None) -> tuple:
    """One AdamW step over ``grads``, aligned with ``opt_state``'s dicts
    and ``params``. Updates the master, the moments and the step in
    place, writes the master into ``params`` in their dtype, and returns
    ``(opt_state, {"lr", "grad_norm"})`` (fp32 device scalars).

    On a mesh every leaf is this rank's block and ``gnorm`` is the whole
    gradient's norm (:func:`mesh_global_norm`); the update is elementwise,
    so each rank updates its blocks."""
    step = opt_state["step"]
    lr = lr_at(cfg, step)
    grads = [g.float() for g in grads]
    if gnorm is None:
        gnorm = global_norm(grads)
    # a tensor numerator: ``float / tensor`` is a reciprocal and a product
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                        / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** (step.float() + 1)
    bc2 = 1 - b2 ** (step.float() + 1)

    master = list(opt_state["master"].values())
    m = list(opt_state["m"].values())
    v = list(opt_state["v"].values())
    if not len(grads) == len(master) == len(params):
        raise ValueError(f"{len(grads)} gradients for {len(master)} master "
                         f"leaves and {len(params)} parameters")
    g = torch._foreach_mul(grads, scale)
    m_new = torch._foreach_add(torch._foreach_mul(m, b1),
                               torch._foreach_mul(g, 1 - b1))
    gg = torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g)
    v_new = torch._foreach_add(torch._foreach_mul(v, b2), gg)
    mh = torch._foreach_div(m_new, bc1)
    vh = torch._foreach_div(v_new, bc2)
    den = torch._foreach_add(torch._foreach_sqrt(vh), cfg.eps)
    delta = torch._foreach_add(torch._foreach_div(mh, den),
                               torch._foreach_mul(master, cfg.weight_decay))
    new_master = torch._foreach_sub(master, torch._foreach_mul(delta, lr))
    torch._foreach_copy_(master, new_master)
    torch._foreach_copy_(m, m_new)
    torch._foreach_copy_(v, v_new)
    torch._foreach_copy_([p.data for p in params], new_master)
    step.add_(1)
    return opt_state, {"lr": lr, "grad_norm": gnorm}
