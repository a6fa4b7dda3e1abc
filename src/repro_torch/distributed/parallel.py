"""Differentiable collectives of the LM mesh's train step.

c10d's collectives have no autograd, so each exchange of the train step
is a ``torch.autograd.Function`` whose backward is the exchange's
transpose. Every sum runs in shard order (an all-gather or an all-to-all,
then a left fold), never in a backend's own order, so every rank that
holds a replica of a sum holds the same bits.

* :func:`use_leaf` — FSDP (ZeRO-3) and the tensor-parallel weights. A
  parameter lives as this rank's block of its leaf
  (:meth:`MeshRules.local` of the leaf's dim spec). ``use_leaf`` gathers
  the blocks into the leaf (whole, or whole but for its model-axis block
  when a tensor-parallel product uses that block); its backward adds the
  leaf's gradient over the ranks that computed parts of it and cuts it
  back to this rank's block: over the data axes always (each data shard
  ran its own rows: a reduce-scatter where the leaf is split over them,
  an all-reduce where it is replicated), and over the model axis when the
  use is *partitioned* — inside a tensor-parallel region each model rank
  adds its own heads' or tokens' part — else each model rank computed the
  whole gradient and keeps its block of it.
* :func:`copy_in` / :func:`sum_out` — the two ends of a tensor-parallel
  region: the input, the same on every model rank, whose gradient is the
  sum of the ranks' parts; the row-split product's partial sums, added
  over the model group.
* :func:`gather_cat_grad` — an all-gather along a dim whose gradient is
  this rank's slice (the sequence gather closing expert parallelism).
* :func:`all_to_all` — ``all_to_all_single`` with equal splits; its
  backward is the same exchange of the gradient.

``sh`` arguments are :class:`~repro_torch.core.distributed.Shards`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.distributed import gather_cat, ordered_sum


def _by_group_rank(sh, chunks: list) -> list:
    """Chunks in shard order → in the group's rank order."""
    out = [None] * sh.p
    for s, g in enumerate(sh.order):
        out[g] = chunks[s]
    return out


def reduce_scatter(sh, g: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ over the shards of ``g``'s chunk ``sh.index`` along ``dim``,
    added in shard order (one all-to-all and a left fold)."""
    if sh.p == 1:
        return g
    chunks = [c.contiguous() for c in g.chunk(sh.p, dim)]
    send = torch.stack(_by_group_rank(sh, chunks))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=sh.group)
    acc = recv[sh.order[0]]
    for s in range(1, sh.p):
        acc = acc + recv[sh.order[s]]
    return acc


def all_reduce(sh, g: torch.Tensor) -> torch.Tensor:
    """Σ over the shards of ``g`` in shard order (every shard the same
    bits)."""
    return g if sh.p == 1 else ordered_sum(sh, g)


def _slice(sh, g: torch.Tensor, dim: int) -> torch.Tensor:
    return g.chunk(sh.p, dim)[sh.index].contiguous()


def _data_reduce(sh, g: torch.Tensor, dim):
    """The data-parallel sum of a leaf's gradient: reduce-scatter along
    the dim split over the data axes (``dim``), else all-reduce."""
    if dim is None:
        return all_reduce(sh, g)
    return reduce_scatter(sh, g, dim)


class _UseLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, data, d_dim, model, m_dim, partial):
        ctx.plan = (data, d_dim, model, m_dim, partial)
        x = block
        if data is not None and d_dim is not None:
            x = gather_cat(data, x, d_dim)
        if model is not None and m_dim is not None:
            x = gather_cat(model, x, m_dim)
        return x

    @staticmethod
    def backward(ctx, g):
        data, d_dim, model, m_dim, partial = ctx.plan
        g = g.contiguous()
        if model is not None:
            if m_dim is not None:
                g = (reduce_scatter(model, g, m_dim) if partial
                     else _slice(model, g, m_dim))
            elif partial:
                g = all_reduce(model, g)
        if data is not None:
            g = _data_reduce(data, g, d_dim)
        return g, None, None, None, None, None


def use_leaf(block: torch.Tensor, data, d_dim, model, m_dim,
             partial: bool) -> torch.Tensor:
    """The leaf gathered from its blocks (see the module's docstring).

    ``data``: the data axes' shards (None when they are one rank), and
    ``d_dim`` the leaf's dim split over them (None: replicated over them).
    ``model``: the model axis's shards, None when it is one rank or when
    the caller keeps the leaf's model-axis block (a tensor-parallel
    product); ``m_dim`` the dim split over it. ``partial``: the use is
    partitioned over the model axis, so the gradient adds over it."""
    if data is None and model is None:
        return block
    return _UseLeaf.apply(block, data, d_dim, model, m_dim, partial)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh):
        ctx.sh = sh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.sh, g.contiguous()), None


def copy_in(sh, x: torch.Tensor) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the shards."""
    return x if sh is None or sh.p == 1 else _CopyIn.apply(x, sh)


class _SumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh):
        return ordered_sum(sh, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_out(sh, x: torch.Tensor) -> torch.Tensor:
    """Σ over the shards of ``x`` in shard order; the gradient passes
    unchanged to every shard."""
    return x if sh is None or sh.p == 1 else _SumOut.apply(x, sh)


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh, dim):
        ctx.sh, ctx.dim = sh, dim
        return gather_cat(sh, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(ctx.sh, g, ctx.dim), None, None


def gather_cat_grad(sh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every shard's ``x`` concatenated along ``dim`` in shard order; the
    gradient of the whole is the same on every shard, and each keeps its
    slice of it."""
    return _GatherCat.apply(x, sh, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of equal splits along dim 0; its backward
    sends each gradient chunk back to where its row came from."""
    return _AllToAll.apply(x, group)
