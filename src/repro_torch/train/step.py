"""Train, prefill and serve step builders.

The train step takes the train state (the model and its optimizer state)
and a batch, differentiates the whole parameter tree with autograd
(optionally over microbatches, each layer rematerialised), and applies
AdamW in place; its metrics stay on the device. A serve step takes the
model and a batch and returns the next token as a device tensor, so a loop
of steps feeds each token to the next without reading anything back.

Every step takes ``rules`` (a
:class:`~repro_torch.distributed.sharding.MeshRules` on a ``DeviceMesh``)
as the reference's do, and every rank calls it with the whole batch. The
prefill and serve steps run each rank's rows (split over the data axes)
against its own block of the cache, and return the whole batch's next
tokens, gathered in shard order. The train step takes a *placed* train
state (:func:`init_train_state` with ``rules``, or
:func:`place_train_state`): each rank holds its block of every leaf of the
params, the master and the moments, as :func:`state_shardings` places
them. Each layer gathers its weights when it runs (FSDP over the data
axes, tensor-parallel products over the model axis: see
:mod:`repro_torch.models.placed`), the backward adds each leaf's gradient
over the ranks that computed parts of it and cuts it to the block — the
data-parallel sum — and AdamW updates the blocks by the whole gradient's
norm. The placement tables below give the state's, the batch's and the
cache's dim specs.
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import gather_cat, ordered_sum
from repro_torch.distributed.sharding import _axes, on_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state, mesh_global_norm)

KV_DIMS = (("batch",), (None,), ("tp",), (None, "tp"))
KV_DIMS_SEQSHARD = (("batch",), ("tp",), (None,), (None,))


def batch_dims(cfg: ModelConfig, batch_tree):
    """Dim specs for an input batch tree (tokens/labels/frontend/pos)."""
    def dims_for(keys, leaf):
        name = keys[-1]
        if name in ("tokens", "labels"):
            return (("batch",), ("sp",))
        if name == "frontend":
            return (("batch",), (None,), (None,))
        if name == "pos":
            return ()
        raise KeyError(name)

    return M.tree_map_with_keys(dims_for, batch_tree)


def cache_dims_tree(cfg: ModelConfig, cache_tree, rules=None):
    """Dim specs for a decode-cache tree (tensors or ``TensorSpec``s),
    keyed on group kind + leaf rank.

    When kv heads don't divide the model axis, KV caches are *sequence*
    sharded over it and decode runs the flash-decoding combine
    (``layers._decode_attn_seqshard``).
    """
    shape = getattr(rules, "shape", None)
    seqshard = bool(shape) and shape.get("model", 1) > 1 and \
        cfg.num_kv_heads % shape["model"] != 0
    kv_dims = KV_DIMS_SEQSHARD if seqshard else KV_DIMS

    def dims_for(keys, leaf):
        if keys and keys[0] == "enc_out":
            return (("batch",), (None,), (None,))
        kind = keys[0].split("_", 1)[1] if keys else ""
        leafname = keys[-1] if keys else ""
        r = len(leaf.shape)
        if leafname in ("k", "v"):
            return ((None,),) + kv_dims        # stacked layer dim first
        if leafname == "conv":
            return ((None,), ("batch",), (None,), ("tp",))
        # ssm states (a state tuple's leaves share the tuple's key)
        if kind == "mlstm" or kind == "slstm":
            # ranks: 5=(L,B,H,Dh,Dh), 4=(L,B,H,Dh), 3=(L,B,H)
            if r == 5:
                return ((None,), ("batch",), (None,), (None,), ("tp",))
            if r == 4:
                return ((None,), ("batch",), (None,), (None, "tp"))
            return ((None,), ("batch",), (None,))
        if kind in ("hybrid_full", "hybrid_sw"):
            if leafname == "ssm" or r == 4:
                return ((None,), ("batch",), ("tp",), (None,))
        return ((None,),) * r

    return M.tree_map_with_keys(dims_for, cache_tree)


def _check_cfg(model, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step was built for {cfg.name}, the model is "
                         f"{model.cfg.name}")


# ---------------------------------------------------------------------------
# the train state's placement
# ---------------------------------------------------------------------------


def state_dims(dims):
    """The dim-spec tree of the reference's train state from a parameter
    dim tree (:func:`~repro_torch.models.model.param_dims`, or the
    port's ``{name: dims}`` of :func:`~repro_torch.models.model.named_param_dims`)."""
    return {
        "params": dims,
        "opt": {"master": dims, "m": dims, "v": dims, "step": ()},
    }


def _tree_apply(fn, tree, dims):
    """``fn(leaf, dims)`` over a tree of dicts whose leaves meet their dim
    specs in ``dims`` (a spec is a tuple, so the walk stops at the tree's
    leaves)."""
    if isinstance(tree, dict):
        return {k: _tree_apply(fn, v, dims[k]) for k, v in tree.items()}
    return fn(tree, dims)


def _shape(x) -> tuple:
    return tuple(getattr(x, "shape", ()))


def state_specs(rules, state_tree, sdims):
    """Per leaf of a train-state tree (tensors, arrays or anything with a
    ``shape``), its spec on ``rules``' mesh: the reference's
    ``state_shardings``' ``PartitionSpec`` as a tuple."""
    return _tree_apply(lambda x, d: rules.spec(_shape(x), d), state_tree,
                       sdims)


def state_shardings(rules, state_tree, sdims):
    """Per leaf, its ``DTensor`` placements on ``rules``' mesh
    (:meth:`MeshRules.placements`), the reference's ``state_shardings``."""
    return _tree_apply(lambda x, d: rules.placements(_shape(x), d),
                       state_tree, sdims)


def _opt_dicts(opt: dict):
    return {k: opt[k] for k in ("master", "m", "v")}


def place_train_state(state: dict, rules, device=None) -> dict:
    """Cut a whole train state to this rank's blocks on ``rules``' mesh:
    the model's parameters in place (:func:`~repro_torch.models.model.place_model`),
    and the master and moments by the same specs, on ``device`` (None:
    the leaves' own). Every rank places the same whole state, so each
    holds the block the reference's ``state_shardings`` gives it."""
    model = state["params"]
    dims = M.named_param_dims(model.cfg)
    opt = state["opt"]
    placed = {k: {n: rules.local(t, dims[n]).to(device, copy=True)
                  for n, t in d.items()}
              for k, d in _opt_dicts(opt).items()}
    M.place_model(model, rules)
    if device is not None:
        model.to(device)
    placed["step"] = opt["step"].to(device, copy=True)
    return {"params": model, "opt": placed}


def gather_train_state(state: dict, device=None, dst=None):
    """The whole train state from every rank's blocks, a collective.

    Every rank's blocks (params, master, m, v) travel once, as one byte
    buffer (on the host over gloo, on the card over NCCL): to every rank
    (``dst`` None, an all-gather), or to the global rank ``dst`` alone (a
    gather; the other ranks get None). A receiving rank places every
    rank's blocks in the whole leaves by the rank's mesh coordinate, on
    ``device`` (the host if None). A whole state passes through as it
    is."""
    import torch.distributed as dist

    model = state["params"]
    plan = model.placement
    if plan is None:
        return state
    rules = plan.rules
    names = [n for n, _ in model.named_parameters()]
    # fp32 blocks first, so every block's bytes start aligned to its dtype
    parts = [(k, state["opt"][k]) for k in ("master", "m", "v")] + [
        ("params", dict(model.named_parameters()))]
    sh = rules.shards(tuple(rules.shape))
    wire = model.embed["w"].device if dist.get_backend(sh.group) == "nccl" \
        else "cpu"
    with torch.no_grad():
        blocks = [(k, n, d[n].detach()) for k, d in parts for n in names]
        flat = torch.cat([t.contiguous().view(-1).view(torch.uint8).to(wire)
                          for _, _, t in blocks])
    if dst is not None and dist.get_rank() != dst:
        dist.gather(flat, None, dst=dst, group=sh.group)
        return None
    bufs = [torch.empty_like(flat) for _ in range(sh.p)]
    if dst is None:
        dist.all_gather(bufs, flat, group=sh.group)
    else:
        dist.gather(flat, bufs, dst=dst, group=sh.group)
    grid = rules.mesh.mesh.cpu()
    axes = list(rules.shape)
    dev = "cpu" if device is None else device
    whole = {k: {} for k, _ in parts}
    for k, n, t in blocks:
        whole[k][n] = torch.empty([s * _split_size(rules, phys) for s, phys
                                   in zip(t.shape, plan.specs[n])],
                                  dtype=t.dtype, device=dev)
    for g in range(sh.p):
        rank = dist.get_global_rank(sh.group, g) if sh.group is not \
            dist.group.WORLD else g
        coord = dict(zip(axes, (int(c) for c in (grid == rank).nonzero()[0])))
        buf, off = bufs[g].to(dev), 0
        for k, n, t in blocks:
            nbytes = t.numel() * t.element_size()
            block = buf[off:off + nbytes].view(t.dtype).view(t.shape)
            off += nbytes
            region = whole[k][n]
            for i, phys in enumerate(plan.specs[n]):
                idx = 0
                for a in _axes(phys):
                    idx = idx * rules.shape[a] + coord[a]
                if _axes(phys):
                    region = region.narrow(i, idx * t.shape[i], t.shape[i])
            region.copy_(block)
    model_whole = M.model_from_named(model.cfg, whole["params"])
    model_whole.requires_grad_(True)
    opt = {k: whole[k] for k in ("master", "m", "v")}
    opt["step"] = state["opt"]["step"].to(dev, copy=True)
    return {"params": model_whole, "opt": opt}


def _split_size(rules, phys) -> int:
    n = 1
    for a in _axes(phys):
        n *= rules.shape[a]
    return n


def _first_replica(rules, spec) -> bool:
    """True on the rank that holds a placed leaf's first replica: index 0
    along every mesh dim the leaf is not split over."""
    used = {a for phys in spec for a in _axes(phys)}
    coord = rules.mesh.get_coordinate()
    return all(int(c) == 0 for a, c in zip(rules.shape, coord)
               if a not in used)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None,
                     rules=None) -> dict:
    """``{"params": DecoderLM, "opt": {"master", "m", "v", "step"}}``: a
    random model (:func:`~repro_torch.models.model.init_model`, on
    ``device``, ``"cuda"`` unless named) whose every leaf takes gradients,
    and its fp32 optimizer state. With ``rules`` every rank draws the same
    whole model from the seed and keeps its blocks (the master and the
    moments then start as blocks)."""
    model = M.init_model(cfg, seed, device=device).requires_grad_(True)
    if on_mesh(rules):
        M.place_model(model, rules)
    return {"params": model, "opt": init_opt_state(model)}


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    microbatches: int = 1, accum_dtype: str = "float32",
                    remat: bool = True, rules=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    is updated in place and returned, ``metrics`` holds ``loss``, ``lr``
    and ``grad_norm`` as fp32 device scalars.

    ``microbatches > 1`` accumulates the gradients of equal batch slices
    in ``accum_dtype`` and divides by the count (activation memory drops
    by the microbatch factor). ``remat`` checkpoints each layer.

    ``rules`` (a :class:`MeshRules` on a ``DeviceMesh``): the state is
    placed on that mesh, every rank passes the whole batch, and each
    microbatch's rows split over the data axes. Each data shard's loss is
    its rows' mean, its gradient taken of that mean over the data ranks,
    so the backward's data-parallel sum gives the whole batch's gradient;
    ``loss`` is the shards' losses added in shard order over their count,
    and ``grad_norm`` the whole gradient's (:func:`mesh_global_norm`).
    """
    adt = M.DTYPES[accum_dtype]
    mesh = on_mesh(rules)

    def loss_fn(model, mb, n_data):
        logits, _ = M.forward(model, mb, mode="train", remat=remat,
                              rules=rules if mesh else None)
        labels = mb["labels"]
        if n_data > 1:
            labels = M.local_rows(rules, labels)
        return M.lm_loss(logits, labels)

    def grads_of(model, params, mb, n_data=1):
        loss = loss_fn(model, mb, n_data)
        grads = torch.autograd.grad(loss if n_data == 1 else loss / n_data,
                                    params, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def train_step(state, batch):
        model = state["params"]
        _check_cfg(model, cfg)
        plan = model.placement
        if mesh != (plan is not None):
            raise ValueError(
                "on a mesh the train state must be placed on it "
                "(init_train_state(rules=) or place_train_state), and off "
                "a mesh whole" if mesh else
                "the train state is placed on a mesh: pass its rules")
        data = plan.data if mesh else None
        n_data = data.p if data is not None else 1
        params = list(model.parameters())
        if not all(p.requires_grad for p in params):
            model.requires_grad_(True)
        with torch.enable_grad():
            if microbatches == 1:
                loss, grads = grads_of(model, params, batch, n_data)
            else:
                B = batch["tokens"].shape[0]
                if B % microbatches:
                    raise ValueError(f"batch {B} does not split into "
                                     f"{microbatches} microbatches")
                acc = [torch.zeros(p.shape, dtype=adt, device=p.device)
                       for p in params]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=params[0].device)
                for i in range(microbatches):
                    mb = {k: v.reshape(microbatches, B // microbatches,
                                       *v.shape[1:])[i]
                          for k, v in batch.items()}
                    mb_loss, g = grads_of(model, params, mb, n_data)
                    torch._foreach_add_(acc, [gi.to(adt) for gi in g])
                    loss = loss + mb_loss
                grads = torch._foreach_div(acc, microbatches)
                loss = loss / microbatches
        if not mesh:
            opt, om = adamw_update(opt_cfg, grads, state["opt"], params)
            return {"params": model, "opt": opt}, {"loss": loss, **om}
        if n_data > 1:
            loss = ordered_sum(data, loss.reshape(1))[0] / n_data
        names = [n for n, _ in model.named_parameters()]
        gnorm = mesh_global_norm(
            [g.float() for g in grads],
            [_first_replica(rules, plan.specs[n]) for n in names],
            rules.shards(tuple(rules.shape)))
        opt, om = adamw_update(opt_cfg, grads, state["opt"], params,
                               gnorm=gnorm)
        return {"params": model, "opt": opt}, {"loss": loss, **om}

    return train_step


# ---------------------------------------------------------------------------
# serve (prefill + decode)
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, cache_len: int, rules=None):
    """``prefill_step(model, batch) -> (next_tok (B, 1) int32, caches)``:
    the prompt's forward (``batch["frontend"]`` too, for ``vlm`` and
    ``encdec``), a cache of ``cache_len`` allocated once and filled, and
    the greedy token after the prompt. On a mesh (``rules``) every rank
    passes the whole batch, keeps its block of the cache (a
    ``MeshCaches``) and gets the whole batch's tokens."""
    def prefill_step(model, batch):
        _check_cfg(model, cfg)
        with torch.no_grad():
            logits, caches = M.forward(model, batch, mode="prefill",
                                       cache_len=cache_len, rules=rules)
            next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return _whole_batch(rules, next_tok, batch["tokens"].shape[0]), caches

    return prefill_step


def make_serve_step(cfg: ModelConfig, rules=None):
    """One greedy decode step: ``serve_step(model, {"tokens": (B, 1),
    "caches": ..., "pos": int}) -> (next_tok (B, 1) int32, caches)``. The
    caches are updated in place; ``pos`` is the host position of the
    token. No ``frontend``: an encoder's output is read from the caches.
    On a mesh (``rules``), ``tokens`` are the whole batch's and so is the
    returned ``next_tok``: each rank's rows gathered in shard order."""
    def serve_step(model, batch):
        _check_cfg(model, cfg)
        with torch.no_grad():
            logits, caches = M.forward(
                model, {"tokens": batch["tokens"]}, mode="decode",
                caches=batch["caches"], pos_offset=batch["pos"], rules=rules)
            next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        next_tok = _whole_batch(rules, next_tok, batch["tokens"].shape[0])
        return next_tok, caches  # next_tok: (B, 1), feedable to the next step

    return serve_step


def _whole_batch(rules, rows: torch.Tensor, B: int) -> torch.Tensor:
    """The whole batch's rows from every rank's own (the data axes' shards
    in order); the rows themselves off a mesh or when B does not split."""
    data = M.row_shards(rules, B) if on_mesh(rules) else None
    return rows if data is None else gather_cat(data, rows, 0)
