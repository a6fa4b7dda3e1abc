"""Train, prefill and serve step builders.

The train step takes the train state (the model and its optimizer state)
and a batch, differentiates the whole parameter tree with autograd
(optionally over microbatches, each layer rematerialised), and applies
AdamW in place; its metrics stay on the device. A serve step takes the
model and a batch and returns the next token as a device tensor, so a loop
of steps feeds each token to the next without reading anything back.

The prefill and serve steps take ``rules`` (a
:class:`~repro_torch.distributed.sharding.MeshRules` on a ``DeviceMesh``)
as the reference's do: every rank calls the step with the whole batch,
runs its own rows (split over the data axes) against its own block of the
cache, and returns the whole batch's next tokens, gathered in shard order.
The placement tables below give the batch's and the cache's dim specs; the
train step has no mesh form yet (ROADMAP A.9.3b).
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import gather_cat
from repro_torch.distributed.sharding import on_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state)

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
# train
# ---------------------------------------------------------------------------


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """``{"params": DecoderLM, "opt": {"master", "m", "v", "step"}}``: a
    random model (:func:`~repro_torch.models.model.init_model`, on
    ``device``, ``"cuda"`` unless named) whose every leaf takes gradients,
    and its fp32 optimizer state."""
    model = M.init_model(cfg, seed, device=device).requires_grad_(True)
    return {"params": model, "opt": init_opt_state(model)}


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    microbatches: int = 1, accum_dtype: str = "float32",
                    remat: bool = True):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    is updated in place and returned, ``metrics`` holds ``loss``, ``lr``
    and ``grad_norm`` as fp32 device scalars.

    ``microbatches > 1`` accumulates the gradients of equal batch slices
    in ``accum_dtype`` and divides by the count (activation memory drops
    by the microbatch factor). ``remat`` checkpoints each layer.
    """
    adt = M.DTYPES[accum_dtype]

    def loss_fn(model, mb):
        logits, _ = M.forward(model, mb, mode="train", remat=remat)
        return M.lm_loss(logits, mb["labels"])

    def grads_of(model, params, mb):
        loss = loss_fn(model, mb)
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def train_step(state, batch):
        model = state["params"]
        _check_cfg(model, cfg)
        params = list(model.parameters())
        if not all(p.requires_grad for p in params):
            model.requires_grad_(True)
        with torch.enable_grad():
            if microbatches == 1:
                loss, grads = grads_of(model, params, batch)
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
                    mb_loss, g = grads_of(model, params, mb)
                    torch._foreach_add_(acc, [gi.to(adt) for gi in g])
                    loss = loss + mb_loss
                grads = torch._foreach_div(acc, microbatches)
                loss = loss / microbatches
        opt, om = adamw_update(opt_cfg, grads, state["opt"], params)
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
