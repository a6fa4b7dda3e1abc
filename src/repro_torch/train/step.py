"""Train, prefill and serve step builders.

The train step takes the train state (the model and its optimizer state)
and a batch, differentiates the whole parameter tree with autograd
(optionally over microbatches, each layer rematerialised), and applies
AdamW in place; its metrics stay on the device. A serve step takes the
model and a batch and returns the next token as a device tensor, so a loop
of steps feeds each token to the next without reading anything back. There
is no ``rules`` argument: the LM mesh is a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state)


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


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    """``prefill_step(model, batch) -> (next_tok (B, 1) int32, caches)``:
    the prompt's forward (``batch["frontend"]`` too, for ``vlm`` and
    ``encdec``), a cache of ``cache_len`` allocated once and filled, and
    the greedy token after the prompt."""
    def prefill_step(model, batch):
        _check_cfg(model, cfg)
        with torch.no_grad():
            logits, caches = M.forward(model, batch, mode="prefill",
                                       cache_len=cache_len)
            next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, caches

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: ``serve_step(model, {"tokens": (B, 1),
    "caches": ..., "pos": int}) -> (next_tok (B, 1) int32, caches)``. The
    caches are updated in place; ``pos`` is the host position of the
    token. No ``frontend``: an encoder's output is read from the caches."""
    def serve_step(model, batch):
        _check_cfg(model, cfg)
        with torch.no_grad():
            logits, caches = M.forward(
                model, {"tokens": batch["tokens"]}, mode="decode",
                caches=batch["caches"], pos_offset=batch["pos"])
            next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, caches  # next_tok: (B, 1), feedable to the next step

    return serve_step
