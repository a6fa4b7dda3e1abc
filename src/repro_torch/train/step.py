"""Prefill and serve step builders: the port's greedy serving loop.

A step takes the model and a batch and returns the next token as a device
tensor, so a loop of steps feeds each token to the next without reading
anything back. The train step (autograd) is the training slice's; there is
no ``rules`` argument, since the LM mesh is a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def _check_cfg(model, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step was built for {cfg.name}, the model is "
                         f"{model.cfg.name}")


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
