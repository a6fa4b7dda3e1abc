"""Assigned input shapes and abstract input specs for the dry run.

LM transformer shapes are seq_len × global_batch. ``decode_*`` / ``long_*``
run the serve step (one new token against a seq_len KV cache), not the
train step. ``long_500k`` runs only for sub-quadratic architectures
(cfg.subquadratic) per the task rule — skips are recorded, not silent.

The port of the JAX package's ``configs/shapes.py``: the specs are meta
tensors (shape and dtype, no storage) where the reference has
``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import DTYPES, cache_specs, tree_map


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """(supported, reason-if-not) for an (arch × shape) cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: long_500k skipped (task rule)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: Shape, device="meta") -> dict:
    """The step's inputs for the cell, as empty tensors on ``device``
    (meta: shapes and dtypes only).

    train  → {tokens, labels[, frontend]}
    prefill→ {tokens[, frontend]}
    decode → {tokens(B,1), caches, pos} with a seq_len-long cache; ``pos``
    is an int32 scalar, as the reference's (the port's serve step takes
    the position as a host integer, so a caller hands it the value)
    """
    B = shape.global_batch
    S = shape.seq_len
    i32 = torch.int32
    dtype = DTYPES[cfg.dtype]

    def empty(shp, dt):
        return torch.empty(shp, dtype=dt, device=device)

    if shape.kind in ("train", "prefill"):
        specs = {}
        s_text = S
        if cfg.family == "vlm":
            s_text = S - cfg.frontend_len
        if cfg.family in ("vlm", "encdec"):
            specs["frontend"] = empty((B, cfg.frontend_len, cfg.d_model),
                                      dtype)
        specs["tokens"] = empty((B, s_text), i32)
        if shape.kind == "train":
            specs["labels"] = empty((B, s_text), i32)
        return specs
    if shape.kind == "decode":
        return {
            "tokens": empty((B, 1), i32),
            "caches": tree_map(lambda s: empty(s.shape, s.dtype),
                               cache_specs(cfg, B, S)),
            "pos": empty((), i32),
        }
    raise ValueError(shape.kind)
