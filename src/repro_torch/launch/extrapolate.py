"""Depth-scaled cost extrapolation — exact FLOP/byte/collective counts.

The port of the JAX package's ``launch/extrapolate.py``. Costs are linear
in the layer counts:

    cost(model) = a + Σ_kind  n_kind · b_kind

where ``a`` is the depth-independent part (embedding, head, loss, optimizer
state for non-layer params) and ``b_kind`` the per-layer cost of each layer
kind. Running 2–3 *shallow* variants with known layer-count vectors gives
a full-rank linear system; solving it and evaluating at the real counts
reproduces the full-depth numbers. The reference needs it because XLA's
``cost_analysis`` counts a scanned layer once; the port's meta run
dispatches every layer, so its full-depth counts are exact already and
the extrapolation is a check of the linear model and a faster estimate
(held equal to the full-depth count in ``tests/test_torch_launch.py``).
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np

from repro_torch.models.config import ModelConfig


def layer_kind_counts(cfg: ModelConfig) -> dict[str, int]:
    counts = dict(Counter(cfg.layer_types()))
    if cfg.encoder_layers:
        counts["enc_attn"] = cfg.encoder_layers
        counts = {"enc_attn": cfg.encoder_layers, "dec_attn": cfg.num_layers}
    return counts


def depth_variants(cfg: ModelConfig) -> list[tuple[ModelConfig, dict[str, int]]]:
    """Shallow variants spanning the per-kind count space."""
    R = dataclasses.replace
    fam = cfg.family
    if fam == "encdec":
        vs = [R(cfg, num_layers=1, encoder_layers=1),
              R(cfg, num_layers=2, encoder_layers=2),
              R(cfg, num_layers=1, encoder_layers=2)]
    elif fam == "ssm":  # xlstm: mlstm + slstm kinds
        vs = [R(cfg, num_layers=1, slstm_period=0),
              R(cfg, num_layers=2, slstm_period=0),
              R(cfg, num_layers=2, slstm_period=2)]  # 1 mlstm + 1 slstm
    elif fam == "hybrid":  # hymba: full + sliding attention kinds
        vs = [R(cfg, num_layers=1, full_attn_layers=()),
              R(cfg, num_layers=2, full_attn_layers=()),
              R(cfg, num_layers=2, full_attn_layers=(0,))]
    elif cfg.local_global_period:  # gemma: local + global kinds
        # period > num_layers → all-local variants (keeps the same layer kind)
        vs = [R(cfg, num_layers=1, local_global_period=99),
              R(cfg, num_layers=2, local_global_period=99),
              R(cfg, num_layers=2, local_global_period=2)]
    else:  # uniform dense / moe / vlm
        vs = [R(cfg, num_layers=1), R(cfg, num_layers=2)]
    return [(v, layer_kind_counts(v)) for v in vs]


def solve_and_extrapolate(
    variant_counts: list[dict[str, int]],
    variant_values: list[float],
    real_counts: dict[str, int],
) -> float:
    """Least-squares solve of cost = a + Σ n_k·b_k, evaluated at real counts."""
    kinds = sorted({k for c in variant_counts for k in c} | set(real_counts))
    A = np.array([[1.0] + [float(c.get(k, 0)) for k in kinds]
                  for c in variant_counts])
    y = np.array(variant_values, dtype=np.float64)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    x = np.array([1.0] + [float(real_counts.get(k, 0)) for k in kinds])
    return float(coef @ x)
