"""Clustering front-end: exemplar selection → cluster assignment.

The paper frames exemplar clustering as "select S, then partition the data
space by nearest exemplar". This module is the user-facing API.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import distances as dist_mod
from repro_torch.core.engine import OptResult
from repro_torch.core.evaluator import EvalConfig
from repro_torch.core.functions import ExemplarClustering
from repro_torch.core.optimizers import OPTIMIZERS
from repro_torch.core.precision import resolve as resolve_policy


@dataclasses.dataclass
class ExemplarModel:
    """Fitted exemplar clustering model."""

    exemplar_indices: list[int]
    exemplars: np.ndarray
    value: float
    result: OptResult
    cfg: EvalConfig
    device: torch.device

    def assign(self, X) -> np.ndarray:
        """Nearest-exemplar label for each row of X (on the model's device
        when X is numpy, where X lies when it is a tensor)."""
        if not isinstance(X, torch.Tensor):
            X = torch.as_tensor(np.asarray(X), device=self.device)
        pair = dist_mod.resolve_pairwise(self.cfg.distance)
        D = pair(X, torch.as_tensor(self.exemplars, device=X.device),
                 resolve_policy(self.cfg.policy))
        return torch.argmin(D, dim=1).cpu().numpy()


def fit_exemplar_clustering(
    X,
    k: int,
    optimizer: str = "greedy",
    cfg: EvalConfig = EvalConfig(),
    e0=None,
    device=None,
    **opt_kwargs,
) -> ExemplarModel:
    """Select k exemplars from X by submodular maximization and return a
    model. Numpy ``X`` goes to ``device`` (``"cuda"`` unless named)."""
    f = ExemplarClustering(X, cfg, e0=e0, device=device)
    try:
        opt = OPTIMIZERS[optimizer]
    except KeyError as e:
        raise ValueError(f"unknown optimizer {optimizer!r}; "
                         f"options {sorted(OPTIMIZERS)}") from e
    res = opt(f, k, **opt_kwargs)
    ex = f.V.cpu().numpy()[res.indices]
    return ExemplarModel(res.indices, ex, res.value, res, cfg, f.device)
