"""Carry the JAX package's state across to the port.

The JAX package's "parameters" are its data and configuration: the ground
set V, the auxiliary vector e0, the ``EvalConfig`` fields, a packed multiset
and a ``(vec, aux)`` cache. These functions take them as numpy arrays and
plain values (what ``np.asarray`` and ``dataclasses.asdict`` give on the JAX
side) and build the port's objects on a device — ``"cuda"`` unless the
caller names another.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.evaluator import EvalConfig
from repro_torch.core.functions import ExemplarClustering
from repro_torch.core.multiset import PackedMultiset, resolve_device

#: The JAX package's evaluation backends and their counterparts here.
BACKENDS = {"jnp": "torch", "naive": "naive", "pallas": "cuda",
            "pallas_interpret": "cuda"}


def config_from_fields(fields: dict) -> EvalConfig:
    """An :class:`EvalConfig` from ``dataclasses.asdict`` of the JAX one:
    ``"jnp"`` → ``"torch"``, ``"pallas*"`` → ``"cuda"``. A policy object
    (a dict after ``asdict``) is named by its ``name``."""
    fields = dict(fields)
    try:
        fields["backend"] = BACKENDS[fields.get("backend", "jnp")]
    except KeyError as e:
        raise ValueError(f"unknown JAX backend {fields['backend']!r}; "
                         f"options {sorted(BACKENDS)}") from e
    policy = fields.get("policy", "fp32")
    if isinstance(policy, dict):
        fields["policy"] = policy["name"]
    return EvalConfig(**fields)


def exemplar_from_arrays(V: np.ndarray, e0: Optional[np.ndarray] = None,
                         cfg: "EvalConfig | dict" = EvalConfig(),
                         device=None) -> ExemplarClustering:
    """An :class:`ExemplarClustering` over numpy ``V`` (and ``e0``)."""
    if isinstance(cfg, dict):
        cfg = config_from_fields(cfg)
    return ExemplarClustering(np.asarray(V), cfg,
                              e0=None if e0 is None else np.asarray(e0),
                              device=device)


def packed_from_arrays(data: np.ndarray, lengths: np.ndarray,
                       device=None) -> PackedMultiset:
    """A :class:`PackedMultiset` from its ``(l, k, d)`` payload and lengths."""
    dev = resolve_device(device)
    return PackedMultiset(
        torch.as_tensor(np.asarray(data), device=dev),
        torch.as_tensor(np.asarray(lengths, dtype=np.int32), device=dev))


def cache_from_arrays(vec: np.ndarray, aux: float = 0.0, device=None):
    """A ``(vec, aux)`` cache: (n,) float32 vector and float32 scalar."""
    dev = resolve_device(device)
    return (torch.as_tensor(np.array(vec, dtype=np.float32), device=dev),
            torch.tensor(float(np.asarray(aux)), dtype=torch.float32,
                         device=dev))
