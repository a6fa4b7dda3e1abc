"""Carry the JAX package's state across to the port.

The JAX package's "parameters" are its data and configuration: the ground
set V, the auxiliary vector e0, the ``EvalConfig`` fields, a packed multiset
and a ``(vec, aux)`` cache. These functions take them as numpy arrays and
plain values (what ``np.asarray`` and ``dataclasses.asdict`` give on the JAX
side) and build the port's objects on a device — ``"cuda"`` unless the
caller names another. A streaming engine's state (the reference's
``SieveState``) carries across the same way, field by field.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.evaluator import EvalConfig
from repro_torch.core.functions import FUNCTIONS, ExemplarClustering, SubmodularFunction
from repro_torch.core.multiset import PackedMultiset, resolve_device
from repro_torch.core.streaming import SieveState
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import DTYPES, DecoderLM, tree_map, cache_specs

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


def function_from_arrays(name: str, V: np.ndarray,
                         e0: Optional[np.ndarray] = None,
                         cfg: "EvalConfig | dict" = EvalConfig(), device=None,
                         **params) -> SubmodularFunction:
    """The zoo function registered as ``name`` over numpy ``V``; ``params``
    are its constructor's own (``lam`` for graph cut, ``sat`` for saturated
    coverage)."""
    if name not in FUNCTIONS:
        raise ValueError(f"unknown function {name!r}; registered: "
                         f"{sorted(FUNCTIONS)}")
    if isinstance(cfg, dict):
        cfg = config_from_fields(cfg)
    return FUNCTIONS[name](np.asarray(V), cfg,
                           e0=None if e0 is None else np.asarray(e0),
                           device=device, **params)


def function_like(f, device=None) -> SubmodularFunction:
    """The port's counterpart of a JAX zoo function object ``f``: read
    through its ``spec``, ``V``, ``e0`` and ``cfg`` (numpy and
    ``dataclasses.asdict``; nothing of JAX is imported here)."""
    import dataclasses

    params = {}
    if f.spec.name == "graph_cut":
        params["lam"] = f.spec.lam
    elif f.spec.name == "saturated_coverage":
        params["sat"] = f.spec.sat
    return function_from_arrays(
        f.spec.name, np.array(f.V), None if f.e0 is None
        else np.array(f.e0), dataclasses.asdict(f.cfg), device=device,
        **params)


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


def sieve_state_from_arrays(fields, device=None) -> SieveState:
    """A :class:`~repro_torch.core.streaming.SieveState` from the JAX
    package's, given as a mapping of its field names to numpy arrays
    (``{k: np.asarray(v) for k, v in state._asdict().items()}``) — an
    engine's table carried across mid-stream. Dtypes are the port's:
    float32 caches and scalars, int32 exponents, sizes, members and
    evaluation count, bool ``active``."""
    dev = resolve_device(device)
    dtypes = {"caches": torch.float32, "slot_exp": torch.int32,
              "active": torch.bool, "sizes": torch.int32,
              "members": torch.int32, "m_seen": torch.float32,
              "lb": torch.float32, "evals": torch.int32}
    missing = set(dtypes) - set(fields)
    if missing:
        raise ValueError(f"SieveState fields missing: {sorted(missing)}")
    return SieveState(**{
        name: torch.as_tensor(np.array(fields[name]), dtype=dt, device=dev)
        for name, dt in dtypes.items()})


def tensor_from_array(a, device=None, dtype=None) -> torch.Tensor:
    """A numpy array (a bfloat16 one too: ``ml_dtypes``' has no torch
    counterpart in numpy, so its bits go across as int16) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=resolve_device(device),
                dtype=t.dtype if dtype is None else dtype)


def lm_params_from_arrays(cfg: ModelConfig, tree, device=None) -> DecoderLM:
    """The port's :class:`~repro_torch.models.model.DecoderLM` from the
    reference's ``init_model`` parameter tree as numpy arrays: ``embed``,
    ``final_norm``, ``head`` (untied) and ``groups``, whose leaves are
    stacked ``(count, …)`` over a group's layers. Leaves take the config's
    dtype; shapes are checked against the port's own."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    out = tree_map(lambda a: tensor_from_array(a, dev, dtype), tree)
    for key, g in out["groups"].items():
        count = next(_leaves(g)).shape[0]
        out["groups"][key] = [tree_map(lambda t, i=i: t[i], g)
                              for i in range(count)]
    return DecoderLM(cfg, out)


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    else:
        yield x


def lm_caches_from_arrays(cfg: ModelConfig, tree, device=None) -> dict:
    """A decode-cache tree of the reference (``forward``'s prefill or
    decode caches as numpy arrays, stacked ``(count, B, buf, Hk, hd)``)
    as the port's, checked against :func:`cache_specs` at its batch and
    its longest buffer."""
    dev = resolve_device(device)
    out = tree_map(lambda a: tensor_from_array(a, dev), tree)
    leaves = list(_leaves(out))
    want = cache_specs(cfg, leaves[0].shape[1],
                       max(t.shape[2] for t in leaves))
    got = tree_map(lambda t: (tuple(t.shape), t.dtype), out)
    spec = tree_map(lambda s: (tuple(s.shape), s.dtype), want)
    if got != spec:
        raise ValueError(f"cache tree {got} does not match cache_specs "
                         f"{spec}")
    return out
