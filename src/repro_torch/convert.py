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
from repro_torch.models import model as M
from repro_torch.models.model import DTYPES, DecoderLM, cache_specs, tree_map

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
    ``final_norm``, ``head`` (untied), ``dec_pos`` (encdec) and
    ``groups``, whose leaves are stacked ``(count, …)`` over a group's
    layers. Each leaf takes its spec's dtype (the config's, or fp32 for
    ``a_log``); shapes are checked against the port's own."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]

    def unstack(g):
        count = M.tree_leaves(g)[0][1].shape[0]
        return [tree_map(lambda a, i=i: a[i], g) for i in range(count)]

    def leaf(s, a, path):
        return tensor_from_array(a, dev, M.leaf_dtype(s, dtype))

    tree = {**tree, "groups": {k: unstack(g)
                               for k, g in tree["groups"].items()}}
    return DecoderLM(cfg, M.spec_map(leaf, M.param_specs(cfg), tree))


def _cache_dims(tree) -> tuple:
    """(B, cache_len) of a cache tree: the batch of its leaves, the
    longest self-attention buffer (1 where there is none: the recurrent
    states do not depend on it)."""
    if "enc_out" in tree:
        B = tree["enc_out"].shape[0]
    else:
        B = M.tree_leaves(tree)[0][1].shape[1]
    bufs = [g["attn"]["k"].shape[2] for k, g in tree.items()
            if k != "enc_out" and isinstance(g, dict) and "attn" in g]
    return B, max(bufs, default=1)


def lm_caches_from_arrays(cfg: ModelConfig, tree, device=None) -> dict:
    """A decode-cache tree of the reference (``forward``'s prefill or
    decode caches as numpy arrays: dicts of stacked ``(count, B, …)``
    leaves, the recurrent states as tuples, whisper's ``enc_out``) as the
    port's, checked against :func:`cache_specs` at the tree's batch and
    its longest self-attention buffer."""
    dev = resolve_device(device)
    out = tree_map(lambda a: tensor_from_array(a, dev), tree)
    want = cache_specs(cfg, *_cache_dims(out))
    got = tree_map(lambda t: (tuple(t.shape), t.dtype), out)
    spec = tree_map(lambda s: (tuple(s.shape), s.dtype), want)
    if got != spec:
        raise ValueError(f"cache tree {got} does not match cache_specs "
                         f"{spec}")
    return out
