"""Parameter helpers: the reference's initialiser and its tree counts.

The port draws its own random model from an explicit ``torch.Generator``;
it does not reproduce the JAX package's bits (parity tests carry the JAX
parameters across, :func:`repro_torch.convert.lm_params_from_arrays`), but
it does reproduce their distribution, fan-in rule included. There are no
dim specs here: sharding belongs to the LM mesh.
"""
from __future__ import annotations

import math

import torch


def fan_in(shape) -> int:
    """The reference's fan-in: ``shape[0]`` for a vector or a 3-D or larger
    weight, the product of all but the last dim for a matrix. So an MoE
    expert stack ``(E, d, d_ff)`` is scaled by 1/√E, as in the reference."""
    f = shape[0] if len(shape) >= 1 else 1
    if len(shape) >= 2:
        f = math.prod(shape[:-1]) if len(shape) == 2 else shape[0]
    return f


def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None,
               device=None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, drawn in float32 on ``device``
    (the generator's device unless named) and cast to ``dtype``."""
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in(shape), 1))
    w = torch.empty(tuple(shape), dtype=torch.float32,
                    device=gen.device if device is None else device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * s).to(dtype)


def count_params(model) -> int:
    """Elements over every parameter of a module (or tensors of a dict)."""
    return sum(t.numel() for t in _leaves(model))


def tree_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(model))


def _leaves(x):
    if isinstance(x, torch.nn.Module):
        return list(x.parameters())
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return [x]
