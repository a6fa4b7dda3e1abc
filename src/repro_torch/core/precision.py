"""Floating-point precision policies for submodular evaluation.

The paper studies FP16 vs FP32 evaluation on GPUs (§V-B). Four policies:
fp32, bf16 and fp16 round the payload (V, S) to ``compute_dtype`` and
accumulate every contraction and reduction in float32; ``fp16_strict`` is the
paper-faithful all-FP16 path that accumulates in float16 as well.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Compute/accumulate dtype pair for distance evaluation.

    Attributes:
      name: human-readable policy name.
      compute_dtype: dtype in which payload (V, S) is stored and multiplied.
      accum_dtype: dtype for contraction accumulation and reductions.
    """

    name: str
    compute_dtype: torch.dtype
    accum_dtype: torch.dtype

    @property
    def itemsize(self) -> int:
        return self.compute_dtype.itemsize


FP32 = PrecisionPolicy("fp32", torch.float32, torch.float32)
BF16 = PrecisionPolicy("bf16", torch.bfloat16, torch.float32)
FP16 = PrecisionPolicy("fp16", torch.float16, torch.float32)
# Paper-faithful FP16: accumulate in fp16 as well (the CUDA kernel's native path).
FP16_STRICT = PrecisionPolicy("fp16_strict", torch.float16, torch.float16)

POLICIES = {p.name: p for p in (FP32, BF16, FP16, FP16_STRICT)}


def resolve(policy: "str | PrecisionPolicy") -> PrecisionPolicy:
    if isinstance(policy, PrecisionPolicy):
        return policy
    try:
        return POLICIES[policy]
    except KeyError as e:
        raise ValueError(
            f"unknown precision policy {policy!r}; options: {sorted(POLICIES)}"
        ) from e
