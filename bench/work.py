"""The work a call needs, counted from its shapes, and the least time the
card could take for it.

The count is the algorithm's, whatever kernel runs it: the distance
products of the Gram identity, the fp32 epilogue operations on each cell of
the distance matrix, each input read once and each output written once. The
bound is the largest of the three at the data-sheet peaks of
``peaks.json``; a share of it cannot pass 100 %.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
#: Bytes an element of the payload takes at each precision policy.
ITEMSIZE = {"fp32": 4, "bf16": 2, "fp16": 2}
#: fp32 operations of the epilogue per cell of the distance matrix: an
#: exemplar cell takes the norm sum, the product's scale and the min; a
#: gain cell the norm sum, the scale, the difference, the relu and the sum.
EXEMPLAR_CELL_OPS = 3
GAIN_CELL_OPS = 5


@dataclasses.dataclass(frozen=True)
class Work:
    policy: str
    flops: float = 0.0
    cell_ops: float = 0.0
    bytes: float = 0.0

    def times(self, count: int) -> "Work":
        return Work(self.policy, self.flops * count, self.cell_ops * count,
                    self.bytes * count)

    def __add__(self, other: "Work") -> "Work":
        if other.policy != self.policy:
            raise ValueError("cannot add work of two precision policies")
        return Work(self.policy, self.flops + other.flops,
                    self.cell_ops + other.cell_ops, self.bytes + other.bytes)


def multiset(n: int, l: int, k: int, d: int, policy: str) -> Work:
    """One evaluation of l sets of k exemplars against n points of d
    features: the n × l·k distance products, 2·n·l·k·d FLOPs."""
    s = ITEMSIZE[policy]
    cells = n * l * k
    return Work(policy, 2.0 * cells * d, EXEMPLAR_CELL_OPS * cells,
                n * d * s + l * k * d * s + 4 * l + 4 * n + 4 * l)


def greedy(n: int, k: int, d: int, policy: str) -> Work:
    """One greedy selection of k from all n candidates: round t scores the
    n − t candidates not yet taken against the n points,
    Σ_t 2·n·(n − t)·d FLOPs."""
    s = ITEMSIZE[policy]
    w = Work(policy)
    for t in range(k):
        m = n - t
        w = w + Work(policy, 2.0 * n * m * d, GAIN_CELL_OPS * n * m,
                     n * d * s + d * s + 4 * n + 4 * n + 4 * m)
    return w


def bound_s(work: Work, kind: str) -> Optional[float]:
    """Least seconds the card named ``kind`` could take for ``work``; None
    where ``peaks.json`` has no peak for that card or policy."""
    peaks = PEAKS.get(kind)
    if peaks is None or work.policy not in peaks["products_flops_per_s"]:
        return None
    return max(work.flops / peaks["products_flops_per_s"][work.policy],
               work.cell_ops / peaks["fp32_ops_per_s"],
               work.bytes / peaks["hbm_bytes_per_s"])

