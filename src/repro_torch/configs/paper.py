"""The paper's own workload: exemplar clustering evaluation problem sizes.

Paper §V-A: N=50000, l=5000, k=10, dim=100; N ∈ [1000, 400000],
l ∈ [1000, 40000], k ∈ [10, 500].
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperProblem:
    n: int = 50_000
    l: int = 5_000
    k: int = 10
    dim: int = 100


CONFIG = PaperProblem()
SWEEPS = {
    "N": [int(x) for x in range(1000, 400001, 28500)],   # 15 values
    "l": [int(x) for x in range(1000, 40001, 2785)],
    "k": [int(x) for x in range(10, 501, 35)],
}
