"""Synthetic data: clustered vectors (the paper's workload).

The paper evaluates on randomly generated problems (§V). ``blobs`` gives the
clustered version (so selection quality is measurable); ``uniform_problem``
matches the paper's setting. Both draw from ``np.random.default_rng(seed)``
exactly as the JAX package's generators do, so a seed names the same data in
both packages.
"""
from __future__ import annotations

import numpy as np


def uniform_problem(n: int, dim: int, seed: int = 0,
                    low: float = 0.0, high: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(low, high, size=(n, dim)).astype(np.float32)


def blobs(n: int, dim: int, centers: int = 8, spread: float = 0.15,
          seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-1, 1, size=(centers, dim)).astype(np.float32)
    labels = rng.integers(0, centers, size=n)
    X = mu[labels] + rng.normal(0, spread, size=(n, dim)).astype(np.float32)
    return X.astype(np.float32), labels
