"""The reference's end-to-end system tests (``tests/test_system.py``'s
paper workload and blob purity) on the port, on the CPU, each held to the
reference's selections. The LM halves of that file have their twins in
``tests/test_torch_train_loop.py`` and ``tests/test_torch_lm_serve.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax.numpy as jnp  # noqa: E402

from repro.core import EvalConfig as JCfg  # noqa: E402
from repro.core import ExemplarClustering as JEC  # noqa: E402
from repro.core import fit_exemplar_clustering as jfit  # noqa: E402
from repro.core import greedy as jgreedy  # noqa: E402
from repro_torch.core import (EvalConfig, ExemplarClustering,  # noqa: E402
                              fit_exemplar_clustering, greedy)
from repro_torch.data.synthetic import blobs, uniform_problem  # noqa: E402

#: tests/test_kernel_parity.py's per-policy bands, on max(1, |reference|).
POLICY_TOLS = {"fp32": 1e-5, "fp16": 1e-2}


def _same(got, ref, policy="fp32"):
    assert got.indices == ref.indices
    assert got.evaluations == ref.evaluations
    assert abs(got.value - ref.value) <= POLICY_TOLS[policy] * max(
        1.0, abs(ref.value))


def test_paper_workload_end_to_end():
    """The paper's §V setup, scaled down: uniform data, greedy selection
    chunked under a memory budget; the ``cuda`` backend (the kernels' plain
    versions here) selects what the ``torch`` backend selects; fp16 within
    5e-3 of fp32 (the paper's FP16 question). Every run equals the
    reference's at the same policy."""
    V = uniform_problem(n=1500, dim=100, seed=0)
    budget = 32 * 2**20
    res = greedy(ExemplarClustering(
        V, EvalConfig(memory_budget_bytes=budget), device="cpu"), 10)
    assert len(res.indices) == 10 and res.value > 0
    _same(res, jgreedy(JEC(jnp.asarray(V),
                           JCfg(memory_budget_bytes=budget)), 10))
    res_k = greedy(ExemplarClustering(V, EvalConfig(backend="cuda"),
                                      device="cpu"), 10)
    assert res_k.indices == res.indices
    _same(res_k, jgreedy(JEC(jnp.asarray(V)), 10))
    res16 = greedy(ExemplarClustering(V, EvalConfig(policy="fp16"),
                                      device="cpu"), 10)
    assert abs(res16.value - res.value) / res.value < 5e-3
    _same(res16, jgreedy(JEC(jnp.asarray(V), JCfg(policy="fp16")), 10),
          "fp16")


def test_clustering_recovers_blob_structure():
    X, labels = blobs(n=1200, dim=16, centers=6, spread=0.08, seed=4)
    model = fit_exemplar_clustering(X, k=6, device="cpu")
    got = model.assign(X)
    # purity: every found cluster dominated by one true blob
    purity = sum(np.bincount(labels[got == c]).max()
                 for c in range(6)) / len(X)
    assert purity > 0.95
    ref = jfit(X, k=6)
    assert model.exemplar_indices == ref.exemplar_indices
    np.testing.assert_array_equal(got, ref.assign(X))
    _same(model.result, ref.result)
