"""The port's multiset evaluation engine against the JAX package's, on CPU.

``evaluate_multiset`` on every backend (``torch``, ``naive``, and ``cuda``,
whose kernels run their plain versions on CPU tensors) × fused/two_pass ×
flat/loop against the JAX ``jnp`` backend; ``work_matrix``; chunking and
n-blocking; and the ``ExemplarClustering`` multiset interface. Values are
sums of O(2d) distances, so the fp32 band is applied relative to
max(1, |ref|).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import EvalConfig as JCfg  # noqa: E402
from repro.core import ExemplarClustering as JEC  # noqa: E402
from repro.core import evaluate_multiset as jeval  # noqa: E402
from repro.core import work_matrix as jwork  # noqa: E402
from repro.core.multiset import PackedMultiset as JPacked  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import EvalConfig, ExemplarClustering  # noqa: E402
from repro_torch.core import evaluate_multiset, work_matrix  # noqa: E402

BAND = {"fp32": 1e-5, "bf16": 5e-2, "fp16": 1e-2}


def _band(got, ref, band):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    err = float(np.max(np.abs(got - ref)))
    assert err <= band * max(1.0, float(np.max(np.abs(ref)))), err


def _problem(n=137, l=13, k=5, d=19, seed=11):
    rng = np.random.default_rng(seed)
    V = (rng.normal(size=(n, d)) + 2.0).astype(np.float32)
    S = (rng.normal(size=(l, k, d)) + 2.0).astype(np.float32)
    lengths = rng.integers(1, k + 1, size=l).astype(np.int32)
    return V, S, lengths


def _run_both(cfg_fields, V, S, lengths, jnp_ref=True):
    """Port with ``cfg_fields`` vs the JAX package with the same fields on
    the jnp backend."""
    cfg = EvalConfig(**cfg_fields)
    got = evaluate_multiset(torch.from_numpy(V),
                            convert.packed_from_arrays(S, lengths, "cpu"), cfg)
    jfields = dict(cfg_fields, backend="jnp") if jnp_ref else cfg_fields
    ref = jeval(jnp.asarray(V), JPacked(jnp.asarray(S), jnp.asarray(lengths)),
                JCfg(**jfields))
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("variant", ["flat", "loop"])
@pytest.mark.parametrize("mode", ["fused", "two_pass"])
@pytest.mark.parametrize("backend", ["torch", "naive", "cuda"])
def test_evaluate_multiset_matches_reference(backend, mode, variant):
    V, S, lengths = _problem()
    got, ref = _run_both(dict(backend=backend, mode=mode,
                              kernel_variant=variant), V, S, lengths)
    assert got.dtype == np.float32
    _band(got, ref, BAND["fp32"])


@pytest.mark.parametrize("policy", sorted(BAND))
@pytest.mark.parametrize("distance", ["sqeuclidean", "rbf", "cosine",
                                      "manhattan"])
def test_evaluate_multiset_distances_and_policies(distance, policy):
    V, S, lengths = _problem(n=65, l=9, k=3, d=17, seed=3)
    if distance == "rbf":
        V, S = V * 0.2, S * 0.2
    got, ref = _run_both(dict(distance=distance, policy=policy), V, S,
                         lengths)
    _band(got, ref, BAND[policy])


def test_cuda_backend_refuses_non_gram_distances():
    V, S, lengths = _problem(n=20, l=3, k=2, d=4)
    with pytest.raises(ValueError, match="cuda backend supports"):
        evaluate_multiset(torch.from_numpy(V),
                          convert.packed_from_arrays(S, lengths, "cpu"),
                          EvalConfig(backend="cuda", distance="cosine"))


@pytest.mark.parametrize("extra", [dict(memory_budget_bytes=7000),
                                   dict(n_block=32),
                                   dict(memory_budget_bytes=8000,
                                        backend="cuda", mode="two_pass")])
def test_chunked_and_blocked_evaluation(extra):
    V, S, lengths = _problem()
    fields = dict(extra)
    got = evaluate_multiset(torch.from_numpy(V),
                            convert.packed_from_arrays(S, lengths, "cpu"),
                            EvalConfig(**fields))
    fields["backend"] = "jnp"
    ref = jeval(jnp.asarray(V), JPacked(jnp.asarray(S), jnp.asarray(lengths)),
                JCfg(**fields))
    _band(got.numpy(), np.asarray(ref), BAND["fp32"])


def test_work_matrix_matches_reference():
    V, S, lengths = _problem(n=97, l=11, k=6, d=17, seed=13)
    for budget in (None, 5000):
        got = work_matrix(torch.from_numpy(V),
                          convert.packed_from_arrays(S, lengths, "cpu"),
                          EvalConfig(mode="two_pass",
                                     memory_budget_bytes=budget))
        ref = jwork(jnp.asarray(V), JPacked(jnp.asarray(S),
                                            jnp.asarray(lengths)),
                    JCfg(mode="two_pass", memory_budget_bytes=budget))
        assert got.shape == (11, 97)
        _band(got.numpy() * 97, np.asarray(ref) * 97, BAND["fp32"])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_exemplar_clustering_multiset_interface(backend):
    rng = np.random.default_rng(21)
    V = rng.normal(size=(120, 9)).astype(np.float32)
    e0 = rng.normal(size=9).astype(np.float32) * 0.1
    jbackend = {"torch": "jnp", "cuda": "pallas_interpret"}[backend]
    f = convert.exemplar_from_arrays(V, e0, {"backend": jbackend}, "cpu")
    jf = JEC(jnp.asarray(V), JCfg(backend=jbackend), e0=jnp.asarray(e0))
    assert f.cfg.backend == backend
    np.testing.assert_allclose(f.L0, jf.L0, rtol=1e-6)
    sets = [V[[1, 5, 9]], V[[2]], V[[7, 8]]]
    _band(f.value_sets(sets).numpy(), np.asarray(jf.value_sets(sets)),
          BAND["fp32"])
    np.testing.assert_allclose(f.value(V[[3, 4]]), jf.value(V[[3, 4]]),
                               rtol=1e-5, atol=1e-5)
    assert f.value(np.zeros((0, 9), np.float32)) == 0.0
    base, cands = V[[0, 10]], V[20:40]
    _band(f.greedy_step_values(torch.from_numpy(base),
                               torch.from_numpy(cands)).numpy(),
          np.asarray(jf.greedy_step_values(jnp.asarray(base),
                                           jnp.asarray(cands))),
          BAND["fp32"])
    mc = f.update_mincache(f.init_mincache(), torch.from_numpy(V[10]))
    jmc = jf.update_mincache(jf.init_mincache(), jnp.asarray(V[10]))
    _band(mc.numpy(), np.asarray(jmc), BAND["fp32"])
    _band(f.marginal_gains(torch.from_numpy(cands), mc).numpy(),
          np.asarray(jf.marginal_gains(jnp.asarray(cands), jmc)),
          BAND["fp32"])
    np.testing.assert_allclose(f.value_from_mincache(mc),
                               jf.value_from_mincache(jmc), rtol=1e-5)
    with pytest.raises(ValueError):
        ExemplarClustering(V, device="cpu").value(V[0])
