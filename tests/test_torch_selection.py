"""The port's greedy family against the JAX package's, on the CPU.

Host, multiset and device plans of greedy / stochastic_greedy / lazy_greedy
on ``blobs`` data built from one numpy seed: at n = 1000 on the ``torch``
backend against JAX ``jnp``, and at n = 200 on the ``cuda`` backend (the
kernels' plain versions) against JAX ``pallas_interpret``. Indices and
``evaluations`` must be identical; trajectories agree within fp32 1e-5
relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import EvalConfig as JCfg  # noqa: E402
from repro.core import ExemplarClustering as JEC  # noqa: E402
from repro.core import fit_exemplar_clustering as jfit  # noqa: E402
from repro.core import optimizers as jopt  # noqa: E402
from repro.data.synthetic import blobs as jblobs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (EvalConfig, ExemplarClustering,  # noqa: E402
                              fit_exemplar_clustering, greedy, lazy_greedy,
                              run_selection, stochastic_greedy)
from repro_torch.core import optimizers as topt  # noqa: E402
from repro_torch.data.synthetic import blobs  # noqa: E402

K = 6
#: port backend → the JAX backend it is held against, and the problem size
CELLS = {"torch": ("jnp", 1000), "cuda": ("pallas_interpret", 200)}
RUNS = {
    ("greedy", "host"): lambda o, f: o.greedy(f, K, mode="host"),
    ("greedy", "multiset"): lambda o, f: o.greedy(f, 4, mode="multiset"),
    ("greedy", "device"): lambda o, f: o.greedy(f, K, mode="device"),
    ("stochastic", "host"): lambda o, f: o.stochastic_greedy(
        f, K, eps=0.05, seed=3, mode="host"),
    ("stochastic", "device"): lambda o, f: o.stochastic_greedy(
        f, K, eps=0.05, seed=3, mode="device"),
    ("lazy", "host"): lambda o, f: o.lazy_greedy(f, K, batch=8, mode="host"),
    ("lazy", "device"): lambda o, f: o.lazy_greedy(f, K, batch=8,
                                                   mode="device"),
}
_FUNCS: dict = {}


def _pair(backend):
    """The same problem in both packages (shared across cells)."""
    if backend not in _FUNCS:
        jbackend, n = CELLS[backend]
        X, _ = blobs(n, 24, centers=12, seed=13)
        _FUNCS[backend] = (
            convert.exemplar_from_arrays(X, None, {"backend": jbackend},
                                         device="cpu"),
            JEC(jnp.asarray(X), JCfg(backend=jbackend)))
    return _FUNCS[backend]


def _same(got, ref):
    assert got.indices == ref.indices
    assert got.evaluations == ref.evaluations
    np.testing.assert_allclose(got.trajectory, ref.trajectory, rtol=1e-5,
                               atol=1e-5 * max(1.0, abs(ref.value)))
    assert got.value == pytest.approx(ref.value, rel=1e-5)


def test_synthetic_generators_are_the_reference_draws():
    X, labels = blobs(50, 7, centers=3, seed=4)
    JX, jlabels = jblobs(50, 7, centers=3, seed=4)
    np.testing.assert_array_equal(X, JX)
    np.testing.assert_array_equal(labels, jlabels)


@pytest.mark.parametrize("strategy,mode", sorted(RUNS))
@pytest.mark.parametrize("backend", sorted(CELLS))
def test_selection_matches_reference(backend, strategy, mode):
    f, jf = _pair(backend)
    run = RUNS[(strategy, mode)]
    _same(run(topt, f), run(jopt, jf))


@pytest.mark.parametrize("backend", sorted(CELLS))
def test_device_plan_equals_host_plan(backend):
    f, _ = _pair(backend)
    for strategy in ("greedy", "stochastic", "lazy"):
        _same(RUNS[(strategy, "device")](topt, f),
              RUNS[(strategy, "host")](topt, f))


def test_candidate_subset_and_validation():
    f, jf = _pair("torch")
    cand = np.array([5, 900, 17, 5, 300, 42, 77, 600])
    for mode in ("host", "device"):
        _same(greedy(f, 3, mode=mode, candidates=cand),
              jopt.greedy(jf, 3, mode=mode, candidates=cand))
    with pytest.raises(ValueError):
        greedy(f, 2, candidates=[-1, 3])
    with pytest.raises(ValueError):
        greedy(f, 4, candidates=[1, 2, 3])
    with pytest.raises(ValueError):
        greedy(f, 2, mode="warp")
    with pytest.raises(ValueError):
        lazy_greedy(f, 2, batch=0)
    assert stochastic_greedy(f, 0).indices == []


@pytest.mark.parametrize("plan", ["device_sharded", "device_sharded_pool",
                                  "greedi"])
def test_mesh_plans_are_refused_by_name(plan):
    f, _ = _pair("torch")
    with pytest.raises(NotImplementedError, match="A.7"):
        greedy(f, 2, mode=plan)
    with pytest.raises(NotImplementedError, match="A.7"):
        run_selection(f, kind="lazy", k=2, plan=plan)


def test_fit_exemplar_clustering_assign_matches_reference():
    X, _ = blobs(300, 8, centers=4, seed=9)
    model = fit_exemplar_clustering(X, 4, optimizer="lazy_greedy",
                                    device="cpu", batch=16)
    jmodel = jfit(jnp.asarray(X), 4, optimizer="lazy_greedy", batch=16)
    assert model.exemplar_indices == jmodel.exemplar_indices
    np.testing.assert_array_equal(model.assign(X), jmodel.assign(X))
    np.testing.assert_array_equal(model.exemplars, X[model.exemplar_indices])
    with pytest.raises(ValueError):
        fit_exemplar_clustering(X, 2, optimizer="sieve_streaming",
                                device="cpu")


def test_device_plan_stays_on_the_device_until_it_ends(monkeypatch):
    """Dense and stochastic rounds make no host sync inside the loop: the
    only reads of device values are the ones after it."""
    f = ExemplarClustering(blobs(120, 6, centers=3, seed=1)[0],
                           EvalConfig(backend="cuda"), device="cpu")
    calls = []
    for name in ("item", "tolist", "cpu", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    for k in (2, 5):
        calls.clear()
        greedy(f, k, mode="device")
        n_dense = len(calls)
        calls.clear()
        stochastic_greedy(f, k, mode="device")
        assert len(calls) == n_dense
    # the same count at k = 2 and k = 5: nothing per round
    assert n_dense <= 4
