"""The port's function zoo against the JAX package's, on the CPU.

For facility location, graph cut, saturated coverage and feature-based: the
cache protocol along a host greedy run (gains of the non-members, the fold,
the value), saturated coverage's caps, host greedy selections, and the
constructors' parameter checks; numpy-seeded ``blobs`` data, fp32 band 1e-5
(the reference's ``POLICY_TOLS``) on max|err| / max(1, max|ref|). Graph
cut's gains of indices already in S are not zeroed in either package (the
engine masks members), so only non-members are scored.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax.numpy as jnp  # noqa: E402

from repro.core import EvalConfig as JCfg  # noqa: E402
from repro.core import optimizers as jopt  # noqa: E402
from repro.core.functions import FUNCTIONS as JFUNCTIONS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import EvalConfig, optimizers as topt  # noqa: E402
from repro_torch.core.functions import (FUNCTIONS, GraphCut,  # noqa: E402
                                        SaturatedCoverage)
from repro_torch.data.synthetic import blobs  # noqa: E402

TOL = 1e-5
ZOO = [("facility_location", {}, "sqeuclidean"),
       ("graph_cut", {"lam": 0.3}, "rbf"),
       ("saturated_coverage", {"sat": 0.25}, "rbf"),
       ("feature_based", {}, "sqeuclidean")]


def _band(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    assert err <= TOL * max(1.0, float(np.max(np.abs(ref)))), err


def _pair(name, params, distance, backend="torch", n=150, seed=5):
    X = blobs(n, 12, centers=5, seed=seed)[0] / 4.0
    jbackend = {"torch": "jnp", "cuda": "pallas_interpret"}[backend]
    f = FUNCTIONS[name](X, EvalConfig(distance=distance, backend=backend),
                        device="cpu", **params)
    jf = JFUNCTIONS[name](jnp.asarray(X),
                          JCfg(distance=distance, backend=jbackend), **params)
    return f, jf


# feature_based has no kernel form: the torch backend covers it
@pytest.mark.parametrize("name,params,distance,backend", [
    (*z, backend) for z in ZOO for backend in ("torch", "cuda")
    if (z[0], backend) != ("feature_based", "cuda")])
def test_cache_protocol_along_a_greedy_run(name, params, distance, backend):
    f, jf = _pair(name, params, distance, backend)
    sel = jopt.greedy(jf, 4, mode="host").indices
    cache, jcache = f.init_cache(), jf.init_cache()
    for t in range(len(sel) + 1):
        others = np.setdiff1d(np.arange(f.n), sel[:t])
        _band(f.gains_from_cache(cache, others).numpy(),
              np.asarray(jf.gains_from_cache(jcache, others)))
        _band(f.value_from_cache(cache), jf.value_from_cache(jcache))
        if t == len(sel):
            break
        cache = f.fold_winner(cache, sel[t])
        jcache = jf.fold_winner(jcache, sel[t])
        _band(cache[0].numpy(), np.asarray(jcache[0]))
        _band(cache[1].numpy(), np.asarray(jcache[1]))


@pytest.mark.parametrize("name,params,distance", ZOO)
def test_host_greedy_matches_reference(name, params, distance):
    f, jf = _pair(name, params, distance, n=120, seed=9)
    for run in (lambda o, g: o.greedy(g, 5, mode="host"),
                lambda o, g: o.stochastic_greedy(g, 5, eps=0.1, seed=2,
                                                 mode="host"),
                lambda o, g: o.lazy_greedy(g, 5, batch=8, mode="host")):
        got, ref = run(topt, f), run(jopt, jf)
        assert got.indices == ref.indices
        assert got.evaluations == ref.evaluations
        _band(got.trajectory, ref.trajectory)


@pytest.mark.parametrize("n", [7, 150, 1030])
@pytest.mark.parametrize("distance", ["sqeuclidean", "rbf"])
def test_saturation_caps_match_reference(distance, n):
    """Caps over column blocks of min(1024, max(8, n)): one block below
    eight rows, one ragged block, and two blocks past 1024."""
    f, jf = _pair("saturated_coverage", {"sat": 0.4}, distance, n=n, seed=n)
    _band(f.row_aux.numpy(), np.asarray(jf.row_aux))


def test_device_plan_refuses_feature_based():
    f, _ = _pair("feature_based", {}, "sqeuclidean")
    with pytest.raises(ValueError, match="host execution plans"):
        topt.greedy(f, 2, mode="device")


def test_constructors_check_parameters():
    X = blobs(20, 4, seed=0)[0]
    for lam in (0.0, 0.6):
        with pytest.raises(ValueError, match="lam"):
            GraphCut(X, lam=lam, device="cpu")
    for sat in (0.0, 1.5):
        with pytest.raises(ValueError, match="sat"):
            SaturatedCoverage(X, sat=sat, device="cpu")
    assert GraphCut(X, device="cpu").spec.lam == 0.5
    assert SaturatedCoverage(X, device="cpu").spec.sat == 0.25
    assert sorted(FUNCTIONS) == sorted(JFUNCTIONS)


@pytest.mark.parametrize("name,params,distance", ZOO)
def test_convert_carries_a_zoo_function_across(name, params, distance):
    _, jf = _pair(name, params, distance)
    f = convert.function_like(jf, device="cpu")
    assert f.spec == type(f.spec)(*jf.spec)
    assert f.cfg == convert.config_from_fields(dataclasses.asdict(jf.cfg))
    np.testing.assert_array_equal(f.V.numpy(), np.asarray(jf.V))
    g = convert.function_from_arrays(name, np.array(jf.V),
                                     cfg={"distance": distance}, device="cpu",
                                     **params)
    assert g.spec == f.spec
    with pytest.raises(ValueError, match="unknown function"):
        convert.function_from_arrays("nope", np.array(jf.V), device="cpu")
