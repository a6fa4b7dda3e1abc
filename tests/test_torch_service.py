"""The port's SelectionService against direct engine calls and against the
JAX package's SelectionService.

Mirrors tests/test_selection_service.py test by test (served results,
amortisation, signature policy, padding slots, error isolation, validation,
backpressure, the unstarted service) on the port, on the CPU, and adds one
test where the same tenants go through both packages' services. The
reference pads each bucket's batch to a power of two for its jit cache; the
port dispatches a bucket at its own size, and its padding test says so.
"""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SelectionService as JSelectionService  # noqa: E402
from repro_torch.core import (SelectionService, run_selection,  # noqa: E402
                              stochastic_greedy)
from repro_torch.core.functions import FUNCTIONS  # noqa: E402
from repro_torch.core.service import _SelectionRequest, _next_pow2  # noqa: E402
from repro_torch.data.synthetic import blobs  # noqa: E402

N, D, K = 48, 8, 3


def _tenants(count, n=N, seed0=200):
    return [blobs(n, D, centers=4, seed=seed0 + t)[0] for t in range(count)]


def _service(**kw):
    return SelectionService(device="cpu", **kw)


def _ref(X, kind, k, seed=0, **kw):
    f = FUNCTIONS["exemplar"](X, device="cpu")
    if kind == "stochastic":
        return stochastic_greedy(f, k, eps=kw.get("eps", 0.05), seed=seed,
                                 mode="device")
    cand = np.arange(X.shape[0])[None, :] if kind == "dense" else None
    return run_selection(f, kind=kind, k=k, cand_rounds=cand,
                         top_b=kw.get("top_b", 0))


def test_served_results_match_direct_engine_calls():
    """Mixed kinds, ragged k, per-request stochastic seeds — every tenant
    gets exactly its direct-call result."""
    Xs = _tenants(9)
    kinds = [["dense", "lazy", "stochastic"][i % 3] for i in range(9)]
    ks = [2 + i % 3 for i in range(9)]

    async def main():
        async with _service(max_batch=8) as svc:
            res = await asyncio.gather(*[
                svc.submit(X, k=kb, kind=kind, seed=i, top_b=16)
                for i, (X, kind, kb) in enumerate(zip(Xs, kinds, ks))])
            return res, dict(svc.stats)

    res, stats = asyncio.run(main())
    for i, (X, kind, kb) in enumerate(zip(Xs, kinds, ks)):
        assert res[i] == _ref(X, kind, kb, seed=i, top_b=16), (i, kind)
    assert stats["requests"] == 9


def test_bucketing_amortizes_dispatches():
    """16 same-signature tenants submitted concurrently ride few batched
    dispatches (1 when the burst lands in one worker drain), never 16."""
    Xs = _tenants(16)

    async def main():
        async with _service(max_batch=16) as svc:
            res = await asyncio.gather(*[svc.submit(X, k=K) for X in Xs])
            return res, dict(svc.stats)

    res, stats = asyncio.run(main())
    assert stats["batched_requests"] == 16
    assert stats["dispatches"] < 16 / 2, stats
    for X, r in zip(Xs, res):
        assert r == _ref(X, "dense", K)


def test_bucket_signature_policy():
    """Dense/lazy pool k up to the next power of two; stochastic buckets by
    exact (k, eps); seeds stay out of the signature."""
    X = _tenants(1)[0]

    def sig(**kw):
        base = dict(X=X, k=3, fn="exemplar", params=(), kind="dense",
                    seed=0, eps=0.05, top_b=0, future=None)
        return _SelectionRequest(**{**base, **kw}).signature()

    assert sig(k=3) == sig(k=4)
    assert sig(k=4) != sig(k=5)
    assert sig() != sig(kind="lazy")
    assert sig() != sig(fn="graph_cut")
    assert sig() != sig(params=(("lam", 0.25),))
    assert sig(kind="stochastic", k=3) != sig(kind="stochastic", k=4)
    assert sig(kind="stochastic", eps=0.05) != sig(kind="stochastic",
                                                   eps=0.2)
    assert sig(kind="stochastic", seed=1) == sig(kind="stochastic", seed=2)
    assert _next_pow2(1) == 1 and _next_pow2(5) == 8


def test_padding_slots_are_accounted_and_inert(monkeypatch):
    """A 3-tenant bucket with k in {3, 4, 3} is dispatched at B=3, with no
    padding slot, over k pooled to 4 rounds; the pooled rounds of the k=3
    tenants are inert, and the results are the direct calls'."""
    from repro_torch.core import engine as eng

    calls = []
    real = eng.run_selection_batch

    def spy(fs, **kw):
        calls.append((len(fs), kw["k"], list(kw["ks"])))
        return real(fs, **kw)

    monkeypatch.setattr(eng, "run_selection_batch", spy)
    Xs = _tenants(3)
    ks = [K, K + 1, K]

    async def main():
        async with _service(max_batch=8) as svc:
            res = await asyncio.gather(*[svc.submit(X, k=kb)
                                         for X, kb in zip(Xs, ks)])
            return res, dict(svc.stats)

    res, stats = asyncio.run(main())
    assert len(res) == 3
    assert sum(b for b, _, _ in calls) == stats["batched_requests"] == 3
    assert all(k == 4 and len(kb) == b for b, k, kb in calls), calls
    for X, kb, r in zip(Xs, ks, res):
        assert r == _ref(X, "dense", kb)


def test_bucket_error_isolated_and_service_survives():
    """A bad request fails ITS bucket's future with the real error; other
    buckets and later submissions are unaffected."""
    Xs = _tenants(2)

    async def main():
        async with _service(max_batch=8) as svc:
            good = svc.submit(Xs[0], k=K)
            bad = svc.submit(Xs[0], k=K, fn="feature_based")  # host-only fn
            g = await good
            with pytest.raises(ValueError, match="host execution plans"):
                await bad
            g2 = await svc.submit(Xs[1], k=K)
            return g, g2

    g, g2 = asyncio.run(main())
    assert g == _ref(Xs[0], "dense", K)
    assert g2 == _ref(Xs[1], "dense", K)


def test_submit_validates_before_queueing():
    X = _tenants(1)[0]

    async def main():
        async with _service() as svc:
            with pytest.raises(ValueError, match="unknown strategy"):
                await svc.submit(X, k=2, kind="eager")
            with pytest.raises(ValueError, match="unknown function"):
                await svc.submit(X, k=2, fn="nope")
            with pytest.raises(ValueError, match="cannot select"):
                await svc.submit(X, k=N + 1)
            with pytest.raises(ValueError, match=r"\(n, d\)"):
                await svc.submit(X[0], k=1)
            r = await svc.submit(X, k=0)
            return r, dict(svc.stats)

    r, stats = asyncio.run(main())
    assert r.indices == [] and r.evaluations == 0
    assert stats["dispatches"] == 0 and stats["requests"] == 1
    with pytest.raises(ValueError, match="max_batch"):
        _service(max_batch=0)


def test_backpressure_bounded_queue():
    """More in-flight submissions than max_pending: producers block on the
    queue instead of buffering without bound, and everything is served."""
    Xs = _tenants(10)

    async def main():
        async with _service(max_batch=4, max_pending=2) as svc:
            res = await asyncio.gather(
                *[svc.submit(Xs[i], k=2) for i in range(10)])
            return res, dict(svc.stats)

    res, stats = asyncio.run(main())
    assert len(res) == 10 and stats["requests"] == 10
    for X, r in zip(Xs, res):
        assert r == _ref(X, "dense", 2)


def test_unstarted_service_refuses():
    svc = _service()

    async def main():
        with pytest.raises(RuntimeError, match="not started"):
            await svc.submit(_tenants(1)[0], k=2)

    asyncio.run(main())


def test_same_tenants_through_both_services():
    """One burst of tenants — dense, lazy and stochastic, exemplar and
    graph cut, ragged k — through the JAX package's service and the
    port's: identical indices and evaluations, trajectories within fp32."""
    Xs = _tenants(8, seed0=300)
    reqs = [dict(k=2 + i % 3, kind=["dense", "lazy", "stochastic"][i % 3],
                 seed=i, top_b=8) for i in range(8)]
    reqs[6].update(fn="graph_cut", lam=0.25)
    reqs[7].update(fn="graph_cut", lam=0.25, kind="dense")

    async def serve(svc):
        async with svc:
            return await asyncio.gather(*[svc.submit(X, **r)
                                          for X, r in zip(Xs, reqs)])

    mine = asyncio.run(serve(_service(max_batch=4)))
    ref = asyncio.run(serve(JSelectionService(max_batch=4)))
    for i, (a, b) in enumerate(zip(mine, ref)):
        assert a.indices == b.indices, i
        assert a.evaluations == b.evaluations, i
        np.testing.assert_allclose(a.trajectory, b.trajectory, atol=1e-5,
                                   rtol=0)
