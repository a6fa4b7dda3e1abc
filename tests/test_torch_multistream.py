"""The port's batched multi-stream sieve engine and its serving surface, on
the CPU: each partition bit for bit its standalone engine (both backends,
all three variants, ragged and empty partitions), the same selections as
the JAX package's batched engine and service, and the two-tier merge's
certified (1/2−ε)-composed bound. Mirrors ``tests/test_multistream.py``."""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import EvalConfig as JCfg  # noqa: E402
from repro.core import ExemplarClustering as JEC  # noqa: E402
from repro.core import MultiStreamIngestionService as JMulti  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (MultiStreamIngestionService,  # noqa: E402
                              greedy)
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.data.synthetic import blobs  # noqa: E402

P = 3
BACKENDS = {"torch": "jnp", "cuda": "pallas_interpret"}
_FUNCS: dict = {}


def _pair(backend):
    if backend not in _FUNCS:
        X, _ = blobs(240, 12, centers=8, seed=4)
        jb = BACKENDS[backend]
        _FUNCS[backend] = (
            convert.exemplar_from_arrays(X, None, {"backend": jb},
                                         device="cpu"),
            JEC(jnp.asarray(X), JCfg(backend=jb)))
    return _FUNCS[backend]


@pytest.fixture(scope="module")
def f():
    return _pair("torch")[0]


def _split_stream(f, n=90, seed=9):
    """A synthetic stream round-robined into P partition runs."""
    rng = np.random.default_rng(seed)
    base = np.asarray(f.V)[rng.choice(f.n, size=n)]
    stream = (base + 0.03 * rng.normal(size=base.shape)).astype(np.float32)
    ids = np.arange(n)
    return stream, [(ids[p::P], stream[p::P]) for p in range(P)]


@pytest.mark.parametrize("variant", ["sieve", "pp", "salsa"])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_batched_matches_standalone_engines_and_reference(backend, variant):
    """Each partition of the batched engine equals, bit for bit, a
    standalone device engine fed the same sub-stream: accept masks,
    members, values and evaluation counts; and picks what the reference's
    batched engine picks."""
    tf, jf = _pair(backend)
    _, parts = _split_stream(tf)
    ids, Xs = [i for i, _ in parts], [x for _, x in parts]
    eng = tst.make_batched_sieve_engine(tf, 4, 0.15, P, variant=variant,
                                        block_size=8, backend=backend)
    masks = eng.offer(ids, Xs)
    bests = eng.best_all()
    jeng = jst.make_batched_sieve_engine(jf, 4, 0.15, P, variant=variant,
                                         block_size=8,
                                         backend=BACKENDS[backend])
    jmasks = jeng.offer(ids, Xs)
    jbests = jeng.best_all()
    for p in range(P):
        ref = tst.make_sieve_engine(tf, 4, 0.15, variant=variant,
                                    mode="device", block_size=8,
                                    backend=backend)
        np.testing.assert_array_equal(masks[p], ref.offer(ids[p], Xs[p]))
        assert bests[p] == ref.best()
        assert eng.evaluations(p) == ref.evaluations()
        np.testing.assert_array_equal(masks[p], jmasks[p])
        assert bests[p][0] == jbests[p][0]
        assert eng.evaluations(p) == jeng.evaluations(p)
        np.testing.assert_allclose(bests[p][1], jbests[p][1], atol=1e-5)


def test_batched_ragged_and_empty_partitions(f):
    """Ragged per-partition runs (including empty) ride shared blocks as
    padding without perturbing the other partitions."""
    X = np.asarray(f.V)
    idxs = [np.arange(11), np.arange(100, 103), np.zeros(0, np.int64)]
    Xs = [X[:11], X[20:23], np.zeros((0, f.dim), np.float32)]
    eng = tst.make_batched_sieve_engine(f, 3, 0.2, P, block_size=4)
    masks = eng.offer(idxs, Xs)
    assert [len(m) for m in masks] == [11, 3, 0]
    for p in (0, 1):
        ref = tst.make_sieve_engine(f, 3, 0.2, mode="device", block_size=4)
        np.testing.assert_array_equal(masks[p], ref.offer(idxs[p], Xs[p]))
        assert eng.best_all()[p] == ref.best()
        assert eng.evaluations(p) == ref.evaluations()
    assert eng.best_all()[2] == ([], 0.0)
    assert eng.evaluations(2) == 0
    assert eng.evaluations() == eng.evaluations(0) + eng.evaluations(1)


def test_batched_engine_validates_its_input(f):
    with pytest.raises(ValueError, match="n_streams"):
        tst.make_batched_sieve_engine(f, 3, 0.2, 0)
    eng = tst.make_batched_sieve_engine(f, 3, 0.2, P, block_size=4)
    X = np.asarray(f.V)
    with pytest.raises(ValueError, match="partition runs"):
        eng.offer([np.arange(2)], [X[:2]])
    with pytest.raises(ValueError, match="ids vs"):
        eng.offer([np.arange(2), np.arange(1), np.arange(0)],
                  [X[:2], X[:2], X[:0]])
    with pytest.raises(OverflowError):
        eng.offer([np.array([2 ** 31]), np.arange(0), np.arange(0)],
                  [X[:1], X[:0], X[:0]])


@pytest.mark.parametrize("aligned", [True, False])
def test_partition_means_take_the_standalone_shape(aligned):
    """A (P, rows, n) mean is taken partition by partition, each from an
    aligned base, and equals the standalone (rows, n) mean bit for bit."""
    rng = np.random.default_rng(3)
    n = 64 if aligned else 61      # 61·5·4 bytes: partitions 1, 2 misaligned
    M = torch.tensor(rng.uniform(0, 9, size=(P, 5, n)).astype(np.float32))
    got = tst._mean_rows(M)
    for p in range(P):
        assert torch.equal(got[p], torch.mean(M[p].clone(), dim=-1))


def test_multistream_service_certified_merge_matches_reference(f):
    """P logical streams through one service; the snapshot's two-tier merge
    carries the runtime certificate value ≥ (1/2−ε)·max_p stream value,
    the composed guarantee ((1/2−ε)²/P)·OPT holds against greedy, and the
    reference's service picks the same members from the same stream."""
    eps = 0.1
    order = np.random.default_rng(13).permutation(f.n)
    X = np.asarray(f.V)[order]

    async def main(cls, fn):
        async with cls(fn, k=5, n_streams=P, eps=eps, block_size=8) as svc:
            for j, x in enumerate(X):
                await svc.offer(x, stream=j % P)
            await svc.drain()
            return await svc.snapshot()

    snap = asyncio.run(main(MultiStreamIngestionService, f))
    assert snap.n_offered == snap.n_ingested == f.n
    assert snap.certified
    assert snap.value >= snap.bound - 1e-5
    assert len(snap.stream_values) == len(snap.stream_members) == P
    assert all(v > 0 for v in snap.stream_values)
    assert 1 <= len(snap.indices) <= 5
    np.testing.assert_array_equal(snap.exemplars, X[snap.indices])
    union = {i for m in snap.stream_members for i in m}
    assert set(snap.indices) <= union
    assert snap.value >= (0.5 - eps) ** 2 / P * greedy(f, 5).value
    jsnap = asyncio.run(main(JMulti, _pair("torch")[1]))
    assert snap.indices == jsnap.indices
    assert snap.stream_members == jsnap.stream_members
    assert snap.evaluations == jsnap.evaluations
    np.testing.assert_allclose(snap.value, jsnap.value, atol=1e-5)
    np.testing.assert_allclose(snap.stream_values, jsnap.stream_values,
                               atol=1e-5)


def test_multistream_round_robin_and_validation(f):
    """Default routing round-robins by id; bad stream indices raise."""
    X = np.asarray(f.V)

    async def main():
        async with MultiStreamIngestionService(
                f, k=3, n_streams=P, block_size=4) as svc:
            ids = [await svc.offer(X[j]) for j in range(12)]
            with pytest.raises(ValueError, match="stream"):
                await svc.offer(X[0], stream=P)
            await svc.drain()
            return ids, await svc.snapshot()

    ids, snap = asyncio.run(main())
    assert ids == list(range(12))
    assert snap.n_ingested == 12
    assert sum(len(m) > 0 for m in snap.stream_members) == P
    # round robin: partition p saw exactly the ids ≡ p (mod P)
    for p, members in enumerate(snap.stream_members):
        assert all(i % P == p for i in members)
