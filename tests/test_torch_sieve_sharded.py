"""The port's column-sharded sieve engine on ``torch.distributed`` (gloo, on
the CPU) against the JAX package's single-device device sieve.

As ``tests/test_sieve_sharded.py`` holds the reference's sharded engine:
the (S_max, n) sieve table, the seed, the row auxiliary and every
element's distance row column-shard over p ranks, and the sharded engine
must give the device plan's members and evaluations exactly, and its value
within 1e-6 of max(1, |value|) (the element's sums over n are added in
another order: the shards', then shard order). Each world size
p ∈ {1, 2, 4} is one spawn (``spawn_local``) that runs every case; the
tests assert case by case, and every rank must return the same result.
n = 300 and 302 (302 is not a multiple of 4: pad columns carry the
functions' sentinels), and n = 1 024. Port backends ``torch`` and
``cuda`` (the sieve kernel's plain version on the CPU) are both held
against the reference's ``jnp`` engine. The streams are prefixes of the
reference tests' seeded shuffles (``STREAM`` elements; ``SCALE_STREAM``
at n = 1 024): each element costs one gloo collective per reduction over
n, and a collective waits for every rank to be scheduled, so the length
of the stream sets how a loaded machine stretches a world's run.

JAX is imported only inside the fixture that builds the references.
"""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

from repro_torch.core import (FUNCTIONS, EvalConfig,  # noqa: E402
                              StreamIngestionService, salsa, sieve_streaming,
                              sieve_streaming_pp)
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.streaming import make_sieve_engine  # noqa: E402
from repro_torch.data.synthetic import blobs  # noqa: E402

WORLDS = (1, 2, 4)
ALGS = {"sieve_streaming": sieve_streaming, "pp": sieve_streaming_pp,
        "salsa": salsa}
BACKENDS = ("torch", "cuda")
#: facility location on both backends (its kernel template); saturated
#: coverage has no kernel form, so its ``cuda`` backend is ``torch``
ZOO = (("facility_location", "torch"), ("facility_location", "cuda"),
       ("saturated_coverage", "torch"))
BLOCKS = (1, 97)
STREAM = 120
#: the reference's acceptance size (its 8 192 is left out for time)
SCALE_N = 1024
SCALE_STREAM = 256


def _order(n, seed, length):
    """A prefix of ``optimizers._stream``'s shuffle for ``seed``."""
    return np.random.default_rng(seed).permutation(n)[:length]


def _small(backend="torch"):
    X, _ = blobs(300, 16, centers=8, seed=1)
    return FUNCTIONS["exemplar"](X, EvalConfig(backend=backend),
                                 device="cpu")


def _zoo(name, backend):
    X, _ = blobs(302, 16, centers=8, seed=1)
    return FUNCTIONS[name](X / 10.0, EvalConfig(distance="rbf",
                                                backend=backend),
                           device="cpu")


def _service(f):
    X = f.V.numpy()
    order = _order(f.n, 7, STREAM)

    async def main():
        async with StreamIngestionService(f, k=6, mode="device_sharded",
                                          block_size=32) as svc:
            await svc.offer_batch(X[order])
            return await svc.snapshot()   # drains first under a mesh

    snap = asyncio.run(main())
    return (snap.indices, snap.evaluations, snap.n_ingested, snap.value,
            snap.exemplars)


def _collectives_per_element(alg, backend):
    """Ordered sums one offered block of ``STREAM`` elements issues, per
    element."""
    f = _small(backend)
    variant = {"sieve_streaming": "sieve", "pp": "pp", "salsa": "salsa"}[alg]
    eng = make_sieve_engine(f, 6, 0.1, variant=variant,
                            mode="device_sharded", block_size=STREAM)
    order = _order(300, 2, STREAM)
    real, calls = distributed.ordered_sum, []

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    distributed.ordered_sum = counting
    try:
        eng.offer(order, f.V[torch.as_tensor(order)])
    finally:
        distributed.ordered_sum = real
    return len(calls) / STREAM


def _rank_cases(rank, world):
    torch.set_num_threads(1)
    out = {}
    for backend in BACKENDS:
        for name in ALGS:
            out["collectives", name, backend] = _collectives_per_element(
                name, backend)
    for backend in BACKENDS:
        f = _small(backend)
        for name, alg in ALGS.items():
            out["alg", name, backend] = alg(
                f, 6, eps=0.1, order=_order(300, 2, STREAM),
                mode="device_sharded")
    for name, backend in ZOO:
        out["zoo", name, backend] = sieve_streaming(
            _zoo(name, backend), 6, eps=0.1, order=_order(302, 2, STREAM),
            mode="device_sharded")
    X, _ = blobs(SCALE_N, 24, centers=12, seed=13)
    out["scale"] = sieve_streaming(
        FUNCTIONS["exemplar"](X, device="cpu"), 8,
        order=_order(SCALE_N, 5, SCALE_STREAM), mode="device_sharded",
        block_size=128)
    f = _small()
    for b in BLOCKS:
        out["blocks", b] = sieve_streaming(
            f, 5, eps=0.1, order=_order(300, 2, STREAM),
            mode="device_sharded", block_size=b)
    eng = make_sieve_engine(f, 6, 0.1, mode="device_sharded")
    eng.offer(np.arange(64), f.V[:64])
    out["table"] = (tuple(eng.state.caches.shape),
                    tuple(eng.state.members.shape), eng.spec.s_max)
    out["service"] = _service(f)
    sh = distributed.resolve_mesh(None, ("data",))
    try:
        make_sieve_engine(f, 4, 0.1, mode="host", mesh=sh.mesh)
    except ValueError as e:
        out["host mirror"] = str(e)
    return out


_WORLDS: dict = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``world(p)``: every rank's results of the p-rank spawn."""
    def get(p):
        if p not in _WORLDS:
            # a failed spawn is kept and raised again: paid once per world
            try:
                _WORLDS[p] = distributed.spawn_local(
                    _rank_cases, p,
                    store_dir=tmp_path_factory.mktemp(f"p{p}"), timeout=120)
            except (RuntimeError, TimeoutError) as e:
                _WORLDS[p] = e
        if isinstance(_WORLDS[p], Exception):
            raise _WORLDS[p]
        return _WORLDS[p]
    return get


_REFS: dict = {}


@pytest.fixture(scope="module")
def reference():
    """``reference(key)``: the JAX package's device sieve on the same
    stream, jnp backend."""
    import jax.numpy as jnp

    from repro.core import EvalConfig as JCfg
    from repro.core import optimizers as jopt
    from repro.core.functions import FUNCTIONS as JFUNCTIONS

    algs = {"sieve_streaming": jopt.sieve_streaming,
            "pp": jopt.sieve_streaming_pp, "salsa": jopt.salsa}

    def small():
        return JFUNCTIONS["exemplar"](
            jnp.asarray(blobs(300, 16, centers=8, seed=1)[0]))

    def get(key):
        if key not in _REFS:
            if key[0] == "alg":
                _REFS[key] = algs[key[1]](
                    small(), 6, eps=0.1, order=_order(300, 2, STREAM),
                    mode="device")
            elif key[0] == "zoo":
                X, _ = blobs(302, 16, centers=8, seed=1)
                jf = JFUNCTIONS[key[1]](jnp.asarray(X) / 10.0,
                                        JCfg(distance="rbf"))
                _REFS[key] = jopt.sieve_streaming(
                    jf, 6, eps=0.1, order=_order(302, 2, STREAM),
                    mode="device")
            elif key[0] == "scale":
                X, _ = blobs(SCALE_N, 24, centers=12, seed=13)
                _REFS[key] = jopt.sieve_streaming(
                    JFUNCTIONS["exemplar"](jnp.asarray(X)), 8,
                    order=_order(SCALE_N, 5, SCALE_STREAM), mode="device",
                    block_size=128)
            elif key[0] == "blocks":
                _REFS[key] = jopt.sieve_streaming(
                    small(), 5, eps=0.1, order=_order(300, 2, STREAM),
                    mode="device", block_size=64)
        return _REFS[key]
    return get


def _same_on_every_rank(ranks, key):
    r0 = ranks[0][key]
    for r in ranks[1:]:
        got = r[key]
        if isinstance(r0, tuple):
            assert len(got) == len(r0)
            for a, b in zip(got, r0):
                np.testing.assert_array_equal(a, b)
        else:
            assert got == r0
    return r0


def _same(got, ref):
    assert got.indices == ref.indices
    assert got.evaluations == ref.evaluations
    np.testing.assert_allclose(got.value, ref.value,
                               atol=1e-6 * max(1.0, abs(ref.value)))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("alg", sorted(ALGS))
@pytest.mark.parametrize("p", WORLDS)
def test_sharded_sieve_matches_reference_device(world, reference, p, alg,
                                                backend):
    got = _same_on_every_rank(world(p), ("alg", alg, backend))
    _same(got, reference(("alg", alg)))


@pytest.mark.parametrize("name,backend", ZOO)
@pytest.mark.parametrize("p", WORLDS)
def test_sharded_sieve_zoo_with_padding(world, reference, p, name, backend):
    """Facility location's +inf pad seeds and saturated coverage's zero pad
    caps keep the pad columns inert (n = 302)."""
    got = _same_on_every_rank(world(p), ("zoo", name, backend))
    _same(got, reference(("zoo", name)))


@pytest.mark.parametrize("p", WORLDS)
def test_sharded_sieve_parity_at_scale(world, reference, p):
    got = _same_on_every_rank(world(p), "scale")
    _same(got, reference(("scale",)))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("p", WORLDS)
def test_sharded_sieve_block_size_invariance(world, reference, p, block):
    """Blocking changes nothing under the mesh either: an element's
    collectives are issued per live element, not per padded block."""
    got = _same_on_every_rank(world(p), ("blocks", block))
    ref = reference(("blocks",))
    assert got.indices == ref.indices
    assert got.evaluations == ref.evaluations


@pytest.mark.parametrize("p", WORLDS)
def test_sharded_engine_table_is_sharded(world, p):
    """Each rank holds (S_max, ⌈n/p⌉) columns of the table, while the member
    slots stay whole on every rank."""
    caches, members, s_max = _same_on_every_rank(world(p), "table")
    assert caches == (s_max, -(-300 // p))
    assert members == (s_max, 6)


@pytest.mark.parametrize("p", WORLDS)
def test_service_snapshot_over_sharded_engine(world, p):
    """The ingestion service over the sharded engine reports the members,
    evaluations, value and exemplars of the reference's single-device
    service fed the same stream."""
    import jax.numpy as jnp

    from repro.core import StreamIngestionService as JService

    indices, evals, ingested, value, exemplars = _same_on_every_rank(
        world(p), "service")
    X = blobs(300, 16, centers=8, seed=1)[0]
    order = _order(300, 7, STREAM)

    async def main():
        from repro.core import ExemplarClustering as JEC

        async with JService(JEC(jnp.asarray(X)), k=6, mode="device",
                            block_size=32) as svc:
            await svc.offer_batch(X[order])
            await svc.drain()
            return await svc.snapshot()

    ref = asyncio.run(main())
    assert indices == ref.indices
    assert evals == ref.evaluations
    assert ingested == ref.n_ingested == STREAM
    np.testing.assert_allclose(value, ref.value,
                               atol=1e-6 * max(1.0, abs(ref.value)))
    np.testing.assert_array_equal(exemplars, np.asarray(ref.exemplars))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("alg", sorted(ALGS))
@pytest.mark.parametrize("p", WORLDS)
def test_sharded_sieve_collectives_per_element(world, p, alg, backend):
    """An element's gains and the table's stat sums cross the mesh in ONE
    collective; ++ sends one more for its values after the fold."""
    got = _same_on_every_rank(world(p), ("collectives", alg, backend))
    assert got == (2.0 if alg == "pp" else 1.0)


@pytest.mark.parametrize("p", WORLDS)
def test_host_mirror_rejects_mesh(world, p):
    assert "host mirror" in _same_on_every_rank(world(p), "host mirror")
