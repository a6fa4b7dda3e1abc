"""The port's mesh plans on ``torch.distributed`` (gloo, on the CPU) against
the JAX package.

Each world size p ∈ {1, 2, 4} is one spawn of p ranks (``spawn_local``, a
``FileStore`` under the test's tmp dir) that runs every case of that world
and returns its results; the parametrised tests below then assert case by
case. Every rank must return the same result.

The reference cannot run its own selection mesh plans under jax 0.9.0
(``shard_map`` rejects ``out_specs=P(None)`` for a rank-0 output), so the
selections are held against the reference's single-device ``device``
plan, as the reference's parity suite holds its own mesh plans: indices
and ``evaluations`` exactly, trajectories within the fp32 policy
tolerance (1e-5). Sizes follow ``tests/test_plan_parity.py``:
``blobs(n, 24, centers=12, seed=13)``, K = 6, the zoo on rbf distances of
the down-scaled blobs, scored on non-members only; n = 1 024 throughout,
and at p = 4 also n = 8 192 for exemplar (as the reference's matrix; the
pool-sharded plan on the ``torch`` backend) and n = 1 026, which the mesh
does not divide (pad rows carry the functions' sentinels). Port backends ``torch`` and
``cuda`` (the kernels' plain versions on the CPU) are both held against
the reference's ``jnp`` plan.

JAX is imported only inside the fixtures that build the references: the
ranks import this module and must not pay for JAX.
"""
import asyncio
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (FUNCTIONS, EvalConfig, SelectionService,  # noqa: E402
                              greedy, lazy_greedy, run_selection,
                              run_selection_batch, stochastic_greedy)
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.service import _stochastic_samples  # noqa: E402
from repro_torch.data.synthetic import blobs  # noqa: E402

K = 6
WORLDS = (1, 2, 4)
ZOO = ("exemplar", "facility_location", "graph_cut", "saturated_coverage")
STRATEGIES = ("dense", "stochastic", "lazy")
PLANS = ("device_sharded", "device_sharded_pool")
BACKENDS = ("torch", "cuda")
BATCH_N = 1024
B = 4
#: the ragged per-request k of the dense and lazy buckets (0: inert slot)
RAGGED = [6, 3, 0, 6]


def _selection_cases(p):
    cases = [(fn, s, plan, b, 1024) for fn in ZOO for s in STRATEGIES
             for plan in PLANS for b in BACKENDS]
    if p == 4:
        cases += [("exemplar", s, "device_sharded_pool", "torch", 8192)
                  for s in STRATEGIES]
        cases += [(fn, s, plan, "torch", 1026) for fn in ZOO
                  for s in STRATEGIES for plan in PLANS]
    return cases


def _greedi_cases(p):
    return [(fn, b, 1024) for fn in ZOO for b in BACKENDS] + \
        ([("exemplar", "torch", 8192)] if p == 4 else [])


BATCHED_CASES = [(fn, plan, s, b) for fn in ("exemplar", "graph_cut")
                 for plan in PLANS for s in STRATEGIES for b in BACKENDS
                 if fn == "exemplar" or b == "torch"]
#: data axes of the p = 4 world's 2 × 2 mesh ("a", "b"), and of a
#: 2 × 1 × 2 mesh ("a", "r", "b") whose data group is a new process group
AXES_CASES = [("a", "b"), ("b", "a"), ("a",), ("a", "b", "r")]


def _function(name, n, backend):
    X, _ = blobs(n, 24, centers=12, seed=13)
    if name == "exemplar":
        return FUNCTIONS[name](X, EvalConfig(backend=backend), device="cpu")
    return FUNCTIONS[name](X / 10.0, EvalConfig(distance="rbf",
                                                backend=backend),
                           device="cpu")


def _run(f, strategy, plan, **kw):
    if strategy == "dense":
        return greedy(f, K, mode=plan, **kw)
    if strategy == "stochastic":
        return stochastic_greedy(f, K, eps=0.05, seed=3, mode=plan, **kw)
    return lazy_greedy(f, K, mode=plan, **kw)


def _tenants(name, backend):
    scale = 1.0 if name == "exemplar" else 10.0
    cfg = EvalConfig(backend=backend) if name == "exemplar" \
        else EvalConfig(distance="rbf", backend=backend)
    return [FUNCTIONS[name](blobs(BATCH_N, 24, centers=12, seed=40 + t)[0]
                            / scale, cfg, device="cpu") for t in range(B)]


def _batched(fs, plan, strategy):
    """A bucket of B tenants and each tenant's unbatched call."""
    if strategy == "stochastic":
        cand = np.stack([_stochastic_samples(BATCH_N, K, 0.05, seed=t)
                         for t in range(B)])
        got = run_selection_batch(fs, kind="stochastic", k=K,
                                  cand_rounds=cand, plan=plan)
        ref = [stochastic_greedy(f, K, eps=0.05, seed=t, mode=plan)
               for t, f in enumerate(fs)]
        return got, ref
    got = run_selection_batch(fs, kind=strategy, k=8, ks=RAGGED, plan=plan)
    run = greedy if strategy == "dense" else lazy_greedy
    return got, [run(f, kb, mode=plan) for f, kb in zip(fs, RAGGED)]


def _service(plan):
    """Served results and each request's unbatched call under ``plan``."""
    Xs = [blobs(BATCH_N, 24, centers=12, seed=60 + t)[0] for t in range(6)]
    ks = [2, 4, 3, 4, 1, 3]
    cfg = EvalConfig()

    async def serve():
        async with SelectionService(cfg, device="cpu", plan=plan,
                                    max_batch=8) as svc:
            dense = await asyncio.gather(*[svc.submit(X, k)
                                           for X, k in zip(Xs, ks)])
            lazy = await asyncio.gather(*[svc.submit(X, 3, kind="lazy")
                                          for X in Xs[:2]])
            stoch = await asyncio.gather(*[
                svc.submit(X, 3, kind="stochastic", seed=t)
                for t, X in enumerate(Xs[:2])])
            return dense + lazy + stoch, dict(svc.stats)

    served, stats = asyncio.run(serve())
    fs = [FUNCTIONS["exemplar"](X, cfg, device="cpu") for X in Xs]
    ref = [greedy(f, k, mode=plan) for f, k in zip(fs, ks)]
    ref += [lazy_greedy(f, 3, mode=plan) for f in fs[:2]]
    ref += [stochastic_greedy(f, 3, eps=0.05, seed=t, mode=plan)
            for t, f in enumerate(fs[:2])]
    return served, ref, stats


def _staged_reuse(fs, plan):
    """Two runs on one staged (B, n/p) payload: whether the payload's seed
    came out unchanged, and whether the runs agree."""
    from repro_torch.core import engine as eng

    staged = eng.stage_selection_batch(fs, plan=plan)
    seed = staged["seed"].clone()
    r1 = run_selection_batch(fs, kind="dense", k=K, plan=plan, staged=staged)
    same_seed = torch.equal(staged["seed"], seed)
    r2 = run_selection_batch(fs, kind="dense", k=K, plan=plan, staged=staged)
    return same_seed, r1 == r2


def _evaluators(sh, backend="torch"):
    """The standalone evaluators on this rank's shards, on (n, d) data that
    p does not divide (``cuda``: the kernels' plain versions on the CPU)."""
    rng = np.random.default_rng(5)
    n, d = 1001, 12
    V = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32))
    data = torch.as_tensor(rng.normal(size=(7, 4, d)).astype(np.float32))
    lengths = torch.tensor([4, 1, 3, 2, 4, 4, 2], dtype=torch.int32)
    d_e0 = torch.sum(V * V, dim=1)
    cache = d_e0 * 0.5
    cands = V[:33]
    V_loc = distributed.shard_ground_set(V, sh)
    cfg = EvalConfig(backend=backend)
    losses = distributed.make_distributed_eval(sh, cfg)(
        V_loc, data, lengths, distributed.shard_rows(d_e0, sh), n_total=n)
    gains = distributed.make_distributed_gains(sh, cfg)(
        V_loc, cands, distributed.shard_rows(cache, sh), n_total=n)
    upd = distributed.make_distributed_cache_update(sh, cfg)(
        V_loc, V[17], distributed.shard_rows(cache, sh))
    rows = distributed.gather_shards(sh, upd).reshape(-1)[:n]
    return {"losses": losses.numpy(), "gains": gains.numpy(),
            "update": rows.numpy()}


def _axes_runs(world):
    from torch.distributed.device_mesh import init_device_mesh

    meshes = {2: init_device_mesh("cpu", (2, 2), mesh_dim_names=("a", "b")),
              3: init_device_mesh("cpu", (2, 1, 2),
                                  mesh_dim_names=("a", "r", "b"))}
    f = _function("exemplar", 1024, "torch")
    out = {}
    for case in AXES_CASES:
        mesh = meshes[3 if "r" in case else 2]
        axes = tuple(a for a in case if a != "r")
        sh = distributed.resolve_mesh(mesh, axes)
        out[case] = (_run(f, "dense", "device_sharded", mesh=mesh,
                          data_axes=axes),
                     _run(f, "lazy", "device_sharded_pool", mesh=mesh,
                          data_axes=axes), sh.p, sh.index)
    return out


def _errors(rank):
    out = {}
    f = _function("exemplar", 1024, "torch")
    try:
        greedy(f, K, mode="device_sharded", data_axes=("a", "b"))
    except ValueError as e:
        out["default mesh axes"] = str(e)
    small = FUNCTIONS["exemplar"](blobs(11, 4, centers=2, seed=1)[0],
                                  device="cpu")
    try:
        greedy(small, K, mode="greedi")
    except ValueError as e:
        out["greedi tail"] = str(e)

    async def mismatched():
        # rank r submits a ground set of its own: the buckets differ
        X = blobs(64, 4, centers=2, seed=100 + rank)[0]
        async with SelectionService(EvalConfig(), device="cpu",
                                    plan="device_sharded") as svc:
            return await svc.submit(X, 2)

    try:
        asyncio.run(mismatched())
    except RuntimeError as e:
        out["service buckets"] = str(e)
    return out


def _rank_cases(rank, world):
    """Every case of one world, on one rank."""
    torch.set_num_threads(1)
    out = {}
    funcs = {}

    def fn_of(name, n, backend):
        if (name, n, backend) not in funcs:
            funcs[name, n, backend] = _function(name, n, backend)
        return funcs[name, n, backend]

    for case in _selection_cases(world):
        name, strategy, plan, backend, n = case
        out["select", case] = _run(fn_of(name, n, backend), strategy, plan)
    for case in _greedi_cases(world):
        name, backend, n = case
        out["greedi", case] = greedy(fn_of(name, n, backend), K,
                                     mode="greedi")
    tenants = {}
    for case in BATCHED_CASES:
        name, plan, strategy, backend = case
        if (name, backend) not in tenants:
            tenants[name, backend] = _tenants(name, backend)
        out["batched", case] = _batched(tenants[name, backend], plan,
                                        strategy)
    for plan in PLANS:
        out["service", plan] = _service(plan)
        out["staged_reuse", plan] = _staged_reuse(
            tenants["exemplar", "cuda"], plan)
    X, _ = blobs(1024, 24, centers=12, seed=13)
    out["distributed_greedy"] = distributed.distributed_greedy(
        None, X, K, EvalConfig(backend="cuda"), device="cpu")
    sh = distributed.resolve_mesh(None, ("data",))
    out["evaluators"] = _evaluators(sh)
    out["evaluators", "cuda"] = _evaluators(sh, "cuda")
    out["mesh"] = (sh.p, sh.index, sh.tiles_per_memory("cpu"))
    out["errors"] = _errors(rank)
    if world == 4:
        out["axes"] = _axes_runs(world)
    return out


_WORLDS: dict = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``world(p)``: every rank's results of the p-rank spawn (one spawn
    per world size, run the first time a test asks for it)."""
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
    """``reference(name, strategy, n)``: the JAX package's single-device
    device plan on the same problem, jnp backend."""
    import jax.numpy as jnp

    from repro.core import EvalConfig as JCfg
    from repro.core import optimizers as jopt
    from repro.core.functions import FUNCTIONS as JFUNCTIONS

    def get(name, strategy, n):
        key = (name, strategy, n)
        if key not in _REFS:
            X, _ = blobs(n, 24, centers=12, seed=13)
            if name == "exemplar":
                jf = JFUNCTIONS[name](jnp.asarray(X), JCfg())
            else:
                jf = JFUNCTIONS[name](jnp.asarray(X) / 10.0,
                                      JCfg(distance="rbf"))
            run = {"dense": lambda: jopt.greedy(jf, K, mode="device"),
                   "stochastic": lambda: jopt.stochastic_greedy(
                       jf, K, eps=0.05, seed=3, mode="device"),
                   "lazy": lambda: jopt.lazy_greedy(jf, K, mode="device")}
            _REFS[key] = run[strategy]()
        return _REFS[key]
    return get


def _same_on_every_rank(ranks, key):
    r0 = ranks[0][key]
    for r in ranks[1:]:
        assert r[key] == r0
    return r0


def _close(got, ref):
    assert got.indices == ref.indices
    assert got.evaluations == ref.evaluations
    np.testing.assert_allclose(got.trajectory, ref.trajectory, rtol=1e-5,
                               atol=1e-5 * max(1.0, abs(ref.value)))
    assert got.value == pytest.approx(ref.value, rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("p,case", [(p, c) for p in WORLDS
                                    for c in _selection_cases(p)],
                         ids=lambda v: "-".join(map(str, v))
                         if isinstance(v, tuple) else f"p{v}")
def test_selection_matches_reference_device_plan(world, reference, p, case):
    name, strategy, _plan, _backend, n = case
    got = _same_on_every_rank(world(p), ("select", case))
    ref = reference(name, strategy, n)
    assert len(set(got.indices)) == K
    _close(got, ref)


@pytest.mark.parametrize("p,case", [(p, c) for p in WORLDS
                                    for c in _greedi_cases(p)],
                         ids=lambda v: "-".join(map(str, v))
                         if isinstance(v, tuple) else f"p{v}")
def test_greedi_bound_and_accounting(world, reference, p, case):
    """GreeDi: at least (1 − 1/e)² of centralized greedy's value, and
    exact accounting: p partitions of n/p candidates over k dense rounds,
    the merge round over the p·k gathered candidates, and the p·k folds
    that value each partition's solution globally."""
    name, _backend, n = case
    got = _same_on_every_rank(world(p), ("greedi", case))
    base = reference(name, "dense", n)
    assert len(got.indices) == K and len(set(got.indices)) == K
    assert all(0 <= i < n for i in got.indices)
    assert got.value >= (1.0 - 1.0 / math.e) ** 2 * base.value
    assert got.trajectory == sorted(got.trajectory)
    np.testing.assert_allclose(got.trajectory[-1], got.value, atol=1e-6)
    n_loc = n // p
    expect = p * sum(n_loc - t for t in range(K)) \
        + sum(p * K - t for t in range(K)) + p * K
    assert got.evaluations == expect


@pytest.mark.parametrize("p,case", [(p, c) for p in WORLDS
                                    for c in BATCHED_CASES],
                         ids=lambda v: "-".join(map(str, v))
                         if isinstance(v, tuple) else f"p{v}")
def test_batched_sharded_request_is_its_unbatched_call(world, p, case):
    """Each request of a (B, n/p) bucket is bit for bit its unbatched call
    under the same plan: indices, trajectory and evaluations (ragged k,
    with an inert k = 0 slot, on the dense and lazy buckets)."""
    got, ref = _same_on_every_rank(world(p), ("batched", case))
    assert len(got) == B
    assert got == ref


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("p", WORLDS)
def test_batched_sharded_staged_payload_is_read_only(world, p, plan):
    """The batched mesh plans' fused rounds write copies of the staged
    seed: a second run on the same staged payload gives the same result."""
    assert _same_on_every_rank(world(p), ("staged_reuse", plan)) == \
        (True, True)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("p", WORLDS)
def test_selection_service_on_a_mesh_plan(world, p, plan):
    """The service dispatches each signature bucket once across the mesh,
    and every served result is bit for bit its unbatched call."""
    served, ref, stats = _same_on_every_rank(world(p), ("service", plan))
    assert served == ref
    assert stats["requests"] == 10 and stats["batched_requests"] == 10
    assert stats["dispatches"] == 5   # k buckets 1, 2, 4; lazy; stochastic


@pytest.mark.parametrize("p", WORLDS)
def test_distributed_greedy_matches_reference(world, reference, p):
    indices, value = _same_on_every_rank(world(p), "distributed_greedy")
    ref = reference("exemplar", "dense", 1024)
    assert indices == ref.indices
    assert value == pytest.approx(ref.value, rel=1e-5)


@pytest.mark.parametrize("p", WORLDS)
def test_standalone_evaluators_match_reference(world, p):
    """``make_distributed_eval`` / ``_gains`` / ``_cache_update`` on the
    shards of a ground set p does not divide, against the reference's
    single-device multiset evaluation and gain formula."""
    _check_evaluators(world(p), "evaluators")


@pytest.mark.parametrize("p", WORLDS)
def test_standalone_evaluators_cuda_backend_match_reference(world, p):
    """The same on the ``cuda`` backend: each rank's partials come from the
    exemplar-eval and gain kernels' entry points with the global n (their
    plain versions here, on CPU tensors)."""
    _check_evaluators(world(p), ("evaluators", "cuda"))


def _check_evaluators(ranks, key):
    import jax.numpy as jnp

    from repro.core import distances as jdist
    from repro.core.evaluator import EvalConfig as JCfg
    from repro.core.evaluator import evaluate_multiset
    from repro.core.functions import gains_formula
    from repro.core.multiset import PackedMultiset
    from repro.core.precision import resolve

    got = ranks[0][key]
    for r in ranks[1:]:
        for k in got:
            np.testing.assert_array_equal(r[key][k], got[k])
    rng = np.random.default_rng(5)
    n, d = 1001, 12
    V = rng.normal(size=(n, d)).astype(np.float32)
    data = rng.normal(size=(7, 4, d)).astype(np.float32)
    lengths = np.array([4, 1, 3, 2, 4, 4, 2], np.int32)
    d_e0 = np.sum(V * V, axis=1)
    cache = d_e0 * 0.5
    losses = evaluate_multiset(
        jnp.asarray(V), PackedMultiset(jnp.asarray(data),
                                       jnp.asarray(lengths)),
        JCfg(), d_e0=jnp.asarray(d_e0))
    pair = jdist.resolve_pairwise("sqeuclidean")
    gains = gains_formula(jnp.asarray(V), jnp.asarray(V[:33]),
                          jnp.asarray(cache), pair, resolve("fp32"))
    upd = np.minimum(cache, np.asarray(pair(jnp.asarray(V),
                                            jnp.asarray(V[17:18]),
                                            resolve("fp32"))[:, 0]))
    np.testing.assert_allclose(got["losses"], np.asarray(losses), rtol=1e-5)
    np.testing.assert_allclose(got["gains"], np.asarray(gains), rtol=1e-5)
    np.testing.assert_allclose(got["update"], upd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p", WORLDS)
def test_mesh_geometry_and_errors(world, p):
    """Shard indices are the ranks' own, every CPU rank shares one memory,
    a multi-axis split needs an explicit mesh, GreeDi refuses a last shard
    with fewer than k real rows, and the service refuses to dispatch when
    the ranks formed different buckets."""
    ranks = world(p)
    assert sorted(r["mesh"][1] for r in ranks) == list(range(p))
    assert all(r["mesh"] == (p, i, p) for i, r in enumerate(ranks))
    errors = [r["errors"] for r in ranks]
    assert all("explicit DeviceMesh" in e["default mesh axes"]
               for e in errors)
    if p == 1:
        assert all("greedi tail" not in e and "service buckets" not in e
                   for e in errors)
    else:
        assert all("fewer than k" in e["greedi tail"] for e in errors)
        assert all("different buckets" in e["service buckets"]
                   for e in errors)


@pytest.mark.parametrize("axes", AXES_CASES, ids="".join)
def test_explicit_mesh_axes(world, reference, axes):
    """A 2 × 2 DeviceMesh: sharding over both axes (in either order) or
    over one (the other replicates the work) gives the device plan's
    selections; the shard index is row-major over the named axes. On a
    2 × 1 × 2 mesh sharded over its first and last axes the data group is
    a process group of its own."""
    ranks = world(4)
    dense, lazy, p, _ = ranks[0]["axes"][axes]
    for r in ranks[1:]:
        assert r["axes"][axes][:3] == (dense, lazy, p)
    assert p == (2 if len(axes) == 1 else 4)
    # the rank at mesh coordinate (a, b) is 2a + b
    index = {rank: r["axes"][axes][3] for rank, r in enumerate(ranks)}
    coord = {rank: divmod(rank, 2) for rank in range(4)}
    for rank, (a, b) in coord.items():
        want = {("a", "b"): 2 * a + b, ("b", "a"): 2 * b + a, ("a",): a,
                ("a", "b", "r"): 2 * a + b}[axes]
        assert index[rank] == want
    _close(dense, reference("exemplar", "dense", 1024))
    _close(lazy, reference("exemplar", "lazy", 1024))
