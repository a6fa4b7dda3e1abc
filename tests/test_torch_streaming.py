"""The port's streaming path against the JAX package's, on the CPU.

The sieve kernels run as their plain versions here (CPU tensors); the
reference runs its Pallas kernels in interpret mode. The same numpy-made
inputs go through both packages:

* ``ops.sieve_gains`` / ``sieve_gains_batched`` on ragged (r, n), both
  templates, within rtol 1e-6 (fp32 sums in another order); with the seed
  as its own operand (``seed=``) against the reference on the concatenated
  table, and bit for bit the port's concatenated call; the seed's checks;
  one ``cuda``-backend element step with the seed operand bit for bit the
  step that scored the concatenated table;
* one ``_element_step`` from a reference mid-stream table carried across by
  ``convert.sieve_state_from_arrays``: integer fields equal, caches,
  ``m_seen`` and ``lb`` within 1e-6;
* sieve / pp / salsa × host / device × backends ``torch`` / ``cuda`` against
  the reference's ``jnp`` / ``pallas_interpret`` on the fixture of
  ``tests/test_streaming_engine.py`` and at n = 1 024: identical indices and
  evaluations, values within 1e-5; ``three_sieves`` likewise;
* the reference's engine and ingestion-service scenarios on the port, and
  the port's twin of ``tests/test_sieve_kernel_property.py`` (the ``torch``
  and ``cuda`` tables bit-identical on a dyadic grid), over fixed seeds.
"""
import asyncio
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import EvalConfig as JCfg  # noqa: E402
from repro.core import ExemplarClustering as JEC  # noqa: E402
from repro.core import StreamIngestionService as JStreamService  # noqa: E402
from repro.core import optimizers as jopt  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (EvalConfig, ExemplarClustering,  # noqa: E402
                              StreamIngestionService, greedy, salsa,
                              sieve_streaming, three_sieves)
from repro_torch.core import optimizers as topt  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.core.functions import SIM_ALPHA, SIM_BETA  # noqa: E402
from repro_torch.data.synthetic import blobs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

#: port backend → the JAX backend it is held against
BACKENDS = {"torch": "jnp", "cuda": "pallas_interpret"}
ALGS = ("sieve_streaming", "sieve_streaming_pp", "salsa")
_FUNCS: dict = {}


def _pair(backend, n=300, d=16, centers=8, seed=1):
    """The same problem in both packages (shared across tests)."""
    key = (backend, n, d, centers, seed)
    if key not in _FUNCS:
        X, _ = blobs(n, d, centers=centers, seed=seed)
        jb = BACKENDS[backend]
        _FUNCS[key] = (
            convert.exemplar_from_arrays(X, None, {"backend": jb},
                                         device="cpu"),
            JEC(jnp.asarray(X), JCfg(backend=jb)))
    return _FUNCS[key]


@pytest.fixture(scope="module")
def f():
    return _pair("torch")[0]


def _same(got, ref, atol=1e-5):
    assert got.indices == ref.indices
    assert got.evaluations == ref.evaluations
    np.testing.assert_allclose(got.value, ref.value, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# The sieve kernels' wrappers
# ---------------------------------------------------------------------------


def _sieve_operands(rng, lead, r, n, fold):
    """A table and distance rows on which the relu clips some terms and
    not others, under either template; column 0 scores > 0 in every row."""
    d = rng.uniform(0.0, 2.0, size=(*lead, n)).astype(np.float32)
    if fold == "min":
        T = d[..., None, :] + rng.uniform(-0.3, 1.0, size=(*lead, r, n))
        T[..., 0] = d[..., None, 0] + 0.5
    else:
        T = rng.uniform(0.0, 0.8, size=(*lead, r, n))
        d[..., 0], T[..., 0] = 0.5, 0.0    # α + β·0.5 − 0 = 0.75
    return T.astype(np.float32), d


@pytest.mark.parametrize("fold", ["min", "max"])
@pytest.mark.parametrize("r,n,n_total", [(1, 1, None), (35, 257, None),
                                         (65, 1000, 3000)])
def test_sieve_gains_match_reference(r, n, n_total, fold):
    rng = np.random.default_rng(r * 7 + n)
    T, d = _sieve_operands(rng, (), r, n, fold)
    aff = (SIM_ALPHA, SIM_BETA) if fold == "max" else None
    got = ops.sieve_gains(torch.tensor(T), torch.tensor(d), n_total=n_total,
                          fold=fold, score_affine=aff)
    ref = jops.sieve_gains(jnp.asarray(T), jnp.asarray(d), n_total=n_total,
                           interpret=True, fold=fold, score_affine=aff)
    assert got.shape == (r,) and got.dtype == torch.float32
    assert float(got.max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("fold", ["min", "max"])
@pytest.mark.parametrize("P", [1, 3])
def test_sieve_gains_batched_match_reference(P, fold):
    rng = np.random.default_rng(P)
    T, d = _sieve_operands(rng, (P,), 35, 257, fold)
    aff = (SIM_ALPHA, SIM_BETA) if fold == "max" else None
    Tt, dt = torch.tensor(T), torch.tensor(d)
    got = ops.sieve_gains_batched(Tt, dt, fold=fold, score_affine=aff)
    ref = jops.sieve_gains_batched(jnp.asarray(T), jnp.asarray(d),
                                   interpret=True, fold=fold,
                                   score_affine=aff)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    for p in range(P):  # each partition is its own unbatched call
        assert torch.equal(got[p], ops.sieve_gains(Tt[p], dt[p], fold=fold,
                                                   score_affine=aff))


def test_sieve_gain_wrappers_validate_operands():
    from repro_torch.kernels import marginal_gain as mg

    T, d = torch.zeros(3, 5), torch.zeros(5)
    with pytest.raises(ValueError, match="fold"):
        mg._check_sieve_operands(T, d, "sum", None, batched=False)
    with pytest.raises(ValueError, match="affine"):
        mg._check_sieve_operands(T, d, "max", None, batched=False)
    with pytest.raises(ValueError, match="expected"):
        mg._check_sieve_operands(T, torch.zeros(4), "min", None,
                                 batched=False)
    with pytest.raises(ValueError, match="float32"):
        mg._check_sieve_operands(T.double(), d, "min", None, batched=False)
    with pytest.raises(ValueError, match="contiguous"):
        mg._check_sieve_operands(torch.zeros(5, 3).T, d, "min", None,
                                 batched=False)


def _seeded(rng, lead, r, n, fold):
    """A seed row, r cache rows (r = 0 allowed) and distance rows; the seed
    is partition 0's first row, in front of every partition's table."""
    T, d = _sieve_operands(rng, lead, r + 1, n, fold)
    seed = T[(0,) * len(lead) + (0,)].copy()
    caches = np.ascontiguousarray(T[..., 1:, :])
    full = np.concatenate([np.broadcast_to(seed, (*lead, 1, n)), caches],
                          axis=-2)
    return seed, caches, full, d


@pytest.mark.parametrize("fold", ["min", "max"])
@pytest.mark.parametrize("r,n", [(0, 3), (34, 257), (64, 1001), (7, 1024)])
def test_sieve_gains_with_seed_match_reference(r, n, fold):
    """``seed=`` scores the seed as row 0 of the output: within rtol 1e-6 of
    the reference on the concatenated table, and bit for bit the port's own
    call on that table (the plain version concatenates, so the CPU keeps
    the bits it had before the seed became an operand)."""
    rng = np.random.default_rng(100 * r + n)
    seed, caches, full, d = _seeded(rng, (), r, n, fold)
    aff = (SIM_ALPHA, SIM_BETA) if fold == "max" else None
    kw = dict(fold=fold, score_affine=aff)
    got = ops.sieve_gains(torch.tensor(caches), torch.tensor(d),
                          seed=torch.tensor(seed), **kw)
    ref = jops.sieve_gains(jnp.asarray(full), jnp.asarray(d), interpret=True,
                           **kw)
    assert got.shape == (r + 1,) and got.dtype == torch.float32
    assert float(got.min()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    assert torch.equal(got, ops.sieve_gains(torch.tensor(full),
                                            torch.tensor(d), **kw))


@pytest.mark.parametrize("fold", ["min", "max"])
@pytest.mark.parametrize("P,n", [(1, 257), (3, 1001)])
def test_sieve_gains_batched_with_seed_match_reference(P, n, fold):
    """One seed row shared by every partition (stride 0): the reference on
    the concatenated tables within rtol 1e-6, the port's concatenated call
    bit for bit, and each partition its own unbatched ``seed=`` call."""
    rng = np.random.default_rng(P * 31 + n)
    seed, caches, full, d = _seeded(rng, (P,), 34, n, fold)
    aff = (SIM_ALPHA, SIM_BETA) if fold == "max" else None
    kw = dict(fold=fold, score_affine=aff)
    Tt, dt, st = torch.tensor(caches), torch.tensor(d), torch.tensor(seed)
    got = ops.sieve_gains_batched(Tt, dt, seed=st, **kw)
    ref = jops.sieve_gains_batched(jnp.asarray(full), jnp.asarray(d),
                                   interpret=True, **kw)
    assert got.shape == (P, 35)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    assert torch.equal(got, ops.sieve_gains_batched(torch.tensor(full), dt,
                                                    **kw))
    for p in range(P):
        assert torch.equal(got[p], ops.sieve_gains(Tt[p], dt[p], seed=st,
                                                   **kw))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("bad,match", [
    (lambda n: torch.zeros(n + 1), "seed must be one"),
    (lambda n: torch.zeros(1, n), "seed must be one"),
    (lambda n: torch.zeros(n, dtype=torch.float64), "float32"),
    (lambda n: torch.zeros(2 * n)[::2], "contiguous"),
    (lambda n: torch.zeros(n, device="meta"), "seed is on"),
], ids=["length", "rank", "dtype", "stride", "device"])
def test_sieve_seed_operand_is_validated(bad, match, batched):
    from repro_torch.kernels import marginal_gain as mg

    T = torch.zeros((2, 3, 5) if batched else (3, 5))
    d = torch.zeros(T.shape[:-2] + (5,))
    assert mg._check_sieve_operands(T, d, "min", None, batched=batched,
                                    seed=torch.zeros(5)) == (0, 0.0, 0.0)
    with pytest.raises(ValueError, match=match):
        mg._check_sieve_operands(T, d, "min", None, batched=batched,
                                 seed=bad(5))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("variant", ["sieve", "pp", "salsa"])
def test_element_step_seed_operand_keeps_the_state(variant, batched,
                                                   monkeypatch):
    """One ``cuda``-backend element step from a converted reference table
    (after 40 elements) reaches, field for field and bit for bit, the state
    it reached when it scored the concatenated table ``cat([seed,
    caches])`` (the step before the seed became the kernel's operand)."""
    tf, jf = _pair("cuda")
    V = np.asarray(jf.V)
    order = np.random.default_rng(6).permutation(tf.n)
    jeng = jst.make_sieve_engine(jf, 4, 0.15, variant=variant, mode="device",
                                 block_size=16, backend="jnp")
    jeng.offer(order[:40], V[order[:40]])
    fields = {k: np.asarray(v) for k, v in jeng.state._asdict().items()}
    dmat = tf.point_distances_block(torch.tensor(V[order[40:42]])).float()
    spec = tst.make_spec(4, 0.15, variant, backend="cuda", fn=tf.spec)
    c = tst.step_consts(tf, spec)
    lead = (2,) if batched else ()

    def step():
        st = convert.sieve_state_from_arrays(fields, device="cpu")
        if batched:
            st = tst.SieveState(*(torch.stack([x, x]) for x in st))
        idx = torch.tensor(order[40:42] if batched else order[40],
                           dtype=torch.int32)
        return tst._element_step(spec, c, st, idx,
                                 dmat if batched else dmat[0],
                                 torch.ones(lead, dtype=torch.bool))

    new, acc = step()

    def concatenated(gains_of):
        def call(caches, dvec, *, seed, **kw):
            table = torch.cat([seed.expand(*caches.shape[:-2], 1,
                                           seed.shape[0]), caches], dim=-2)
            return gains_of(table, dvec, **kw)
        return call

    monkeypatch.setattr(ops, "sieve_gains", concatenated(ops.sieve_gains))
    monkeypatch.setattr(ops, "sieve_gains_batched",
                        concatenated(ops.sieve_gains_batched))
    old, old_acc = step()
    assert torch.equal(acc, old_acc)
    for name in tst.SieveState._fields:
        assert torch.equal(getattr(new, name), getattr(old, name)), name


# ---------------------------------------------------------------------------
# One element step from a reference mid-stream table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("variant", ["sieve", "pp", "salsa"])
def test_element_step_from_reference_state(variant, backend):
    """Carry a reference table across mid-stream (after 40 elements) and
    take the next step that accepts somewhere in both packages."""
    tf, jf = _pair(backend)
    V = np.asarray(jf.V)
    order = np.random.default_rng(5).permutation(tf.n)
    jeng = jst.make_sieve_engine(jf, 4, 0.15, variant=variant, mode="device",
                                 block_size=16, backend=BACKENDS[backend])
    jeng.offer(order[:40], V[order[:40]])
    state = jeng.state
    dmat = np.asarray(jf.point_distances_block(jnp.asarray(V[order])),
                      np.float32)
    for j in range(40, tf.n):   # the next element some sieve accepts
        new, acc = jst._element_step_jit(
            state, jf.cache_seed, jnp.int32(order[j]), jnp.asarray(dmat[j]),
            True, spec=jeng.spec, row_aux=jf.row_aux)
        if bool(acc):
            break
        state = new
    assert bool(acc)
    spec = tst.make_spec(4, 0.15, variant, backend=backend, fn=tf.spec)
    assert spec.s_max == jeng.spec.s_max
    assert spec.log1p_eps == jeng.spec.log1p_eps
    tstate = convert.sieve_state_from_arrays(
        {k: np.asarray(v) for k, v in state._asdict().items()}, device="cpu")
    tnew, tacc = tst._element_step(
        spec, tst.step_consts(tf, spec), tstate,
        torch.tensor(order[j], dtype=torch.int32), torch.tensor(dmat[j]),
        torch.tensor(True))
    assert bool(tacc)
    for name in ("slot_exp", "active", "sizes", "members", "evals"):
        np.testing.assert_array_equal(getattr(tnew, name).numpy(),
                                      np.asarray(getattr(new, name)),
                                      err_msg=name)
    for name in ("caches", "m_seen", "lb"):
        np.testing.assert_allclose(getattr(tnew, name).numpy(),
                                   np.asarray(getattr(new, name)),
                                   rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("policy", [None, "bf16"])
def test_point_distance_hooks_match_reference(policy):
    """``point_distances_block`` (with its policy override) and
    ``point_distances`` against the reference's hooks."""
    tf, jf = _pair("torch")
    X = np.asarray(jf.V)[:7] + 0.25
    got = tf.point_distances_block(X, policy=policy)
    ref = np.asarray(jf.point_distances_block(jnp.asarray(X), policy=policy),
                     np.float32)
    assert got.shape == (7, tf.n) and got.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-2 if policy
                               else 1e-5, atol=1e-4)
    one = tf.point_distances(torch.tensor(X[3]))
    np.testing.assert_allclose(
        one.numpy(), np.asarray(jf.point_distances(jnp.asarray(X[3]))),
        rtol=1e-5, atol=1e-4)


def test_sieve_state_conversion_validates_fields():
    with pytest.raises(ValueError, match="missing"):
        convert.sieve_state_from_arrays({"caches": np.zeros((4, 3))},
                                        device="cpu")


# ---------------------------------------------------------------------------
# The sieve family against the reference
# ---------------------------------------------------------------------------


def _run(pkg, alg, fn, mode, **kw):
    return getattr(pkg, alg)(fn, kw.pop("k", 6), eps=0.1, mode=mode,
                             **{"seed": 2, **kw})


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("mode", ["host", "device"])
@pytest.mark.parametrize("alg", ALGS)
def test_sieve_family_matches_reference(alg, mode, backend):
    tf, jf = _pair(backend)
    _same(_run(topt, alg, tf, mode), _run(jopt, alg, jf, mode))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("alg", ALGS)
def test_sieve_family_matches_reference_at_1024(alg, backend):
    """n = 1 024 (the size of the reference's at-scale parity test): both
    plans of the port against the reference's device plan (which the
    reference holds equal to its host plan)."""
    tf, jf = _pair(backend, n=1024, d=24, centers=12, seed=13)
    kw = dict(k=8, seed=5, block_size=128)
    ref = _run(jopt, alg, jf, "device", **dict(kw))
    for mode in ("host", "device"):
        _same(_run(topt, alg, tf, mode, **dict(kw)), ref)


@pytest.mark.parametrize("T", [10, 50])
def test_three_sieves_matches_reference(T):
    tf, jf = _pair("torch")
    got = three_sieves(tf, 6, eps=0.1, T=T, seed=3)
    _same(got, jopt.three_sieves(jf, 6, eps=0.1, T=T, seed=3))
    assert len(got.indices) <= 6
    if T == 10:  # the sieve fills, and later elements are not scored
        assert len(got.indices) == 6 and got.evaluations < tf.n


def test_host_device_and_block_size_invariance(f):
    """Blocking changes dispatch, not decisions: block sizes (a ragged tail
    included) and both plans agree on members and evaluations."""
    runs = [sieve_streaming(f, 5, eps=0.1, seed=2, mode="device",
                            block_size=b) for b in (1, 64, 97, 300)]
    runs.append(sieve_streaming(f, 5, eps=0.1, seed=2, mode="host",
                                block_size=41))
    assert all(r.indices == runs[0].indices for r in runs)
    assert all(r.evaluations == runs[0].evaluations for r in runs)


def test_capacity_validation(f):
    with pytest.raises(ValueError, match="s_max"):
        sieve_streaming(f, 6, eps=0.1, s_max=2)
    with pytest.raises(ValueError, match="k >= 1"):
        sieve_streaming(f, 0)
    with pytest.raises(ValueError, match="mode"):
        sieve_streaming(f, 3, mode="sharded")
    with pytest.raises(ValueError, match="backend"):
        tst.make_sieve_engine(f, 3, 0.1, backend="pallas")
    with pytest.raises(ValueError, match="sieve-streamable"):
        tst.make_sieve_engine(convert.function_from_arrays(
            "graph_cut", np.asarray(f.V), device="cpu"), 3, 0.1)
    assert tst.default_capacity(6, 0.1, "salsa") > \
        tst.default_capacity(6, 0.1, "sieve")
    assert tst.default_capacity(10, 0.1, "sieve") == \
        jst.default_capacity(10, 0.1, "sieve") == 34
    assert tst.default_capacity(10, 0.1, "salsa") == 64


@pytest.mark.parametrize("mode", ["device_sharded", "mesh"])
def test_mesh_sieve_plan_is_refused_by_name(f, mode):
    """The sharded sieve with no process group raises, naming the call that
    initialises one (the plan itself: tests/test_torch_sieve_sharded.py)."""
    kw = dict(mode="device", mesh=object()) if mode == "mesh" \
        else dict(mode=mode)
    with pytest.raises(RuntimeError, match="init_process_group"):
        sieve_streaming(f, 3, **kw)


def test_salsa_capacity_eviction_matches_reference():
    """Salsa's grow-only grid squeezed into a sieve-sized table evicts the
    lowest exponent — identically in both plans and both packages."""
    tf, jf = _pair("torch", n=200, d=8, centers=6, seed=3)
    cap = tst.default_capacity(4, 0.1, "sieve")
    ref = jopt.salsa(jf, 4, seed=6, mode="device", s_max=cap)
    for mode in ("host", "device"):
        got = salsa(tf, 4, seed=6, mode=mode, s_max=cap)
        _same(got, ref)
        assert got.value > 0


def test_saturated_coverage_scores_through_torch_on_cuda_backend():
    """A function with no kernel form normalizes the sieve backend to torch
    (the reference's semantics) and still matches the reference."""
    X, _ = blobs(120, 8, centers=4, seed=2)
    cfg = {"backend": "pallas_interpret"}
    tf = convert.function_from_arrays("saturated_coverage", X, None, cfg,
                                      device="cpu", sat=0.25)
    from repro.core import SaturatedCoverage as JSat

    jf = JSat(jnp.asarray(X), JCfg(backend="pallas_interpret"), sat=0.25)
    eng = tst.make_sieve_engine(tf, 4, 0.1)
    assert eng.spec.backend == "torch"
    _same(sieve_streaming(tf, 4, seed=1, mode="device"),
          jopt.sieve_streaming(jf, 4, seed=1, mode="device"))


def test_salsa_k1_applies_early_rate():
    """The dense schedule's early 1/2 rate applies to the first ⌈k/2⌉
    members — also at k = 1."""
    V = np.full((6, 3), 2.0, np.float32)
    fn = ExemplarClustering(V, device="cpu")
    spec = tst.make_spec(1, 0.1, "salsa")
    c = tst.step_consts(fn, spec)
    st0 = tst.init_state(6, spec, "cpu")
    slot_exp, active = st0.slot_exp.clone(), st0.active.clone()
    slot_exp[0], active[0] = 0, True

    def state():
        # one armed sieve at τ = 1, fresh cache, grid frozen (m_seen high)
        return st0._replace(
            caches=fn.d_e0[None, :].repeat(spec.s_max, 1).clone(),
            slot_exp=slot_exp, active=active,
            m_seen=torch.tensor(100.0))

    one = torch.tensor(0, dtype=torch.int32)
    yes = torch.tensor(True)
    # gain 0.3 sits between the late rate 1/(2e)·τ ≈ 0.18 and τ/2: reject
    new, acc = tst._element_step(spec, c, state(), one, fn.d_e0 - 0.3, yes)
    assert not bool(acc) and int(new.sizes[0]) == 0
    _, acc = tst._element_step(spec, c, state(), one, fn.d_e0 - 0.6, yes)
    assert bool(acc)


def test_salsa_k1_end_to_end(f):
    res = salsa(f, 1, seed=4)
    assert len(res.indices) == 1
    assert res.value >= 0.5 * greedy(f, 1).value


# ---------------------------------------------------------------------------
# Twin of the reference's dyadic-grid property: torch vs cuda-plain tables
# ---------------------------------------------------------------------------

N_GRID, D_GRID = 64, 6   # n a power of two → the /n mean is exact


def _grid_ground_set(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 129, size=(N_GRID, D_GRID)) / 32.0
            ).astype(np.float32)


def _tables_both(V, order, k, eps, variant, s_max, block_size):
    f = ExemplarClustering(V, device="cpu")
    out = []
    for backend in ("torch", "cuda"):
        eng = tst.make_sieve_engine(f, k, eps, variant=variant, mode="device",
                                    s_max=s_max, block_size=block_size,
                                    backend=backend)
        eng.offer(order, V[order])
        out.append(eng)
    return out


def _assert_tables_identical(et, ec):
    assert et.evaluations() == ec.evaluations()
    assert et.best() == ec.best()
    for name in tst.SieveState._fields:
        assert torch.equal(getattr(et.state, name), getattr(ec.state, name)), \
            name


@pytest.mark.parametrize("seed,k,eps,variant,block_size", [
    (0, 1, 0.1, "sieve", 1), (11, 2, 0.25, "sieve", 17),
    (22, 4, 0.5, "sieve", 64), (33, 3, 0.1, "pp", 17),
    (44, 1, 0.25, "pp", 64), (55, 4, 0.5, "pp", 1),
    (66, 2, 0.1, "salsa", 64), (77, 4, 0.25, "salsa", 1),
    (88, 3, 0.5, "salsa", 17),
])
def test_dyadic_grid_torch_and_cuda_tables_bit_identical(seed, k, eps,
                                                          variant,
                                                          block_size):
    V = _grid_ground_set(seed)
    order = np.random.default_rng(seed + 1).permutation(N_GRID)
    _assert_tables_identical(*_tables_both(V, order, k, eps, variant, None,
                                           block_size))


@pytest.mark.parametrize("seed,k", [(1, 2), (2, 3), (3, 4)])
def test_dyadic_grid_tables_bit_identical_under_eviction(seed, k):
    V = _grid_ground_set(seed)
    # ascending norms: every element a new max, the window climbs past s_max
    order = np.argsort((V ** 2).sum(axis=1), kind="stable")
    cap = tst.default_capacity(k, 0.1, "sieve")
    _assert_tables_identical(*_tables_both(V, order, k, 0.1, "salsa", cap,
                                           32))


# ---------------------------------------------------------------------------
# Engine mechanics
# ---------------------------------------------------------------------------


def test_overlap_parity(f):
    """The overlapped offer and the serialized one give identical accepts,
    members, value and evaluation counts."""
    stream = np.random.default_rng(21).standard_normal((70, 16)
                                                       ).astype(np.float32)
    runs = []
    for overlap in (False, True):
        eng = tst.make_sieve_engine(f, 5, 0.1, mode="device", block_size=16,
                                    overlap=overlap, max_in_flight=2)
        acc = eng.offer(np.arange(len(stream)), stream)
        runs.append((acc.tolist(), eng.best(), eng.evaluations()))
    assert runs[0] == runs[1]
    with pytest.raises(ValueError, match="block_size"):
        tst.make_sieve_engine(f, 5, 0.1, block_size=0)
    with pytest.raises(ValueError, match="max_in_flight"):
        tst.make_sieve_engine(f, 5, 0.1, max_in_flight=0)


def test_offer_rejects_int32_overflow(f):
    """Stream ids outside the int32 member table raise, not wrap."""
    eng = tst.make_sieve_engine(f, 3, 0.2, mode="device", block_size=4)
    X1 = np.asarray(f.V)[:1]
    i_max = np.iinfo(np.int32).max
    acc = eng.offer(np.array([i_max], np.int64), X1)   # boundary id: fine
    assert bool(acc[0]) and i_max in eng.member_ids()
    with pytest.raises(OverflowError):
        eng.offer(np.array([i_max + 1], np.int64), X1)
    with pytest.raises(OverflowError):
        eng.offer(np.array([np.iinfo(np.int32).min - 1], np.int64), X1)


def test_device_engine_block_loop_makes_no_host_sync(f, monkeypatch):
    """The device engine reads nothing back inside a block or between the
    blocks of one offer: the reads per offer do not grow with the elements
    or the blocks. The host mirror reads every element's flag back."""
    calls = []
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    X = np.asarray(f.V)
    counts = {}
    for label, count in (("5 elements", 5), ("60 elements", 60),
                         ("3 blocks", 192)):
        eng = tst.make_sieve_engine(f, 4, 0.1, mode="device", block_size=64)
        calls.clear()
        eng.offer(np.arange(count), X[:count])
        counts[label] = len(calls)
    assert len(set(counts.values())) == 1, counts
    assert counts["5 elements"] <= 2
    host = tst.make_sieve_engine(f, 4, 0.1, mode="host", block_size=64)
    calls.clear()
    host.offer(np.arange(60), X[:60])
    assert calls.count("__bool__") >= 60


def test_numpy_inputs_without_a_device_raise_without_gpu():
    """Numpy inputs go to the card unless the caller names a device: with
    no GPU that raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: numpy inputs go to it")
    X, _ = blobs(40, 4, centers=2, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExemplarClustering(X, EvalConfig(backend="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.sieve_state_from_arrays(
            {name: np.zeros(1) for name in tst.SieveState._fields})


# ---------------------------------------------------------------------------
# StreamIngestionService
# ---------------------------------------------------------------------------


def test_service_matches_streaming_optimizer_and_reference(f):
    """Offering V's rows in a fixed order through the service reproduces
    ``sieve_streaming`` exactly (ids map back through the order), and so
    does the reference's service on the same stream."""
    X = np.asarray(f.V)
    order = np.random.default_rng(7).permutation(f.n)

    async def main(cls, fn):
        async with cls(fn, k=6, mode="device", block_size=32) as svc:
            await svc.offer_batch(X[order])
            await svc.drain()
            return await svc.snapshot()

    snap = asyncio.run(main(StreamIngestionService, f))
    ref = sieve_streaming(f, 6, order=order, mode="device")
    assert [int(order[i]) for i in snap.indices] == ref.indices
    assert snap.evaluations == ref.evaluations
    np.testing.assert_allclose(snap.value, ref.value, atol=1e-6)
    np.testing.assert_array_equal(snap.exemplars, X[order[snap.indices]])
    assert snap.n_ingested == f.n and snap.pending == 0
    jsnap = asyncio.run(main(JStreamService, _pair("torch")[1]))
    assert snap.indices == jsnap.indices
    assert snap.evaluations == jsnap.evaluations
    np.testing.assert_allclose(snap.value, jsnap.value, atol=1e-5)


def test_service_backpressure_and_midstream_snapshot(f):
    """A tiny pending bound forces offer-side backpressure; snapshots taken
    mid-stream observe consistent, live state."""
    X = np.asarray(f.V)

    async def main():
        svc = StreamIngestionService(f, k=5, mode="host", block_size=8,
                                     max_pending=4)
        await svc.start()
        vals = []
        for j in range(120):
            await svc.offer(X[j])
            if j in (40, 80):
                await svc.drain()
                vals.append((await svc.snapshot()).value)
        await svc.stop()  # drains the tail
        return vals, await svc.snapshot()

    vals, snap = asyncio.run(main())
    assert snap.n_offered == snap.n_ingested == 120
    assert all(v > 0 for v in vals) and snap.value > 0


def test_service_accepts_external_vectors(f):
    """Stream elements need not be ground-set rows; the port's service and
    the reference's pick the same ones."""
    rng = np.random.default_rng(11)
    base = np.asarray(f.V)[rng.choice(f.n, size=90)]
    stream = (base + 0.05 * rng.normal(size=base.shape)).astype(np.float32)

    async def main(cls, fn):
        async with cls(fn, k=4, mode="device", block_size=16) as svc:
            ids = await svc.offer_batch(stream)
            await svc.drain()
            return ids, await svc.snapshot()

    ids, snap = asyncio.run(main(StreamIngestionService, f))
    assert ids == list(range(90))
    assert 1 <= len(snap.indices) <= 4
    np.testing.assert_array_equal(snap.exemplars, stream[snap.indices])
    assert snap.n_accepted >= len(snap.indices)
    _, jsnap = asyncio.run(main(JStreamService, _pair("torch")[1]))
    assert snap.indices == jsnap.indices
    assert snap.n_accepted == jsnap.n_accepted


def test_service_rejects_int32_id_overflow(f):
    """The service's stream-id counter is unbounded; ids past the int32
    member table fail the worker, and the next call raises."""
    import itertools

    X = np.asarray(f.V)

    async def main():
        svc = StreamIngestionService(f, k=3, mode="device", block_size=4)
        await svc.start()
        svc._ids = itertools.count(np.iinfo(np.int32).max + 1)
        await svc.offer(X[0])
        with pytest.raises(RuntimeError, match="worker failed") as info:
            await svc.drain()
        await svc.stop(drain=False)
        return info.value.__cause__

    assert isinstance(asyncio.run(main()), OverflowError)


def test_snapshot_survives_worker_cancel_mid_ingest(f):
    """Cancelling the worker while an engine offer is in flight must not
    desync the engine from the retention map: the thread behind
    ``asyncio.to_thread`` runs to completion, and the retention writes ride
    the same thread."""
    X = np.asarray(f.V)
    started = threading.Event()
    finished = threading.Event()

    async def main():
        svc = StreamIngestionService(f, k=4, mode="device", block_size=8)
        await svc.start()
        orig = svc._engine.offer

        def slow_offer(ids, vecs):
            started.set()
            time.sleep(0.3)     # hold the offer so the cancel wins
            try:
                return orig(ids, vecs)
            finally:
                finished.set()

        svc._engine.offer = slow_offer
        for j in range(8):      # early elements: guaranteed accepts
            await svc.offer(X[j])
        await asyncio.to_thread(started.wait, 5.0)
        svc._task.cancel()
        await asyncio.gather(svc._task, return_exceptions=True)
        await asyncio.to_thread(finished.wait, 10.0)
        for _ in range(100):
            if svc._n_ingested >= 8:
                break
            await asyncio.sleep(0.01)
        return await svc.snapshot()

    snap = asyncio.run(main())
    assert snap.n_accepted >= 1
    assert snap.exemplars.shape[0] == len(snap.indices)


def test_cancelled_producer_leaks_no_id(f):
    """A producer cancelled while awaiting backpressure consumes no id."""
    X = np.asarray(f.V)
    busy = threading.Event()

    async def main():
        svc = StreamIngestionService(f, k=3, mode="device", block_size=1,
                                     max_pending=1)
        await svc.start()
        orig = svc._engine.offer

        def slow_offer(ids, vecs):
            busy.set()
            time.sleep(0.3)
            return orig(ids, vecs)

        svc._engine.offer = slow_offer
        assert await svc.offer(X[0]) == 0
        await asyncio.to_thread(busy.wait, 5.0)
        assert await svc.offer(X[1]) == 1   # waits out block 0
        blocked = asyncio.create_task(svc.offer(X[2]))
        await asyncio.sleep(0.05)           # let it park on backpressure
        blocked.cancel()
        await asyncio.gather(blocked, return_exceptions=True)
        await svc.drain()
        i = await svc.offer(X[3])
        await svc.drain()
        snap = await svc.snapshot()
        await svc.stop()
        return i, snap

    i, snap = asyncio.run(main())
    assert i == 2
    assert snap.n_offered == snap.n_ingested == 3


def test_snapshot_under_load_soak(f):
    """Producers and snapshot consumers race: counters stay monotone and
    every snapshot is internally consistent."""
    rng = np.random.default_rng(23)
    stream = np.asarray(f.V)[rng.choice(f.n, size=240)]
    stream = (stream + 0.02 * rng.normal(size=stream.shape)
              ).astype(np.float32)

    async def main():
        async with StreamIngestionService(f, k=5, mode="device",
                                          block_size=8,
                                          max_pending=16) as svc:
            done = asyncio.Event()
            seen: list[tuple] = []

            async def producer():
                for x in stream:
                    await svc.offer(x)
                await svc.drain()
                done.set()

            async def snapper():
                last = (0, 0, 0)
                while not done.is_set():
                    snap = await svc.snapshot()
                    cur = (snap.n_offered, snap.n_ingested, snap.n_accepted)
                    assert cur >= last
                    assert snap.n_offered >= snap.n_ingested
                    assert snap.exemplars.shape == (len(snap.indices), f.dim)
                    last = cur
                    seen.append(cur)
                    await asyncio.sleep(0)

            await asyncio.gather(producer(), snapper(), snapper())
            return seen, await svc.snapshot()

    seen, snap = asyncio.run(main())
    assert len(seen) > 2
    assert snap.n_offered == snap.n_ingested == len(stream)
    assert snap.value > 0


def test_service_lifecycle_errors(f):
    svc = StreamIngestionService(f, k=3, mode="device")

    async def main():
        with pytest.raises(RuntimeError, match="never started"):
            await svc.snapshot()
        with pytest.raises(RuntimeError, match="not started"):
            await svc.offer(np.zeros(f.dim))
        await svc.start()
        with pytest.raises(RuntimeError, match="already started"):
            await svc.start()
        await svc.stop()

    asyncio.run(main())
