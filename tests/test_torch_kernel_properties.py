"""The reference's kernel property suites on the port's kernel wrappers.

Ports of ``tests/test_kernels.py`` and of the drawn half of
``tests/test_sieve_kernel_property.py``. The wrappers run their kernels'
plain versions here (CPU tensors); the card runs the kernels themselves at
these shapes in ``chip_smoke.py``'s phase 3k and in
``tests/test_torch_cuda.py``.

* At the reference suite's fixed ``SHAPES`` (n, l, k, d on and off every
  tile edge), ``ops.exemplar_eval`` in both layouts and both modes, every
  policy, the rbf transform and a chunked launch: within the reference
  suite's own tolerance of the port's math oracle, and within
  ``POLICY_TOLS`` of the reference's Pallas kernels in interpret mode.
* At drawn shapes (n ∈ [9, 150], m ∈ [1, 40], d ∈ [1, 70], B ∈ [1, 8];
  sieve tables r ∈ [1, 65], n ∈ [1, 150], P ∈ [1, 8]), ``marginal_gain``,
  ``fused_gain_update`` (both batched), ``sieve_gains`` and
  ``sieve_gains_batched`` against the reference's jnp oracles: interpret
  mode recompiles per shape, too slow to draw over.
* Launch geometry: ``KernelConfig.grid`` and ``gain_grid`` cover the work
  (the reference's grid test); shared memory is in
  ``tests/test_torch_core.py``'s ``kernel_config`` test.
* The sieve tables of the ``torch`` and ``cuda`` backends, streamed over a
  dyadic grid where every sum is exact in float32, are bit for bit the
  reference's ``pallas_interpret`` tables: caches, slot exponents, active
  slots, sizes, members, ``m_seen``, ``lb``, evaluations and the best sieve.

Hypothesis is derandomized with no example database: every run draws the
same examples.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

from hypothesis import given, settings, strategies as st  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ExemplarClustering as JEC  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro.core.functions import SIM_ALPHA, SIM_BETA  # noqa: E402
from repro.core.precision import resolve as jresolve  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import ExemplarClustering  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.core.precision import FP32  # noqa: E402
from repro_torch.core.precision import resolve as tresolve  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

#: tests/test_kernel_parity.py's per-policy bands (the port against the
#: reference at the same policy), on max(1, max|reference|).
POLICY_TOLS = {"fp32": 1e-5, "bf16": 5e-2, "fp16": 1e-2, "fp16_strict": 5e-2}
POLICIES = ("fp32", "bf16", "fp16", "fp16_strict")
#: tests/test_kernels.py's shapes (n, l, k, d).
SHAPES = [(64, 8, 3, 16), (257, 19, 7, 33), (512, 64, 10, 100),
          (100, 5, 1, 128), (96, 24, 16, 200)]
AFFINE = (SIM_ALPHA, SIM_BETA)


def _settings(n):
    return settings(max_examples=n, deadline=None, derandomize=True,
                    database=None)


def _band(got, want, band):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= band * max(1.0, float(np.max(np.abs(want), initial=0.0))), \
        err


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _problem(n, l, k, d, seed=0):
    """tests/test_kernels.py's problem, as numpy."""
    rng = np.random.default_rng(seed)
    V = (rng.normal(size=(n, d)) + 2.0).astype(np.float32)
    S = (rng.normal(size=(l, k, d)) + 2.0).astype(np.float32)
    lengths = rng.integers(1, k + 1, size=l).astype(np.int32)
    d_e0 = np.sum(V.astype(np.float32) ** 2, axis=1)
    return V, S, lengths, d_e0


def _eval_both(V, S, lengths, d_e0, **kw):
    """(port wrapper, port math oracle, reference kernel in interpret mode,
    reference oracle), each (l,)."""
    pol = kw.pop("policy", "fp32")
    gamma = kw.get("rbf_gamma")
    got = ops.exemplar_eval(_t(V), _t(S), _t(lengths, torch.int32), _t(d_e0),
                            policy=tresolve(pol), **kw)
    mine = ref.exemplar_eval_ref(_t(V), _t(S), _t(lengths, torch.int32),
                                 _t(d_e0), tresolve(pol), gamma)
    J = [jnp.asarray(a) for a in (V, S, lengths, d_e0)]
    theirs = jops.exemplar_eval(*J, policy=jresolve(pol), interpret=True, **kw)
    oracle = jref.exemplar_eval_ref(*J, policy=jresolve(pol), rbf_gamma=gamma)
    return (got.numpy(), mine.numpy(), np.asarray(theirs), np.asarray(oracle))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", ["flat", "loop"])
def test_fused_vs_oracle(shape, variant):
    got, mine, theirs, oracle = _eval_both(*_problem(*shape), mode="fused",
                                           variant=variant)
    np.testing.assert_allclose(got, mine, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
    _band(got, theirs, POLICY_TOLS["fp32"])


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_two_pass_vs_oracle(shape):
    got, mine, theirs, oracle = _eval_both(*_problem(*shape), mode="two_pass")
    np.testing.assert_allclose(got, mine, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
    _band(got, theirs, POLICY_TOLS["fp32"])


@pytest.mark.parametrize("pname", POLICIES)
def test_dtype_sweep_matches_matching_policy_oracle(pname):
    got, mine, theirs, oracle = _eval_both(*_problem(128, 16, 5, 48, seed=4),
                                           policy=pname)
    tol = 1e-5 if pname == "fp32" else 3e-2
    np.testing.assert_allclose(got, mine, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)
    _band(got, theirs, POLICY_TOLS[pname])


def test_rbf_kernel_distance():
    V, S, lengths, d_e0 = _problem(96, 12, 4, 32, seed=5)
    d_e0r = 2.0 * (1.0 - np.exp(-d_e0))
    got, mine, theirs, oracle = _eval_both(V, S, lengths, d_e0r,
                                           rbf_gamma=1.0)
    np.testing.assert_allclose(got, mine, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
    _band(got, theirs, POLICY_TOLS["fp32"])


@pytest.mark.parametrize("budget,chunks", [(400_000, 1), (30_000, 5)])
def test_chunked_kernel_equals_unchunked(budget, chunks):
    """The reference suite's budget holds all 32 sets in one chunk (in both
    packages); 30 000 bytes splits them into five, where the plain
    version's products over fewer sets add in another order (the kernel's
    columns do not depend on l: chip_smoke.py's phases 2 and 3k)."""
    from repro_torch.core.evaluator import plan_chunks

    assert len(plan_chunks(32, 128, 6, 40, FP32, "fused", budget)) == chunks
    V, S, lengths, d_e0 = _problem(128, 32, 6, 40, seed=6)
    args = (_t(V), _t(S), _t(lengths, torch.int32), _t(d_e0))
    full = ops.exemplar_eval(*args)
    chunked = ops.exemplar_eval(*args, memory_budget_bytes=budget)
    if chunks == 1:
        np.testing.assert_allclose(chunked.numpy(), full.numpy(), atol=1e-6)
    _band(chunked.numpy(), full.numpy(), POLICY_TOLS["fp32"])
    J = [jnp.asarray(a) for a in (V, S, lengths, d_e0)]
    _band(chunked.numpy(), np.asarray(jops.exemplar_eval(
        *J, interpret=True, memory_budget_bytes=budget)),
        POLICY_TOLS["fp32"])


def _gain_operands(n, m, d, B, fold):
    """The reference suite's drawn gain problem, B requests of it: the min
    fold on its normal + 1 payloads, with caches around the typical
    distance 2d (its caches in [0.5, 4] leave every gain at 0 once d passes
    a few); the max fold on payloads whose distances are O(1), where the
    similarity relu(1 − d/2) is not flat. The first candidate is the
    request's most central row and the winner half the typical distance
    from it (as chip_smoke.py's phase 3k draws them)."""
    rng = np.random.default_rng(n * 1000 + m * 10 + d)
    sigma, shift = (1.0, 1.0) if fold == "min" else ((2 * d) ** -0.5, 0.1)
    V = (rng.normal(size=(B, n, d)) * sigma + shift).astype(np.float32)
    C = (rng.normal(size=(B, m, d)) * sigma + shift).astype(np.float32)
    central = np.linalg.norm(V - V.mean(1, keepdims=True), axis=2).argmin(1)
    C[:, 0] = V[np.arange(B), central]
    cache = (rng.uniform(0.5, 1.5, size=(B, n)) * 2 * d if fold == "min"
             else rng.uniform(0.0, 0.8, size=(B, n))).astype(np.float32)
    w = (C[:, 0] + sigma * rng.choice([-1.0, 1.0], size=(B, d))).astype(
        np.float32)
    return V, C, cache, w


@functools.partial(jax.jit, static_argnames="fold")
def _gain_oracles(V, C, cache, w, fold):
    """The reference's math oracle over B requests, one compile a shape:
    gains against ``cache``, the cache with ``w`` folded in, and the gains
    against that. The max template is the affine of the same distances, as
    the reference's jnp path scores it."""
    def one(v, c, m, x):
        dw = jref._pair_sqdist(v, x[None], jresolve("fp32"))[:, 0]
        if fold == "min":
            folded = jnp.minimum(m, dw)
            return (jref.marginal_gain_ref(v, c, m), folded,
                    jref.marginal_gain_ref(v, c, folded))
        a, b = AFFINE
        s = a + b * jref._pair_sqdist(v, c, jresolve("fp32"))
        folded = jnp.maximum(m, jnp.maximum(a + b * dw, 0.0))

        def score(cache):
            return jnp.maximum(s - cache[:, None], 0.0).sum(0) / v.shape[0]

        return score(m), folded, score(folded)

    return jax.vmap(one)(V, C, cache, w)


@given(n=st.integers(9, 150), m=st.integers(1, 40), d=st.integers(1, 70),
       B=st.integers(1, 8), fold=st.sampled_from(["min", "max"]))
@_settings(12)
def test_marginal_gain_property_shapes(n, m, d, B, fold):
    """Rows 4–7 of the kernel table at drawn shapes: the gains and the
    folded cache against the reference's oracles (3e-5, the reference
    suite's tolerance); every gain ≥ 0; the batched launch equal to B
    unbatched ones."""
    V, C, cache, w = _gain_operands(n, m, d, B, fold)
    kw = dict(fold=fold, score_affine=AFFINE if fold == "max" else None)
    batched = ops.marginal_gain(_t(V), _t(C), _t(cache), **kw).numpy()
    bg, bc = ops.fused_gain_update(_t(V), _t(C), _t(cache), _t(w), **kw)
    want, folded, want_after = map(np.asarray, _gain_oracles(
        V, C, cache, w, fold))
    for b in range(B):
        got = ops.marginal_gain(_t(V[b]), _t(C[b]), _t(cache[b]), **kw)
        np.testing.assert_allclose(got.numpy(), want[b], rtol=3e-5, atol=3e-5)
        assert np.all(got.numpy() >= -1e-6)  # gains are non-negative
        np.testing.assert_array_equal(batched[b], got.numpy())
        g, nc = ops.fused_gain_update(_t(V[b]), _t(C[b]), _t(cache[b]),
                                      _t(w[b]), **kw)
        np.testing.assert_allclose(nc.numpy(), folded[b], rtol=3e-5,
                                   atol=3e-5)
        np.testing.assert_allclose(g.numpy(), want_after[b], rtol=3e-5,
                                   atol=3e-5)
        assert np.all(g.numpy() >= -1e-6)
        np.testing.assert_array_equal(bg[b].numpy(), g.numpy())
        np.testing.assert_array_equal(bc[b].numpy(), nc.numpy())


def _sieve_oracle(T, dvec, fold):
    """The reference's jnp sieve rows (``functions.sieve_gain_rows``),
    averaged over n."""
    from repro.core.functions import FnSpec, sieve_gain_rows

    name = "exemplar" if fold == "min" else "facility_location"
    rows = sieve_gain_rows(FnSpec(name), jnp.asarray(T), jnp.asarray(dvec),
                           None)
    return np.asarray(jnp.sum(rows, axis=-1)) / T.shape[-1]


@given(r=st.integers(1, 65), n=st.integers(1, 150), P=st.integers(1, 8),
       fold=st.sampled_from(["min", "max"]), seeded=st.booleans())
@_settings(12)
def test_sieve_gains_property_shapes(r, n, P, fold, seeded):
    """Rows 8–9 at drawn tables, with and without the seed operand: every
    partition's gains against the reference's oracle, ≥ 0, and the batched
    launch equal to P unbatched ones."""
    rng = np.random.default_rng(r * 1000 + n * 10 + P)
    dvec = rng.uniform(0.0, 2.0, size=(P, n)).astype(np.float32)
    if fold == "min":
        T = dvec[:, None, :] + rng.uniform(-0.3, 1.0, size=(P, r, n))
    else:
        T = rng.uniform(0.0, 0.8, size=(P, r, n))
    T = T.astype(np.float32)
    seed = T[0, 0].copy() if seeded else None
    kw = dict(fold=fold, score_affine=AFFINE if fold == "max" else None,
              seed=None if seed is None else _t(seed))
    batched = ops.sieve_gains_batched(_t(T), _t(dvec), **kw).numpy()
    for p in range(P):
        got = ops.sieve_gains(_t(T[p]), _t(dvec[p]), **kw).numpy()
        table = T[p] if seed is None else np.concatenate([seed[None], T[p]])
        np.testing.assert_allclose(got, _sieve_oracle(table, dvec[p], fold),
                                   rtol=3e-5, atol=3e-5)
        assert np.all(got >= -1e-6)
        np.testing.assert_array_equal(batched[p], got)


@given(n=st.integers(1, 200_000), m=st.integers(1, 60_000),
       d=st.integers(1, 1024), B=st.integers(1, 64), update=st.booleans(),
       pol=st.sampled_from(POLICIES))
@_settings(50)
def test_gain_grid_covers_problem(n, m, d, B, update, pol):
    """Paper eq. 8 for the gain kernels: the grid's candidate tiles cover
    m, its blocks' segments cover n, and a block's staging fits."""
    p = tresolve(pol)
    gx, gy, gb = ops.gain_grid(n, m, d, p, batch=B, update=update)
    cols = ops.gain_block_cols(d, p, update)
    segs = ops.n_segments(n)
    widths = ops.TC_GAIN_BLOCK_M if ops.tensor_cores(p) else ops.GAIN_BLOCK_M
    assert gb == B and cols in widths
    assert gx * cols >= m and (gx - 1) * cols < max(m, 1)
    assert gy * ops.segs_per_block(gx * B, segs) * ops.SEG >= n
    assert ops.smem_bytes(1, d, p, cols, update) <= ops.SMEM_BUDGET


def test_grid_covers_problem():
    """Paper eq. 8: the exemplar-eval grid tiles the whole work matrix."""
    cfgk = ops.kernel_config(10, 128, FP32)
    gl, gn = cfgk.grid(1000, 50_000)
    spb = ops.segs_per_block(gl, ops.n_segments(50_000))
    assert gl * cfgk.block_l >= 1000 and gn * spb * ops.SEG >= 50_000
    assert (gl - 1) * cfgk.block_l < 1000


# ---------------------------------------------------------------------------
# tests/test_sieve_kernel_property.py: the dyadic grid, drawn
# ---------------------------------------------------------------------------

N, D = 64, 6  # n a power of two: the /n mean is exact on dyadic sums


def _grid_ground_set(seed: int) -> np.ndarray:
    """(N, D) vectors on the 1/32 grid in [0, 4]: exact f32 arithmetic."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 129, size=(N, D)) / 32.0).astype(np.float32)


def _tables_three(V, order, k, eps, variant, s_max, block_size):
    """The reference's ``pallas_interpret`` engine and the port's
    ``torch`` and ``cuda`` engines after the same stream."""
    jeng = jst.make_sieve_engine(JEC(jnp.asarray(V)), k, eps, variant=variant,
                                 mode="device", s_max=s_max,
                                 block_size=block_size,
                                 backend="pallas_interpret")
    jeng.offer(order, V[order])
    f = ExemplarClustering(V, device="cpu")
    engines = []
    for backend in ("torch", "cuda"):
        eng = tst.make_sieve_engine(f, k, eps, variant=variant, mode="device",
                                    s_max=s_max, block_size=block_size,
                                    backend=backend)
        eng.offer(order, V[order])
        engines.append(eng)
    return jeng, engines


def _assert_tables_bit_identical(jeng, engines):
    for eng in engines:
        assert eng.evaluations() == jeng.evaluations()
        assert eng.best() == jeng.best()
        for name in tst.SieveState._fields:
            np.testing.assert_array_equal(
                getattr(eng.state, name).numpy(),
                np.asarray(getattr(jeng.state, name)), err_msg=name)


@given(seed=st.integers(0, 1000), k=st.integers(1, 4),
       eps=st.sampled_from([0.1, 0.25, 0.5]),
       variant=st.sampled_from(sorted(tst.VARIANTS)),
       block_size=st.sampled_from([1, 17, 64]))
@_settings(12)
def test_sieve_tables_bit_identical_to_reference(seed, k, eps, variant,
                                                 block_size):
    V = _grid_ground_set(seed)
    order = np.random.default_rng(seed + 1).permutation(N).astype(np.int32)
    _assert_tables_bit_identical(*_tables_three(V, order, k, eps, variant,
                                                None, block_size))


@given(seed=st.integers(0, 1000), k=st.integers(2, 4))
@_settings(20)
def test_sieve_tables_bit_identical_under_eviction(seed, k):
    """Salsa's grow-only grid squeezed into a sieve-sized table: the
    lowest-exponent eviction, identically in all three engines."""
    V = _grid_ground_set(seed)
    # ascending norms: every element a new max, the window climbs past s_max
    order = np.argsort((V ** 2).sum(axis=1), kind="stable").astype(np.int32)
    cap = tst.default_capacity(k, 0.1, "sieve")
    _assert_tables_bit_identical(*_tables_three(V, order, k, 0.1, "salsa",
                                                cap, 32))
