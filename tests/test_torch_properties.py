"""The reference's property suites on the port, held to the reference.

Ports of ``tests/test_core_properties.py`` (the submodular invariants, the
greedy (1 − 1/e) guarantee by brute force, the min-cache identity, every
distance, the sieve (1/2 − ε) bound on both plans),
``tests/test_multiset.py``'s drawn cases (its fixed cases are cases of
``tests/test_torch_core.py``'s packing tests) and
``tests/test_function_properties.py`` (the cache protocol's chain
properties over the whole zoo). Every drawn example builds the same
numpy-seeded inputs for both packages (the port on the CPU) and asserts two
things: the property holds on the port, and the port's numbers equal the
reference's within ``POLICY_TOLS`` (fp32 1e-5 of max(1, |reference|)),
with identical selections and evaluation counts.

Graph cut scores the indices already in S below zero in both packages
(ROADMAP C.2), so its chain properties are held on non-members only; one
case pins the two packages' member scores at the instance that shows it.

Hypothesis is derandomized with no example database: every run draws the
same examples.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

from hypothesis import given, settings, strategies as st  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import EvalConfig as JCfg  # noqa: E402
from repro.core import ExemplarClustering as JEC  # noqa: E402
from repro.core import greedy as jgreedy  # noqa: E402
from repro.core import multiset as jms  # noqa: E402
from repro.core.functions import FUNCTIONS as JFUNCTIONS  # noqa: E402
from repro.core.optimizers import sieve_streaming as jsieve  # noqa: E402
from repro_torch.core import EvalConfig, ExemplarClustering, greedy  # noqa: E402
from repro_torch.core import multiset as tms  # noqa: E402
from repro_torch.core.functions import FUNCTIONS  # noqa: E402
from repro_torch.core.optimizers import sieve_streaming  # noqa: E402

#: tests/test_kernel_parity.py's per-policy bands (the port against the
#: reference at the same policy), on max(1, |reference|).
POLICY_TOLS = {"fp32": 1e-5, "bf16": 5e-2, "fp16": 1e-2}


def _settings(n):
    return settings(max_examples=n, deadline=None, derandomize=True,
                    database=None)


def _close(got, ref, tol=POLICY_TOLS["fp32"]):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(ref), initial=0.0))), \
        (err, got, ref)


def _same_result(got, ref):
    assert got.indices == ref.indices
    assert got.evaluations == ref.evaluations
    _close(got.value, ref.value)


# ---------------------------------------------------------------------------
# tests/test_core_properties.py
# ---------------------------------------------------------------------------


def _f(n=24, d=4, seed=0, **kw):
    """The suite's ground set in both packages: (port, reference, V)."""
    rng = np.random.default_rng(seed)
    V = (rng.normal(size=(n, d)) + 1.5).astype(np.float32)
    return (ExemplarClustering(V, EvalConfig(**kw), device="cpu"),
            JEC(jnp.asarray(V), JCfg(**kw)), V)


def _values(f, jf, *sets):
    """f(S) of each set on the port, each held to the reference's."""
    got = [f.value(S) for S in sets]
    _close(got, [jf.value(jnp.asarray(S)) for S in sets])
    return got


@given(seed=st.integers(0, 50),
       idx=st.lists(st.integers(0, 23), min_size=1, max_size=6, unique=True),
       extra=st.integers(0, 23))
@_settings(25)
def test_monotone(seed, idx, extra):
    """f(A) ≤ f(A ∪ {e}) — Definition 3."""
    f, jf, V = _f(seed=seed)
    a, ae = _values(f, jf, V[np.array(idx)],
                    V[np.array(list(set(idx) | {extra}))])
    assert a <= ae + 1e-5


@given(seed=st.integers(0, 50),
       a_idx=st.lists(st.integers(0, 23), min_size=1, max_size=4, unique=True),
       b_extra=st.lists(st.integers(0, 23), min_size=1, max_size=4,
                        unique=True),
       e=st.integers(0, 23))
@_settings(25)
def test_diminishing_returns(seed, a_idx, b_extra, e):
    """Δ(e|A) ≥ Δ(e|B) for A ⊆ B, e ∉ B — Definition 2."""
    f, jf, V = _f(seed=seed)
    a_set = set(a_idx)
    b_set = a_set | set(b_extra)
    if e in b_set:
        b_set.discard(e)
        a_set.discard(e)
        if not a_set:
            a_set = {(e + 1) % 24}
            b_set |= a_set
    A = V[np.array(sorted(a_set))]
    B = V[np.array(sorted(b_set))]
    ev = V[np.array([e])]
    fa, fae, fb, fbe = _values(f, jf, A, np.concatenate([A, ev]), B,
                               np.concatenate([B, ev]))
    assert fae - fa >= fbe - fb - 1e-4


@given(seed=st.integers(0, 30))
@_settings(10)
def test_empty_set_is_zero(seed):
    f, jf, _ = _f(seed=seed)
    empty = np.zeros((0, 4), np.float32)
    assert f.value(empty) == 0.0 == jf.value(jnp.asarray(empty))


@given(seed=st.integers(0, 20), k=st.integers(2, 3))
@_settings(8)
def test_greedy_guarantee(seed, k):
    """Greedy ≥ (1 − 1/e)·OPT on brute-forceable instances (Nemhauser);
    greedy and OPT both equal the reference's."""
    f, jf, V = _f(n=12, seed=seed)
    res = greedy(f, k)
    _same_result(res, jgreedy(jf, k))
    combos = [V[np.array(c)] for c in itertools.combinations(range(12), k)]
    vals = f.value_sets(combos).numpy()
    _close(vals, np.asarray(jf.value_sets(combos)))
    assert res.value >= (1 - 1 / np.e) * float(vals.max()) - 1e-5


@given(seed=st.integers(0, 20))
@_settings(10)
def test_mincache_matches_direct_value(seed):
    """Incremental value tracking equals direct evaluation, and both equal
    the reference's at every step."""
    f, jf, V = _f(seed=seed)
    cache, jcache = f.init_mincache(), jf.init_mincache()
    chosen = []
    rng = np.random.default_rng(seed)
    for j in rng.choice(24, size=5, replace=False):
        chosen.append(int(j))
        cache = f.update_mincache(cache, f.V[int(j)])
        jcache = jf.update_mincache(jcache, jf.V[int(j)])
        (direct,) = _values(f, jf, V[np.array(chosen)])
        got = f.value_from_mincache(cache)
        _close(got, jf.value_from_mincache(jcache))
        assert abs(got - direct) < 1e-4


@given(seed=st.integers(0, 20),
       dist=st.sampled_from(["sqeuclidean", "manhattan", "cosine", "rbf"]))
@_settings(16)
def test_nonnegative_all_distances(seed, dist):
    """f ≥ 0 and monotone for every supported dissimilarity (paper §IV)."""
    f, jf, V = _f(seed=seed, distance=dist)
    s3, s5 = _values(f, jf, V[:3], V[:5])
    assert s3 >= -1e-6
    assert s5 >= s3 - 1e-5


@given(seed=st.integers(0, 40), k=st.integers(2, 3),
       eps=st.sampled_from([0.1, 0.2]),
       mode=st.sampled_from(["host", "device"]))
@_settings(20)
def test_streamed_value_within_sieve_bound(seed, k, eps, mode):
    """SieveStreaming ≥ (1/2 − ε)·greedy on both plans, with the
    reference's members, value and evaluations."""
    f, jf, _ = _f(seed=seed)
    base = greedy(f, k)
    res = sieve_streaming(f, k, eps=eps, seed=seed, mode=mode)
    _same_result(res, jsieve(jf, k, eps=eps, seed=seed, mode=mode))
    assert len(res.indices) <= k
    assert res.value >= (0.5 - eps) * base.value - 1e-5


# ---------------------------------------------------------------------------
# tests/test_multiset.py (drawn cases)
# ---------------------------------------------------------------------------


@given(sizes=st.lists(st.integers(1, 9), min_size=1, max_size=12))
@_settings(25)
def test_pack_roundtrip(sizes):
    rng = np.random.default_rng(sum(sizes))
    sets = [rng.normal(size=(k, 5)).astype(np.float32) for k in sizes]
    pk = tms.pack_sets(sets, device="cpu")
    ref = jms.pack_sets(sets)
    assert pk.num_sets == ref.num_sets == len(sizes)
    assert pk.k_max == ref.k_max == max(sizes)
    np.testing.assert_array_equal(pk.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(pk.lengths.numpy(), np.asarray(ref.lengths))
    mask = pk.mask().numpy()
    np.testing.assert_array_equal(mask, np.asarray(ref.mask()))
    for j, s in enumerate(sets):
        np.testing.assert_array_equal(pk.data[j, :sizes[j]].numpy(), s)
        assert mask[j].sum() == sizes[j]
        # padding slots are zero (blank fields, paper Fig. 2)
        assert not pk.data[j, sizes[j]:].any()


@given(sizes=st.lists(st.integers(1, 9), min_size=1, max_size=12))
@_settings(25)
def test_pad_fraction_accounting(sizes):
    rng = np.random.default_rng(1)
    sets = [rng.normal(size=(k, 3)).astype(np.float32) for k in sizes]
    got = tms.pack_sets(sets, device="cpu").pad_fraction()
    want = 1.0 - sum(sizes) / (len(sizes) * max(sizes))
    assert abs(got - want) < 1e-6
    assert got == pytest.approx(jms.pack_sets(sets).pad_fraction(), abs=1e-12)


# ---------------------------------------------------------------------------
# tests/test_function_properties.py
# ---------------------------------------------------------------------------

#: fp32 mean-reductions over ≤ 48 rows (the reference suite's slack).
TOL = 1e-5
ZOO = sorted(FUNCTIONS)


def _make_function(name: str, n: int, d: int, seed: int):
    """The zoo member on the suite's ground set (rbf, so the coverage
    objectives see dense similarities) in both packages."""
    rng = np.random.default_rng(seed)
    V = (rng.normal(size=(n, d)) * 0.4).astype(np.float32)
    return (FUNCTIONS[name](V, EvalConfig(distance="rbf"), device="cpu"),
            JFUNCTIONS[name](jnp.asarray(V), JCfg(distance="rbf")))


def _gains(f, jf, cache, jcache, n):
    """Every candidate's gain on the port, held to the reference's."""
    got = f.gains_from_cache(cache, np.arange(n)).numpy().astype(np.float64)
    _close(got, np.asarray(jf.gains_from_cache(
        jcache, jnp.arange(n, dtype=jnp.int32)), np.float64))
    return got


def test_suite_names_the_whole_zoo():
    assert ZOO == sorted(JFUNCTIONS)


@pytest.mark.parametrize("name", ZOO)
@_settings(4)
@given(n=st.integers(6, 48), d=st.integers(2, 8),
       seed=st.integers(0, 2**31 - 1), data=st.data())
def test_monotone_and_diminishing_returns(name, n, d, seed, data):
    """Every non-member's gain ≥ 0 along a greedy chain, and a fixed
    held-out candidate's gain non-increasing while it stays out of S."""
    f, jf = _make_function(name, n, d, seed)
    k = min(5, n - 1)
    held_out = data.draw(st.integers(0, n - 1), label="held-out candidate")
    order = data.draw(st.permutations(range(n)), label="greedy tie order")
    cache, jcache = f.init_cache(), jf.init_cache()
    members, held_gains = [], []
    for _ in range(k):
        gains = _gains(f, jf, cache, jcache, n)
        out = np.setdiff1d(np.arange(n), members)
        assert gains[out].min() >= -TOL, (name, gains[out].min())
        if held_out not in members:
            held_gains.append(gains[held_out])
        # the drawn order breaks exact ties only, so this stays a greedy
        # chain; both packages fold the port's pick
        j = max(order, key=lambda i: gains[i])
        members.append(j)
        cache, jcache = f.fold_winner(cache, j), jf.fold_winner(
            jcache, jnp.int32(j))
    for a, b in zip(held_gains, held_gains[1:]):
        assert b <= a + TOL, (name, held_gains)


@pytest.mark.parametrize("name", ZOO)
@_settings(4)
@given(n=st.integers(6, 48), d=st.integers(2, 8),
       seed=st.integers(0, 2**31 - 1))
def test_value_telescopes_from_gains(name, n, d, seed):
    """f(S) = f(∅) + the sum of the accepted gains along any chain."""
    f, jf = _make_function(name, n, d, seed)
    k = min(5, n - 1)
    cache, jcache = f.init_cache(), jf.init_cache()
    total = f.value_from_cache(cache)  # f(∅), 0 for all
    _close(total, jf.value_from_cache(jcache))
    assert abs(total) <= TOL
    for t in range(k):
        j = (seed + 7 * t) % n  # arbitrary (not greedy) chain
        g = float(f.gains_from_cache(cache, [j])[0])
        _close(g, float(np.asarray(jf.gains_from_cache(
            jcache, jnp.asarray([j], jnp.int32)))[0]))
        total += g
        cache, jcache = f.fold_winner(cache, j), jf.fold_winner(
            jcache, jnp.int32(j))
    value = f.value_from_cache(cache)
    _close(value, jf.value_from_cache(jcache))
    np.testing.assert_allclose(value, total, atol=5e-5)


def test_graph_cut_member_scores_equal_the_reference():
    """ROADMAP C.2: after the chain S = [5, 0, 4, 3] at n = 6, d = 5, seed
    0, both packages score members 3 and 4 below zero, at the same values
    (the formula is shared; the engines mask members)."""
    f, jf = _make_function("graph_cut", 6, 5, 0)
    cache, jcache = f.init_cache(), jf.init_cache()
    for j in (5, 0, 4, 3):
        cache, jcache = f.fold_winner(cache, j), jf.fold_winner(
            jcache, jnp.int32(j))
    gains = _gains(f, jf, cache, jcache, 6)
    np.testing.assert_allclose(gains[[3, 4]], [-0.0282, -0.0063], atol=5e-5)
    assert gains[[1, 2]].min() > 0
