"""The port's four kernels (plain path: the wrappers on CPU tensors) against
the JAX package's Pallas wrappers in interpret mode.

Shapes are the reference's ragged ones (n, l, d indivisible by any block
size); every case covers both folds, the rbf transform, ``w_valid`` 0 and 1
and fp32/bf16/fp16 at the reference's per-policy bands (POLICY_TOLS of
tests/test_kernel_parity.py), applied to max|err| / max(1, max|ref|): the
outputs of normal+2 payloads are O(10–100), where fp32 sums taken in another
order already differ by ~1e-5 absolute. The kernels themselves run on the
card in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax.numpy as jnp  # noqa: E402

from repro.core.functions import SIM_ALPHA, SIM_BETA  # noqa: E402
from repro.core.precision import resolve as jresolve  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.core.precision import resolve as tresolve  # noqa: E402

RAGGED_SHAPES = [(137, 13, 5, 19), (257, 21, 7, 33), (65, 9, 3, 129)]
POLICY_TOLS = {"fp32": 1e-5, "bf16": 5e-2, "fp16": 1e-2}
AFFINE = (SIM_ALPHA, SIM_BETA)


def _band(got, ref, band):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    err = float(np.max(np.abs(got - ref)))
    assert err <= band * max(1.0, float(np.max(np.abs(ref)))), err


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _eval_problem(n, l, k, d, rbf, seed):
    rng = np.random.default_rng(seed)
    scale, shift = (0.3, 0.0) if rbf else (1.0, 2.0)
    V = (rng.normal(size=(n, d)) * scale + shift).astype(np.float32)
    S = (rng.normal(size=(l, k, d)) * scale + shift).astype(np.float32)
    lengths = rng.integers(1, k + 1, size=l).astype(np.int32)
    d_e0 = rng.uniform(0.5, 1.5, size=n).astype(np.float32) * (
        1.0 if rbf else 2.0 * d)
    return V, S, lengths, d_e0


def _both_eval(V, S, lengths, d_e0, policy, mode, variant, gamma):
    got = tops.exemplar_eval(_t(V), _t(S), _t(lengths, torch.int32), _t(d_e0),
                             policy=tresolve(policy), mode=mode,
                             variant=variant, rbf_gamma=gamma)
    ref = jops.exemplar_eval(jnp.asarray(V), jnp.asarray(S),
                             jnp.asarray(lengths), jnp.asarray(d_e0),
                             policy=jresolve(policy), mode=mode,
                             variant=variant, interpret=True, rbf_gamma=gamma)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("mode,variant", [("fused", "flat"),
                                          ("fused", "loop"),
                                          ("two_pass", "loop")])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_exemplar_eval_plain_matches_pallas(shape, mode, variant):
    V, S, lengths, d_e0 = _eval_problem(*shape, rbf=False, seed=11)
    got, ref = _both_eval(V, S, lengths, d_e0, "fp32", mode, variant, None)
    _band(got, ref, POLICY_TOLS["fp32"])


@pytest.mark.parametrize("rbf", [False, True])
@pytest.mark.parametrize("policy", sorted(POLICY_TOLS))
def test_exemplar_eval_plain_policies_and_rbf(policy, rbf):
    V, S, lengths, d_e0 = _eval_problem(*RAGGED_SHAPES[1], rbf=rbf, seed=12)
    gamma = 1.0 if rbf else None
    for mode, variant in (("fused", "flat"), ("two_pass", "loop")):
        got, ref = _both_eval(V, S, lengths, d_e0, policy, mode, variant,
                              gamma)
        _band(got, ref, POLICY_TOLS[policy])


def _gain_problem(n, m, d, fold, rbf, seed):
    rng = np.random.default_rng(seed)
    scale, shift = (0.3, 0.0) if rbf else (1.0, 1.5)
    V = (rng.normal(size=(n, d)) * scale + shift).astype(np.float32)
    C = V[:m]
    w = V[n // 2]
    if fold == "max":
        cache = rng.uniform(0.0, 0.8, size=n)
    elif rbf:
        cache = rng.uniform(0.0, 2.0, size=n)
    else:
        cache = rng.uniform(0.5, 1.5, size=n) * 2.0 * d
    return V, C, cache.astype(np.float32), w


@pytest.mark.parametrize("rbf", [False, True])
@pytest.mark.parametrize("fold", ["min", "max"])
@pytest.mark.parametrize("policy", sorted(POLICY_TOLS))
def test_gain_kernels_plain_match_pallas(policy, fold, rbf):
    """gain_eval and gain_update_eval (w_valid 0 and 1) per template."""
    n, m, d = 133, 41, 21
    V, C, cache, w = _gain_problem(n, m, d, fold, rbf, seed=17)
    gamma = 1.0 if rbf else None
    aff = AFFINE if fold == "max" else None
    kw_t = dict(policy=tresolve(policy), rbf_gamma=gamma, fold=fold,
                score_affine=aff)
    kw_j = dict(policy=jresolve(policy), rbf_gamma=gamma, fold=fold,
                score_affine=aff, interpret=True)
    got = tops.marginal_gain(_t(V), _t(C), _t(cache), **kw_t)
    ref = jops.marginal_gain(jnp.asarray(V), jnp.asarray(C),
                             jnp.asarray(cache), **kw_j)
    _band(got.numpy(), np.asarray(ref), POLICY_TOLS[policy])
    for wv in (0.0, 1.0):
        g, nc = tops.fused_gain_update(
            _t(V), _t(C), _t(cache), _t(w), w_valid=torch.tensor(wv), **kw_t)
        gr, ncr = jops.fused_gain_update(
            jnp.asarray(V), jnp.asarray(C), jnp.asarray(cache),
            jnp.asarray(w), w_valid=jnp.float32(wv), **kw_j)
        _band(nc.numpy(), np.asarray(ncr), POLICY_TOLS[policy])
        _band(g.numpy(), np.asarray(gr), POLICY_TOLS[policy])
        if wv == 0.0:
            np.testing.assert_array_equal(nc.numpy(), cache)


@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_gain_kernels_plain_ragged_shapes(shape):
    n, _l, _k, d = shape
    m = min(n - 1, 37)
    V, C, cache, w = _gain_problem(n, m, d, "min", False, seed=19)
    got = tops.marginal_gain(_t(V), _t(C), _t(cache), n_total=3 * n)
    ref = jops.marginal_gain(jnp.asarray(V), jnp.asarray(C),
                             jnp.asarray(cache), n_total=3 * n,
                             interpret=True)
    _band(got.numpy(), np.asarray(ref), POLICY_TOLS["fp32"])
    g, nc = tops.fused_gain_update(_t(V), _t(C), _t(cache), _t(w))
    gr, ncr = jops.fused_gain_update(jnp.asarray(V), jnp.asarray(C),
                                     jnp.asarray(cache), jnp.asarray(w),
                                     interpret=True)
    _band(g.numpy(), np.asarray(gr), POLICY_TOLS["fp32"])
    _band(nc.numpy(), np.asarray(ncr), POLICY_TOLS["fp32"])


def test_gain_kernels_on_a_cache_from_mid_greedy():
    """Both packages score the same non-trivial state: the cache after three
    rounds of the JAX package's host greedy, carried across as numpy."""
    from repro.core import ExemplarClustering as JEC
    from repro.core import EvalConfig as JCfg
    from repro.core.optimizers import greedy as jgreedy
    from repro.data.synthetic import blobs
    from repro_torch import convert

    X, _ = blobs(150, 10, centers=5, seed=2)
    jf = JEC(jnp.asarray(X), JCfg(backend="pallas_interpret"))
    sel = jgreedy(jf, 3, mode="host").indices
    cache = jf.init_cache()
    for j in sel:
        cache = jf.fold_winner(cache, j)
    vec, aux = convert.cache_from_arrays(np.asarray(cache[0]),
                                         np.asarray(cache[1]), device="cpu")
    f = convert.exemplar_from_arrays(X, None, {"backend": "pallas_interpret"},
                                     device="cpu")
    idx = np.arange(0, 150, 3)
    got = f.gains_from_cache((vec, aux), idx)
    ref = jf.gains_from_cache(cache, idx)
    _band(got.numpy(), np.asarray(ref), POLICY_TOLS["fp32"])
    w = X[sel[-1]]
    g, nc = tops.fused_gain_update(f.V, f.V[idx], vec, _t(w),
                                   w_valid=torch.tensor(1.0))
    gr, ncr = jops.fused_gain_update(jnp.asarray(X), jnp.asarray(X[idx]),
                                     cache[0], jnp.asarray(w), interpret=True)
    _band(g.numpy(), np.asarray(gr), POLICY_TOLS["fp32"])
    _band(nc.numpy(), np.asarray(ncr), POLICY_TOLS["fp32"])


def test_wrappers_refuse_mismatched_operands():
    V = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="compute dtype"):
        from repro_torch.kernels import _build
        _build.operand_code(torch.float16, tresolve("bf16"))
    with pytest.raises(ValueError, match="too wide"):
        tops.kernel_config(4, 200_000, tresolve("fp32"))
    assert tops.marginal_gain(V, V, torch.zeros(5)).shape == (5,)


@pytest.mark.parametrize("policy", sorted(POLICY_TOLS))
def test_math_oracles_match_reference_oracles(policy):
    """kernels/ref.py against the JAX package's kernels/ref.py."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    V, S, lengths, d_e0 = _eval_problem(*RAGGED_SHAPES[0], rbf=False, seed=5)
    args_t = (_t(V), _t(S), _t(lengths, torch.int32), _t(d_e0),
              tresolve(policy))
    args_j = (jnp.asarray(V), jnp.asarray(S), jnp.asarray(lengths),
              jnp.asarray(d_e0), jresolve(policy))
    for gamma in (None, 0.01):
        _band(tref.exemplar_eval_ref(*args_t, rbf_gamma=gamma).numpy(),
              np.asarray(jref.exemplar_eval_ref(*args_j, rbf_gamma=gamma)),
              POLICY_TOLS[policy])
        _band(tref.work_matrix_ref(*args_t, rbf_gamma=gamma).numpy() * 137,
              np.asarray(jref.work_matrix_ref(*args_j, rbf_gamma=gamma)) * 137,
              POLICY_TOLS[policy])
    cache = d_e0
    _band(tref.marginal_gain_ref(_t(V), _t(V[:31]), _t(cache),
                                 tresolve(policy)).numpy(),
          np.asarray(jref.marginal_gain_ref(jnp.asarray(V), jnp.asarray(V[:31]),
                                            jnp.asarray(cache),
                                            jresolve(policy))),
          POLICY_TOLS[policy])


def _fma16(a, b, c):
    """One fp16 FMA: a·b + c exact in float64, rounded once by numpy."""
    return np.float16(np.float64(a) * np.float64(b) + np.float64(c))


def _butterfly16(P):
    h = len(P) // 2
    while h:
        P = [np.float16(P[t] + P[t + h]) for t in range(h)]
        h //= 2
    return P[0]


def _strict_dist_naive(V, X, gamma, lanes):
    """fp16_strict distances one scalar at a time, in the CUDA kernels'
    order (csrc/tile.cuh, exemplar_eval.cu, marginal_gain.cu)."""
    Vh, Xh = V.astype(np.float16), X.astype(np.float16)
    (n, d), m = Vh.shape, Xh.shape[0]
    out = np.zeros((n, m), np.float16)
    for i in range(n):
        P = [np.float16(0)] * 16
        for f in range(d):
            P[f % 16] = _fma16(Vh[i, f], Vh[i, f], P[f % 16])
        vn = _butterfly16(P)
        for j in range(m):
            sn = g = np.float16(0)
            for f in range(d):
                sn = _fma16(Xh[j, f], Xh[j, f], sn)
                g = _fma16(Vh[i, f], Xh[j, f], g)
            if lanes:
                P = [np.float16(0)] * 16
                for f in range(d):
                    P[f % 16] = _fma16(Vh[i, f], Xh[j, f], P[f % 16])
                g = _butterfly16(P)
            d2 = max(np.float16(np.float16(vn + sn) - np.float16(2) * g),
                     np.float16(0))
            if gamma is not None:
                e = np.float16(np.exp(np.float32(np.float16(-gamma) * d2)))
                d2 = np.float16(2) * np.float16(np.float16(1) - e)
            out[i, j] = d2
    return out


@pytest.mark.parametrize("n,m,d,gamma,lanes", [(7, 5, 37, None, False),
                                               (6, 1, 45, None, True),
                                               (5, 4, 129, 1.0, False)])
def test_fp16_strict_plain_follows_the_kernels_order(n, m, d, gamma, lanes):
    """fp16 accumulation depends on the order of its terms: the plain
    version of fp16_strict takes them in the kernels' order, one rounding
    per FMA, and agrees bit for bit with a scalar emulation."""
    from repro_torch.kernels.exemplar_eval import _rn16, _strict_dist

    rng = np.random.default_rng(d)
    x = np.concatenate([rng.normal(size=4000) * 10.0 ** rng.integers(-9, 5, 4000),
                        (np.arange(-300, 300) + 0.5) * 2.0 ** -10,
                        [65519.0, 65520.0, 0.0, 3e-8]])
    with np.errstate(over="ignore"):
        want = x.astype(np.float16).astype(np.float64)
    np.testing.assert_array_equal(_rn16(torch.from_numpy(x)).numpy(), want)
    sigma, shift = (0.07, 0.1) if gamma else (1.0, 2.0)
    V = (rng.normal(size=(n, d)) * sigma + shift).astype(np.float32)
    X = (rng.normal(size=(m, d)) * sigma + shift).astype(np.float32)
    got = _strict_dist(_t(V), _t(X), gamma, lanes)
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.numpy(), _strict_dist_naive(V, X, gamma,
                                                                  lanes))


@pytest.mark.parametrize("policy", sorted(POLICY_TOLS))
def test_plain_versions_match_math_oracles(policy):
    """Each kernel's plain version against kernels/ref.py (the math, with
    no tiling and no memory bound) at every float32-accumulating policy.
    Both round the payload alike and accumulate in float32, so the band is
    fp32's, on max(1, |ref|, ‖v‖² + ‖s‖²)."""
    from repro_torch.kernels import exemplar_eval as ee
    from repro_torch.kernels import marginal_gain as mg
    from repro_torch.kernels import ref

    p = tresolve(policy)
    n, l, k, d = RAGGED_SHAPES[1]
    for rbf in (False, True):
        gamma = 1.0 if rbf else None
        V, S, lengths, d_e0 = map(_t, _eval_problem(n, l, k, d, rbf, seed=23))
        lengths = lengths.to(torch.int32)
        scale = max(1.0, 2 * float((V * V).sum(1).max() + (S * S).sum(-1).max()))

        def band(got, want):
            top = float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= POLICY_TOLS["fp32"] * max(scale, top), err

        kw = dict(n_total=n, policy=p, rbf_gamma=gamma)
        band(ee.fused_eval_plain(V, S, lengths, d_e0, layout="loop", **kw),
             ref.exemplar_eval_ref(V, S, lengths, d_e0, p, gamma))
        band(ee.two_pass_eval_plain(V, S, lengths, d_e0, **kw) * n,
             ref.work_matrix_ref(V, S, lengths, d_e0, p, gamma) * n)
        for fold in ("min", "max"):
            Vg, C, cache, w = map(_t, _gain_problem(n, 41, d, fold, rbf, 29))
            aff = AFFINE if fold == "max" else None
            okw = dict(policy=p, rbf_gamma=gamma, fold=fold, affine=aff)
            gkw = dict(n_total=n, **okw)
            band(mg.gain_eval_plain(Vg, C, cache, **gkw),
                 ref.marginal_gain_ref(Vg, C, cache, **okw))
            g, nc = mg.gain_update_eval_plain(Vg, C, cache, w,
                                              torch.tensor(1.0), **gkw)
            nco = ref.fold_winner_ref(Vg, w, cache, **okw)
            band(nc, nco)
            band(g, ref.marginal_gain_ref(Vg, C, nco, **okw))
