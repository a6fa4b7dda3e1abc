"""The port's batched multi-tenant engine against the JAX package's.

Kernel level: the plain versions of the grid-over-B gain kernels (what the
wrappers run on CPU tensors) against the reference's 3-D ``ops`` dispatch in
Pallas interpret mode, on ragged shapes, at every policy, both folds, both
Gram distances and a ``w_valid`` that mixes 0 and 1; and each request's
slice equal to its own unbatched plain call. Bands are those of
tests/test_torch_kernels.py (``POLICY_TOLS`` of the reference's
tests/test_kernel_parity.py), plus the reference's own fp16_strict band of
tests/test_evaluator.py (5e-2): the port's fp16_strict accumulates in the
CUDA kernels' order, the reference's in XLA's.

Engine level: ``run_selection_batch`` mirrors tests/test_batched_engine.py
at its sizes (N = 48, D = 8, K = 3): port backend ``torch`` against JAX
``jnp`` at B ∈ {1, 7, 64}, port backend ``cuda`` (the plain versions on
CPU) against JAX ``pallas_interpret`` at B ∈ {1, 7}. Indices and
``evaluations`` are identical; trajectories agree within the reference
tests' ``TRAJ_ATOL``, and equal B unbatched port calls exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import EvalConfig as JCfg  # noqa: E402
from repro.core import run_selection_batch as jrun_selection_batch  # noqa: E402
from repro.core.functions import FUNCTIONS as JFUNCTIONS  # noqa: E402
from repro.core.precision import resolve as jresolve  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import (EvalConfig, run_selection,  # noqa: E402
                              run_selection_batch, stochastic_greedy)
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core.functions import FUNCTIONS, SIM_ALPHA, SIM_BETA  # noqa: E402
from repro_torch.core.precision import resolve as tresolve  # noqa: E402
from repro_torch.core.service import _stochastic_samples  # noqa: E402
from repro_torch.data.synthetic import blobs  # noqa: E402
from repro_torch.kernels import marginal_gain as mg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

N, D, K = 48, 8, 3
EPS = 0.1
#: port backend → the JAX backend it is held against, and the batch sizes
CELLS = {"torch": ("jnp", (1, 7, 64)), "cuda": ("pallas_interpret", (1, 7))}
TRAJ_ATOL = {"torch": 1e-5, "cuda": 1e-4}
N_DISTINCT = 6  # B > 6 cycles these tenants; duplicates must agree too
POLICY_TOLS = {"fp32": 1e-5, "bf16": 5e-2, "fp16": 1e-2, "fp16_strict": 5e-2}
AFFINE = (SIM_ALPHA, SIM_BETA)


def _band(got, ref, band):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    err = float(np.max(np.abs(got - ref)))
    assert err <= band * max(1.0, float(np.max(np.abs(ref)))), err


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------------------
# Kernel level
# ---------------------------------------------------------------------------


def _batched_problem(B, n, m, d, fold, rbf, seed):
    rng = np.random.default_rng(seed)
    scale, shift = (0.3, 0.0) if rbf else (1.0, 1.5)
    V = (rng.normal(size=(B, n, d)) * scale + shift).astype(np.float32)
    C = np.ascontiguousarray(V[:, :m])
    w = np.ascontiguousarray(V[:, n // 2])
    if fold == "max":
        cache = rng.uniform(0.0, 0.8, size=(B, n))
    elif rbf:
        cache = rng.uniform(0.0, 2.0, size=(B, n))
    else:
        cache = rng.uniform(0.5, 1.5, size=(B, n)) * 2.0 * d
    w_valid = (np.arange(B) % 2).astype(np.float32)  # mixes 0 and 1
    return V, C, cache.astype(np.float32), w, w_valid


@pytest.mark.parametrize("rbf", [False, True])
@pytest.mark.parametrize("fold", ["min", "max"])
@pytest.mark.parametrize("policy", sorted(POLICY_TOLS))
def test_batched_gain_plain_matches_pallas(policy, fold, rbf):
    B, n, m, d = 3, 77, 23, 13
    V, C, cache, w, wv = _batched_problem(B, n, m, d, fold, rbf, seed=31)
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
    g, nc = tops.fused_gain_update(_t(V), _t(C), _t(cache), _t(w),
                                   w_valid=_t(wv), **kw_t)
    gr, ncr = jops.fused_gain_update(
        jnp.asarray(V), jnp.asarray(C), jnp.asarray(cache), jnp.asarray(w),
        w_valid=jnp.asarray(wv), **kw_j)
    _band(nc.numpy(), np.asarray(ncr), POLICY_TOLS[policy])
    _band(g.numpy(), np.asarray(gr), POLICY_TOLS[policy])
    # requests gated off keep their cache exactly
    np.testing.assert_array_equal(nc.numpy()[wv == 0], cache[wv == 0])


@pytest.mark.parametrize("B,n,m,d", [(1, 137, 13, 19), (4, 257, 37, 33),
                                     (2, 65, 9, 129)])
def test_batched_gain_plain_ragged_shapes(B, n, m, d):
    V, C, cache, w, wv = _batched_problem(B, n, m, d, "min", False, seed=37)
    got = tops.marginal_gain(_t(V), _t(C), _t(cache), n_total=3 * n)
    ref = jops.marginal_gain(jnp.asarray(V), jnp.asarray(C),
                             jnp.asarray(cache), n_total=3 * n,
                             interpret=True)
    _band(got.numpy(), np.asarray(ref), POLICY_TOLS["fp32"])
    g, nc = tops.fused_gain_update(_t(V), _t(C), _t(cache), _t(w),
                                   w_valid=_t(wv))
    gr, ncr = jops.fused_gain_update(
        jnp.asarray(V), jnp.asarray(C), jnp.asarray(cache), jnp.asarray(w),
        w_valid=jnp.asarray(wv), interpret=True)
    _band(g.numpy(), np.asarray(gr), POLICY_TOLS["fp32"])
    _band(nc.numpy(), np.asarray(ncr), POLICY_TOLS["fp32"])


@pytest.mark.parametrize("fold", ["min", "max"])
@pytest.mark.parametrize("policy", sorted(POLICY_TOLS))
def test_batched_plain_slices_equal_unbatched_plain(policy, fold):
    """Each request of a batched plain call is, bit for bit, its own
    unbatched plain call (the property the kernels keep on the card)."""
    B, n, m, d = 3, 61, 13, 11
    V, C, cache, w, wv = map(_t, _batched_problem(B, n, m, d, fold, False,
                                                  seed=41))
    kw = dict(n_total=n, policy=tresolve(policy), fold=fold,
              affine=AFFINE if fold == "max" else None)
    g = mg.gain_eval_batched_plain(V, C, cache, **kw)
    gu, nc = mg.gain_update_eval_batched_plain(V, C, cache, w, wv, **kw)
    for b in range(B):
        assert torch.equal(g[b], mg.gain_eval_plain(V[b], C[b], cache[b],
                                                    **kw))
        g1, nc1 = mg.gain_update_eval_plain(V[b], C[b], cache[b], w[b], wv[b],
                                            **kw)
        assert torch.equal(gu[b], g1) and torch.equal(nc[b], nc1)


def test_batched_wrappers_refuse_bad_operands():
    V = torch.zeros((2, 5, 3))
    p = tresolve("fp32")
    # m = 0 scores nothing; the fused update still folds
    assert mg.gain_eval_batched(V, V[:, :0], torch.zeros(2, 5), n_total=5,
                                policy=p).shape == (2, 0)
    Vp = V + 1.0
    g, nc = mg.gain_update_eval_batched(
        Vp, Vp[:, :0], torch.full((2, 5), 9.0), Vp[:, 0], torch.ones(2),
        n_total=5, policy=p)
    assert g.shape == (2, 0)
    np.testing.assert_array_equal(nc.numpy(), np.zeros((2, 5), np.float32))
    # CUDA-only argument checks run on any device through the checker
    with pytest.raises(ValueError, match="B, m, d"):
        mg._check_gain_operands(V, V[0], torch.zeros(2, 5), p, "min", None,
                                batched=True)
    with pytest.raises(ValueError, match="float32"):
        mg._check_gain_operands(V, V, torch.zeros(5), p, "min", None,
                                batched=True)
    with pytest.raises(ValueError, match="winner"):
        mg._check_winner(V, V[0, 0], torch.ones(2), torch.zeros(2, 5), None)
    with pytest.raises(ValueError, match="w_valid"):
        mg._check_winner(V, V[:, 0].contiguous(), torch.ones(3),
                         torch.zeros(2, 5), None)
    cache = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="distinct"):
        mg._check_winner(V, V[:, 0].contiguous(), torch.ones(2), cache,
                         cache)


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------

_FUNCS: dict = {}


def _data(t):
    return blobs(N, D, centers=4, seed=70 + t)[0]


def _funcs(backend: str, fname: str = "exemplar"):
    """The same N_DISTINCT tenants in both packages."""
    key = (backend, fname)
    if key not in _FUNCS:
        jbackend = CELLS[backend][0]
        _FUNCS[key] = (
            [FUNCTIONS[fname](_data(t), EvalConfig(backend=backend),
                              device="cpu") for t in range(N_DISTINCT)],
            [JFUNCTIONS[fname](jnp.asarray(_data(t)), JCfg(backend=jbackend))
             for t in range(N_DISTINCT)])
    return _FUNCS[key]


def _ref(f, kind, k, seed):
    """The port's unbatched engine run of one request."""
    if kind == "stochastic":
        return stochastic_greedy(f, k, eps=EPS, seed=seed, mode="device")
    cand = np.arange(f.n)[None, :] if kind == "dense" else None
    return run_selection(f, kind=kind, k=k, cand_rounds=cand)


def _same(got, ref, atol):
    assert got.indices == ref.indices
    assert got.evaluations == ref.evaluations
    np.testing.assert_allclose(got.trajectory, ref.trajectory, atol=atol,
                               rtol=0)


CASES = [(backend, kind, B) for backend, (_, bs) in sorted(CELLS.items())
         for kind in ("dense", "stochastic", "lazy") for B in bs]


@pytest.mark.parametrize("backend,kind,B", CASES)
def test_batched_matches_reference_and_unbatched(backend, kind, B):
    fs, jfs = _funcs(backend)
    tenants = [t % N_DISTINCT for t in range(B)]
    cand = None
    if kind == "stochastic":
        cand = np.stack([_stochastic_samples(N, K, EPS, seed=t)
                         for t in tenants])
    res = run_selection_batch([fs[t] for t in tenants], kind=kind, k=K,
                              cand_rounds=cand)
    jres = jrun_selection_batch([jfs[t] for t in tenants], kind=kind, k=K,
                                cand_rounds=cand,
                                counter_key=f"torch_batched_{kind}")
    mine = {t: _ref(fs[t], kind, K, t) for t in set(tenants)}
    assert len(res) == B
    for b, t in enumerate(tenants):
        _same(res[b], jres[b], TRAJ_ATOL[backend])
        # batched == unbatched, trajectories to the bit
        assert res[b] == mine[t], (kind, backend, B, b)


@pytest.mark.parametrize("backend", sorted(CELLS))
@pytest.mark.parametrize("kind", ["dense", "lazy"])
def test_batched_ragged_k(kind, backend):
    """Per-request k ≤ the round count: request b freezes after ks[b]
    rounds and gets exactly the unbatched k=ks[b] result; ks[b]=0 slots
    (bucket padding) are inert."""
    ks = [5, 2, 0, 3, 1]
    fs, jfs = _funcs(backend)
    idx = [b % N_DISTINCT for b in range(len(ks))]
    res = run_selection_batch([fs[i] for i in idx], kind=kind, k=max(ks),
                              ks=ks)
    jres = jrun_selection_batch([jfs[i] for i in idx], kind=kind, k=max(ks),
                                ks=ks, counter_key=f"torch_ragged_{kind}")
    for b, kb in enumerate(ks):
        if kb == 0:
            assert res[b] == eng.OptResult([], 0.0, [], 0)
            continue
        _same(res[b], jres[b], TRAJ_ATOL[backend])
        assert res[b] == _ref(fs[idx[b]], kind, kb, b)


def test_batched_celf_per_request_eval_counts():
    """Each request's CELF evaluation count is its own (they differ across
    tenants here), equal to its unbatched run and to the reference's."""
    fs, jfs = _funcs("torch")
    res = run_selection_batch(fs, kind="lazy", k=5, top_b=8)
    jres = jrun_selection_batch(jfs, kind="lazy", k=5, top_b=8,
                                counter_key="torch_celf_counts")
    counts = [r.evaluations for r in res]
    assert counts == [r.evaluations for r in jres]
    assert counts == [run_selection(f, kind="lazy", k=5, top_b=8).evaluations
                      for f in fs]
    assert len(set(counts)) > 1, "every tenant re-scored identically"


@pytest.mark.parametrize("backend", sorted(CELLS))
@pytest.mark.parametrize("fname,params", [("graph_cut", {"lam": 0.5}),
                                          ("saturated_coverage", {"sat": 0.25}),
                                          ("facility_location", {})])
def test_batched_function_axis(fname, params, backend):
    """graph_cut's scalar aux, saturated_coverage's per-row caps and
    facility location's max cache ride the batch axis unchanged."""
    jbackend = CELLS[backend][0]
    Xs = [_data(t) / 10.0 for t in range(4)]
    fs = [FUNCTIONS[fname](X, EvalConfig(distance="rbf", backend=backend),
                           device="cpu", **params) for X in Xs]
    jfs = [JFUNCTIONS[fname](jnp.asarray(X),
                             JCfg(distance="rbf", backend=jbackend), **params)
           for X in Xs]
    res = run_selection_batch(fs, kind="dense", k=K)
    jres = jrun_selection_batch(jfs, kind="dense", k=K,
                                counter_key=f"torch_zoo_{fname}")
    for b, f in enumerate(fs):
        _same(res[b], jres[b], TRAJ_ATOL[backend])
        assert res[b] == run_selection(f, kind="dense", k=K,
                                       cand_rounds=np.arange(N)[None, :])


def test_device_block_m_scales_with_batch(monkeypatch):
    """The live batched footprint is B·n rows: a B=1024 bucket sized as if
    B=1 would over-commit memory 1024× (the reference's test, same
    numbers)."""
    monkeypatch.setattr(eng, "_GAIN_TILE_CAP_ELEMS", 1 << 25)
    assert eng._device_block_m(1 << 20, 64) == 32
    assert eng._device_block_m(1 << 20, 64, n_batch=8) == 8
    assert eng._device_block_m(1024, 1024) == 1024
    assert eng._device_block_m(1024, 1024, n_batch=64) == 512
    assert eng._device_block_m(1024, 1024, n_batch=0) == 1024


def test_run_selection_batch_sizes_tiles_for_batch(monkeypatch):
    calls = []
    real = eng._device_block_m

    def spy(n, m, n_batch=1):
        calls.append({"n": n, "m": m, "n_batch": n_batch})
        return real(n, m, n_batch)

    monkeypatch.setattr(eng, "_device_block_m", spy)
    fs, _ = _funcs("torch")
    run_selection_batch(fs[:4], kind="dense", k=2)
    assert calls and calls[-1] == {"n": N, "m": N, "n_batch": 4}


@pytest.mark.parametrize("B", [1, 7, 64])
def test_dense_bucket_launches_the_fused_kernel_once_per_round(monkeypatch,
                                                                B):
    """A dense bucket of B requests is k calls of the batched fused wrapper
    (on the card: k launches of gain_update_eval_batched), whatever B is,
    and no unbatched gain call."""
    calls = []
    for name in ("gain_update_eval_batched", "gain_eval_batched",
                 "gain_update_eval", "gain_eval"):
        real = getattr(mg, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(mg, name, spy)
    fs, _ = _funcs("cuda")
    run_selection_batch([fs[t % N_DISTINCT] for t in range(B)], kind="dense",
                        k=K)
    assert calls == ["gain_update_eval_batched"] * K


def test_batched_run_leaves_function_state_alone():
    """The engine writes only its freshly stacked buffers: every function's
    resident cache seed is unchanged, and a second run gives the same
    result."""
    fs, _ = _funcs("cuda")
    seeds = [f.cache_seed.clone() for f in fs]
    r1 = run_selection_batch(fs, kind="dense", k=K)
    r2 = run_selection_batch(fs, kind="dense", k=K,
                             staged=eng.stage_selection_batch(fs))
    for f, s in zip(fs, seeds):
        assert torch.equal(f.cache_seed, s)
        assert torch.equal(f.d_e0.to(torch.float32), s)
    assert r1 == r2


def test_batched_staged_payload_survives_a_second_run():
    """The fused rounds ping-pong copies of the staged seed: the staged
    payload is read only, so a second run on it starts from the same seed
    and gives the same result."""
    fs, _ = _funcs("cuda")
    staged = eng.stage_selection_batch(fs)
    seed = staged["seed"].clone()
    r1 = run_selection_batch(fs, kind="dense", k=K, staged=staged)
    assert torch.equal(staged["seed"], seed)
    assert run_selection_batch(fs, kind="dense", k=K, staged=staged) == r1


def test_batched_rejects_mixed_signatures():
    fs, _ = _funcs("torch")
    other_shape = FUNCTIONS["exemplar"](blobs(N * 2, D, centers=4, seed=1)[0],
                                        device="cpu")
    with pytest.raises(ValueError, match="payload shape"):
        run_selection_batch([fs[0], other_shape], kind="dense", k=2)
    other_cfg = FUNCTIONS["exemplar"](fs[0].V, EvalConfig(backend="cuda"))
    with pytest.raises(ValueError, match="EvalConfig"):
        run_selection_batch([fs[0], other_cfg], kind="dense", k=2)
    gc = FUNCTIONS["graph_cut"](fs[0].V)
    with pytest.raises(ValueError, match="function spec"):
        run_selection_batch([fs[0], gc], kind="dense", k=2)
    fb = FUNCTIONS["feature_based"](fs[0].V)
    with pytest.raises(ValueError, match="host execution plans"):
        run_selection_batch([fb, fb], kind="dense", k=2)
    for plan in ("device_sharded", "device_sharded_pool"):
        with pytest.raises(RuntimeError, match="init_process_group"):
            run_selection_batch(fs[:2], kind="dense", k=2, plan=plan)
        with pytest.raises(RuntimeError, match="init_process_group"):
            eng.stage_selection_batch(fs[:2], plan=plan)
    with pytest.raises(ValueError, match="unknown batched execution plan"):
        run_selection_batch(fs[:2], kind="dense", k=2, plan="greedi")


def test_batched_rejects_bad_ks():
    fs, _ = _funcs("torch")
    fs = fs[:2]
    with pytest.raises(ValueError, match="ks has"):
        run_selection_batch(fs, kind="dense", k=2, ks=[2])
    with pytest.raises(ValueError, match=r"\[0, 2\]"):
        run_selection_batch(fs, kind="dense", k=2, ks=[2, 3])
    with pytest.raises(ValueError, match="cannot select"):
        run_selection_batch(fs, kind="dense", k=3,
                            cand_rounds=np.zeros((2, 1, 2), np.int64) + [0, 1])
    assert run_selection_batch(fs, kind="dense", k=2, ks=[0, 0]) \
        == [eng.OptResult([], 0.0, [], 0)] * 2
    assert run_selection_batch([], kind="dense", k=2) == []
