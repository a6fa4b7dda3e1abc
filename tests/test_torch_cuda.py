"""The port's CUDA kernels on the card against their plain versions.

Every test here is marked ``cuda`` and skips on a machine with no CUDA
device. On one with a card (and the CUDA toolkit, which builds the kernels
at first use):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package: the machine with the card
need not have them. Bands are those of chip_smoke.py, on the error divided by
max(1, max|plain|, max‖v‖² + max‖s‖²) (the Gram identity loses
eps·(‖v‖² + ‖s‖²) absolute however small the distance); the max fold runs on
payloads whose distances are O(1), where the library's similarity
relu(SIM_ALPHA + SIM_BETA·d) is not flat.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.functions import SIM_ALPHA, SIM_BETA  # noqa: E402
from repro_torch.core.precision import resolve  # noqa: E402

BANDS = {"fp32": 1e-5, "bf16": 1e-5, "fp16": 1e-5, "fp16_strict": 1e-6}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _band(got, ref, band, norm_scale):
    got = got.float().cpu()
    ref = ref.float().cpu()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    tol = band * max(1.0, norm_scale, float(ref.abs().max()))
    assert err <= tol, err
    assert float((got * 0.99 - ref).abs().max()) > tol  # catches a 1 % error


def _problem(dev, n=1031, l=77, k=6, d=45, seed=0, sigma=1.0, shift=2.0):
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=dt, device=dev).contiguous()
    V = t(rng.normal(size=(n, d)) * sigma + shift)
    S = t(rng.normal(size=(l, k, d)) * sigma + shift)
    lengths = t(rng.integers(1, k + 1, size=l), torch.int32)
    typical = 2 * d * sigma ** 2
    cache = t(rng.uniform(0.5 * typical, 1.5 * typical, size=n))
    return V, S, lengths, cache, float((V * V).sum(1).max() * 2)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", sorted(BANDS))
def test_exemplar_kernels_match_plain(dev, policy):
    from repro_torch.kernels import exemplar_eval as ee
    from repro_torch.kernels import ops

    V, S, lengths, d_e0, ns = _problem(dev)
    n, (l, k, d) = V.shape[0], S.shape
    p = resolve(policy)
    kc = ops.kernel_config(k, d, p).k_chunk
    for layout, SS in (("flat", S.permute(1, 0, 2).contiguous()),
                       ("loop", S)):
        kw = dict(n_total=n, policy=p, layout=layout)
        _band(ee.fused_eval(V, SS, lengths, d_e0, k_chunk=kc, **kw),
              ee.fused_eval_plain(V, SS, lengths, d_e0, **kw), BANDS[policy],
              ns)
    kw = dict(n_total=n, policy=p)
    _band(ee.two_pass_eval(V, S, lengths, d_e0, k_chunk=kc, **kw) * n,
          ee.two_pass_eval_plain(V, S, lengths, d_e0, **kw) * n,
          BANDS[policy], ns)


@pytest.mark.cuda
@pytest.mark.parametrize("fold", ["min", "max"])
@pytest.mark.parametrize("policy", sorted(BANDS))
def test_gain_kernels_match_plain(dev, policy, fold):
    from repro_torch.kernels import marginal_gain as mg

    unit = dict(sigma=(2 * 45) ** -0.5, shift=0.1) if fold == "max" else {}
    V, _S, _lengths, cache, ns = _problem(dev, seed=1, **unit)
    if fold == "max":
        cache = torch.rand_like(cache) * 0.8
    C, w = V[:101].contiguous(), V[7].contiguous()
    kw = dict(n_total=V.shape[0], policy=resolve(policy), fold=fold,
              affine=(SIM_ALPHA, SIM_BETA) if fold == "max" else None)
    _band(mg.gain_eval(V, C, cache, **kw), mg.gain_eval_plain(V, C, cache, **kw),
          BANDS[policy], ns)
    for wv in (0.0, 1.0):
        wvt = torch.tensor(wv, device=dev)
        out = torch.empty_like(cache)
        g, nc = mg.gain_update_eval(V, C, cache, w, wvt, cache_out=out, **kw)
        gp, ncp = mg.gain_update_eval_plain(V, C, cache, w, wvt, **kw)
        assert nc is out
        _band(g, gp, BANDS[policy], ns)
        _band(nc, ncp, BANDS[policy], ns)


@pytest.mark.cuda
def test_device_plan_launches_the_fused_kernel_once_per_round(dev):
    from repro_torch.core import EvalConfig, ExemplarClustering, greedy
    from repro_torch.data.synthetic import blobs
    from repro_torch.kernels import ops

    X, _ = blobs(2000, 16, centers=8, seed=0)
    f = ExemplarClustering(X, EvalConfig(backend="cuda"))
    ops.LAUNCHES.clear()
    dev_r = greedy(f, 5, mode="device")
    assert ops.LAUNCHES["gain_update_eval"] == 5
    host_r = greedy(f, 5, mode="host")
    assert ops.LAUNCHES["gain_eval"] == 5
    assert dev_r.indices == host_r.indices
    assert dev_r.evaluations == host_r.evaluations


@pytest.mark.cuda
@pytest.mark.parametrize("fold", ["min", "max"])
@pytest.mark.parametrize("policy", sorted(BANDS))
def test_batched_kernels_equal_unbatched_per_request(dev, policy, fold):
    """Each request of a batched launch is bit for bit its own unbatched
    launch (gains and folded cache), at a ragged shape, with a w_valid that
    mixes 0 and 1; and the batched kernels agree with their plain
    versions."""
    from repro_torch.kernels import marginal_gain as mg

    B, n, m, d = 3, 1031, 101, 45
    unit = dict(sigma=(2 * d) ** -0.5, shift=0.1) if fold == "max" else {}
    parts = [_problem(dev, n=n, d=d, seed=10 + b, **unit) for b in range(B)]
    V = torch.stack([p[0] for p in parts])
    cache = torch.stack([p[3] for p in parts])
    if fold == "max":
        cache = torch.rand_like(cache) * 0.8
    C, w = V[:, :m].contiguous(), V[:, 7].contiguous()
    wv = torch.tensor([1.0, 0.0, 1.0], device=dev)
    kw = dict(n_total=n, policy=resolve(policy), fold=fold,
              affine=(SIM_ALPHA, SIM_BETA) if fold == "max" else None)
    g = mg.gain_eval_batched(V, C, cache, **kw)
    gu, nc = mg.gain_update_eval_batched(V, C, cache, w, wv, **kw)
    for b in range(B):
        assert torch.equal(g[b], mg.gain_eval(V[b], C[b], cache[b], **kw))
        g1, nc1 = mg.gain_update_eval(V[b], C[b], cache[b], w[b], wv[b], **kw)
        assert torch.equal(gu[b], g1) and torch.equal(nc[b], nc1)
    ns = max(p[4] for p in parts)
    _band(g, mg.gain_eval_batched_plain(V, C, cache, **kw), BANDS[policy], ns)
    gp, ncp = mg.gain_update_eval_batched_plain(V, C, cache, w, wv, **kw)
    _band(gu, gp, BANDS[policy], ns)
    _band(nc, ncp, BANDS[policy], ns)


@pytest.mark.cuda
def test_selection_service_round_trip_on_the_card(dev):
    """Tenants served on the card get their unbatched results to the bit
    (ragged k included), through the batched kernels (one fused launch per
    round per bucket)."""
    import asyncio

    from repro_torch.core import (EvalConfig, ExemplarClustering,
                                  SelectionService, greedy, lazy_greedy)
    from repro_torch.data.synthetic import blobs
    from repro_torch.kernels import ops

    Xs = [blobs(1500, 24, centers=6, seed=t)[0] for t in range(6)]
    cfg = EvalConfig(backend="cuda")

    async def main():
        async with SelectionService(cfg, max_batch=8, linger_s=0.01) as svc:
            # k 3 and 4 share a 4-round bucket: k = 3 is ragged
            dense = await asyncio.gather(*[svc.submit(X, k=3 + t % 2)
                                           for t, X in enumerate(Xs)])
            lazy = await asyncio.gather(*[svc.submit(X, k=3, kind="lazy")
                                          for X in Xs[:3]])
            return dense, lazy, dict(svc.stats)

    ops.LAUNCHES.clear()
    dense, lazy, stats = asyncio.run(main())
    assert ops.LAUNCHES["gain_update_eval_batched"] == 4
    assert ops.LAUNCHES["gain_eval_batched"] > 0
    assert stats["dispatches"] == 2
    for t, (X, r) in enumerate(zip(Xs, dense)):
        assert r == greedy(ExemplarClustering(X, cfg), 3 + t % 2,
                           mode="device")
    for X, r in zip(Xs, lazy):
        assert r == lazy_greedy(ExemplarClustering(X, cfg), 3, mode="device")


def _sieve_operands(dev, lead, r, n, fold, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 2.0, size=(*lead, n))
    if fold == "min":
        T = d[..., None, :] + rng.uniform(-0.3, 1.0, size=(*lead, r, n))
        T[..., 0] = d[..., None, 0] + 0.5
    else:
        T = rng.uniform(0.0, 0.8, size=(*lead, r, n))
        d[..., 0], T[..., 0] = 0.5, 0.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=dev).contiguous()
    return t(T), t(d)


@pytest.mark.cuda
@pytest.mark.parametrize("fold", ["min", "max"])
@pytest.mark.parametrize("r,n", [(1, 1), (35, 4099), (65, 50_000)])
def test_sieve_kernel_matches_plain(dev, r, n, fold):
    """fp32 sums of the same terms in another order: the fp32 band of the
    gain kernels, on the error over max(1, max|plain|)."""
    from repro_torch.kernels import marginal_gain as mg
    from repro_torch.kernels import ops

    T, d = _sieve_operands(dev, (), r, n, fold, seed=r)
    aff = (SIM_ALPHA, SIM_BETA) if fold == "max" else None
    before = ops.LAUNCHES["sieve_gain_eval"]
    got = mg.sieve_gain_eval(T, d, n_total=n, fold=fold, affine=aff)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sieve_gain_eval"] == before + 1
    _band(got, mg.sieve_gain_eval_plain(T, d, n_total=n, fold=fold,
                                        affine=aff), BANDS["fp32"], 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("fold", ["min", "max"])
@pytest.mark.parametrize("P", [1, 3, 16])
def test_batched_sieve_kernel_equals_unbatched_per_partition(dev, P, fold):
    from repro_torch.kernels import marginal_gain as mg

    T, d = _sieve_operands(dev, (P,), 35, 4099, fold, seed=P)
    aff = (SIM_ALPHA, SIM_BETA) if fold == "max" else None
    got = mg.sieve_gain_eval_batched(T, d, n_total=4099, fold=fold,
                                     affine=aff)
    _band(got, mg.sieve_gain_eval_batched_plain(T, d, n_total=4099, fold=fold,
                                                affine=aff),
          BANDS["fp32"], 1.0)
    for p in range(P):
        # T[p] starts off 16 bytes for odd p (n = 4 099): scalar loads; its
        # fresh copy is aligned: 128-bit loads; the same adds either way
        for Tp in (T[p], T[p].clone()):
            one = mg.sieve_gain_eval(Tp, d[p], n_total=4099, fold=fold,
                                     affine=aff)
            assert torch.equal(one, got[p])


def _sieve_edges():
    """n at the edges of the sieve kernel's split: a block's span S at small
    n and one past it, the first n whose last block gets a column, 8 load
    groups of G columns and one past (a block loads its span in two
    groups), and ragged and paper-size n."""
    from repro_torch.kernels import marginal_gain as mg

    S, G = mg.sieve_span(1), mg.SIEVE_GROUP
    return sorted({1, 3, S - 1, S, S + 1, 8 * S + 1, 4097, 8 * G, 8 * G + 1,
                   50_000})


@pytest.mark.cuda
@pytest.mark.parametrize("fold", ["min", "max"])
@pytest.mark.parametrize("n", _sieve_edges())
def test_sieve_kernel_at_split_edges_matches_plain(dev, n, fold):
    from repro_torch.kernels import marginal_gain as mg

    T, d = _sieve_operands(dev, (), 35, n, fold, seed=n)
    kw = dict(n_total=n, fold=fold,
              affine=(SIM_ALPHA, SIM_BETA) if fold == "max" else None)
    _band(mg.sieve_gain_eval(T, d, **kw), mg.sieve_gain_eval_plain(T, d, **kw),
          BANDS["fp32"], 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("fold", ["min", "max"])
def test_sieve_row_bits_do_not_depend_on_the_table(dev, fold):
    """A row's gain is the same bits at r = 1, 35 and 65, wherever the row
    sits in the table and whatever its alignment (n = 4 099)."""
    from repro_torch.kernels import marginal_gain as mg

    n = 4099
    T, d = _sieve_operands(dev, (), 65, n, fold, seed=7)
    kw = dict(n_total=n, fold=fold,
              affine=(SIM_ALPHA, SIM_BETA) if fold == "max" else None)
    full = mg.sieve_gain_eval(T, d, **kw)
    for j in (0, 1, 2, 3, 34, 64):
        for row in (T[j:j + 1], T[j:j + 1].clone()):
            assert torch.equal(mg.sieve_gain_eval(row, d, **kw), full[j:j + 1])
    for lo in (0, 1, 30):
        assert torch.equal(mg.sieve_gain_eval(T[lo:lo + 35], d, **kw),
                           full[lo:lo + 35])


@pytest.mark.cuda
@pytest.mark.parametrize("fold", ["min", "max"])
@pytest.mark.parametrize("n", [4099, 50_000])
def test_sieve_seed_launch_equals_concatenated_launch(dev, n, fold):
    """``seed=`` reads the seed through its own pointer: bit for bit the
    launch on ``cat([seed, T])``, unbatched and batched (one seed row for
    every partition), and in band of the plain version."""
    from repro_torch.kernels import marginal_gain as mg

    T, d = _sieve_operands(dev, (3,), 35, n, fold, seed=n + 1)
    seed = T[1, 5].clone()
    kw = dict(n_total=n, fold=fold,
              affine=(SIM_ALPHA, SIM_BETA) if fold == "max" else None)
    got = mg.sieve_gain_eval(T[0], d[0], seed=seed, **kw)
    assert torch.equal(got, mg.sieve_gain_eval(torch.cat([seed[None], T[0]]),
                                               d[0], **kw))
    _band(got, mg.sieve_gain_eval_plain(T[0], d[0], seed=seed, **kw),
          BANDS["fp32"], 1.0)
    gotb = mg.sieve_gain_eval_batched(T, d, seed=seed, **kw)
    full = torch.cat([seed.expand(3, 1, n), T], dim=1)
    assert torch.equal(gotb, mg.sieve_gain_eval_batched(full, d, **kw))
    assert torch.equal(gotb[0], got)
    _band(gotb, mg.sieve_gain_eval_batched_plain(T, d, seed=seed, **kw),
          BANDS["fp32"], 1.0)


@pytest.mark.cuda
def test_element_step_makes_no_table_copy_on_the_card(dev, monkeypatch):
    """The ``cuda``-backend element step scores the seed and the table in
    one launch, with no ``torch.cat`` of the table."""
    from repro_torch.core import EvalConfig, ExemplarClustering
    from repro_torch.core import streaming as tst
    from repro_torch.data.synthetic import blobs
    from repro_torch.kernels import ops

    X, _ = blobs(1000, 16, centers=8, seed=3)
    f = ExemplarClustering(X, EvalConfig(backend="cuda"))
    spec = tst.make_spec(5, 0.1, "sieve", backend="cuda", fn=f.spec)
    state = tst.init_state(f.n, spec, dev)
    dvec = f.point_distances_block(f.V[:1]).float()[0]
    cats = []
    real_cat = torch.cat
    monkeypatch.setattr(torch, "cat", lambda *a, **k: cats.append(1) or
                        real_cat(*a, **k))
    before = ops.LAUNCHES["sieve_gain_eval"]
    tst._element_step(spec, tst.step_consts(f, spec), state,
                      torch.tensor(0, dtype=torch.int32, device=dev), dvec,
                      torch.ones((), dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sieve_gain_eval"] == before + 1
    assert not cats


@pytest.mark.cuda
def test_sieve_streaming_host_equals_device_on_the_card(dev):
    """Both plans run the sieve kernel once per element, and agree."""
    from repro_torch.core import EvalConfig, ExemplarClustering, sieve_streaming
    from repro_torch.data.synthetic import blobs
    from repro_torch.kernels import ops

    X, _ = blobs(2000, 16, centers=8, seed=1)
    f = ExemplarClustering(X, EvalConfig(backend="cuda"))
    before = ops.LAUNCHES["sieve_gain_eval"]
    res = {m: sieve_streaming(f, 6, seed=2, mode=m, block_size=64)
           for m in ("host", "device")}
    assert ops.LAUNCHES["sieve_gain_eval"] == before + 2 * f.n
    assert res["host"].indices == res["device"].indices
    assert res["host"].evaluations == res["device"].evaluations
    assert res["host"].value == res["device"].value


# ---------------------------------------------------------------------------
# The fixed split of n: a column's bits depend on n and its own inputs only
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fp32", "fp16_strict"])
def test_gain_columns_are_the_same_bits_at_every_m(dev, policy):
    """A candidate's gain (and its fused-update gain) is bit for bit the
    same whether it is scored among m = 1, 33, 256, 257 candidates or all
    n (host CELF re-scores at a varying m, device CELF 256 at a time)."""
    from repro_torch.kernels import marginal_gain as mg

    V, _S, _lengths, cache, _ns = _problem(dev, n=3001, d=45, seed=21,
                                           sigma=0.3, shift=0.5)
    n = V.shape[0]
    kw = dict(n_total=n, policy=resolve(policy))
    w, wv = V[11].contiguous(), torch.ones((), device=dev)
    full = mg.gain_eval(V, V, cache, **kw)
    fullu, _ = mg.gain_update_eval(V, V, cache, w, wv, **kw)
    rng = np.random.default_rng(3)
    for m in (1, 33, 256, 257):
        idx = torch.as_tensor(np.sort(rng.choice(n, size=m, replace=False)),
                              device=dev)
        C = V[idx].contiguous()
        assert torch.equal(mg.gain_eval(V, C, cache, **kw), full[idx])
        assert torch.equal(mg.gain_update_eval(V, C, cache, w, wv, **kw)[0],
                           fullu[idx])


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fp32", "fp16_strict"])
def test_fused_eval_on_a_subset_equals_the_full_launch(dev, policy):
    from repro_torch.core.evaluator import e0_distances
    from repro_torch.kernels import exemplar_eval as ee
    from repro_torch.kernels import ops

    V, S, lengths, _cache, _ns = _problem(dev, n=1031, l=500, k=6, d=45,
                                          seed=22, sigma=0.3, shift=0.5)
    p = resolve(policy)
    d_e0 = e0_distances(V, None, "sqeuclidean", p).float().contiguous()
    kw = dict(n_total=V.shape[0], policy=p, layout="loop",
              k_chunk=ops.kernel_config(6, 45, p).k_chunk)
    full = ee.fused_eval(V, S, lengths, d_e0, **kw)
    idx = torch.as_tensor(np.sort(np.random.default_rng(4).choice(
        500, size=97, replace=False)), device=dev)
    assert torch.equal(ee.fused_eval(V, S[idx].contiguous(),
                                     lengths[idx].contiguous(), d_e0, **kw),
                       full[idx])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 64])
def test_batched_segments_equal_unbatched(dev, B):
    """Requests on blockIdx.z, segments on blockIdx.y: each request of a
    batched launch over several segments and candidate tiles is bit for bit
    its own unbatched launch."""
    from repro_torch.kernels import marginal_gain as mg

    n, m, d = 600, 130, 45
    V = torch.stack([_problem(dev, n=n, d=d, seed=40 + b)[0]
                     for b in range(B)])
    cache = torch.stack([_problem(dev, n=n, d=d, seed=40 + b)[3]
                         for b in range(B)])
    C, w = V[:, :m].contiguous(), V[:, 5].contiguous()
    wv = torch.tensor([float(b % 2) for b in range(B)], device=dev)
    kw = dict(n_total=n, policy=resolve("fp32"))
    g = mg.gain_eval_batched(V, C, cache, **kw)
    gu, nc = mg.gain_update_eval_batched(V, C, cache, w, wv, **kw)
    for b in range(B):
        assert torch.equal(g[b], mg.gain_eval(V[b], C[b], cache[b], **kw))
        g1, nc1 = mg.gain_update_eval(V[b], C[b], cache[b], w[b], wv[b], **kw)
        assert torch.equal(gu[b], g1) and torch.equal(nc[b], nc1)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", sorted(BANDS))
def test_segment_edge_shapes_match_plain(dev, policy):
    """n on either side of the segment edges, against the plain versions."""
    from repro_torch.core.evaluator import e0_distances
    from repro_torch.kernels import exemplar_eval as ee
    from repro_torch.kernels import marginal_gain as mg
    from repro_torch.kernels import ops

    p = resolve(policy)
    for n in (ops.SEG - 1, ops.SEG, ops.SEG + 1, 2 * ops.SEG + 1):
        V, S, lengths, cache, ns = _problem(dev, n=n, l=37, k=5, d=45,
                                            seed=n)
        kw = dict(n_total=n, policy=p)
        d_e0 = e0_distances(V, None, "sqeuclidean", p).float().contiguous()
        kc = ops.kernel_config(5, 45, p).k_chunk
        _band(ee.fused_eval(V, S, lengths, d_e0, k_chunk=kc, layout="loop",
                            **kw),
              ee.fused_eval_plain(V, S, lengths, d_e0, layout="loop", **kw),
              BANDS[policy], ns)
        _band(ee.two_pass_eval(V, S, lengths, d_e0, k_chunk=kc, **kw) * n,
              ee.two_pass_eval_plain(V, S, lengths, d_e0, **kw) * n,
              BANDS[policy], ns)
        C, w = V[:131].contiguous(), V[3].contiguous()
        _band(mg.gain_eval(V, C, cache, **kw),
              mg.gain_eval_plain(V, C, cache, **kw), BANDS[policy], ns)
        wv = torch.ones((), device=dev)
        g, nc = mg.gain_update_eval(V, C, cache, w, wv, **kw)
        gp, ncp = mg.gain_update_eval_plain(V, C, cache, w, wv, **kw)
        _band(g, gp, BANDS[policy], ns)
        _band(nc, ncp, BANDS[policy], ns)


def _mesh_rank(rank, world, X, k):
    """One gloo rank of the mesh test, on the one card."""
    torch.cuda.set_device(0)
    from repro_torch.core import EvalConfig, ExemplarClustering, greedy
    from repro_torch.kernels import ops

    f = ExemplarClustering(X, EvalConfig(backend="cuda"))
    ops.LAUNCHES.clear()
    res = greedy(f, k, mode="device_sharded")
    return res, dict(ops.LAUNCHES)


@pytest.mark.cuda
def test_dense_sharded_on_two_gloo_ranks_equals_device_plan(dev, tmp_path):
    """Two gloo ranks on cuda:0 run dense greedy under ``device_sharded`` at
    n = 8 192: both return the device plan's selections and evaluations,
    and each launched the fused gain kernel once per round on its rows."""
    from repro_torch.core import EvalConfig, ExemplarClustering, greedy
    from repro_torch.core.distributed import spawn_local
    from repro_torch.data.synthetic import blobs
    from repro_torch.kernels import _build

    _build.build_all(["marginal_gain"])      # once, before the ranks start
    k = 8
    X, _ = blobs(8192, 24, centers=12, seed=13)
    ref = greedy(ExemplarClustering(X, EvalConfig(backend="cuda")), k,
                 mode="device")
    ranks = spawn_local(_mesh_rank, 2, store_dir=tmp_path, args=(X, k),
                        timeout=300)
    for res, launches in ranks:
        assert res.indices == ref.indices
        assert res.evaluations == ref.evaluations
        np.testing.assert_allclose(res.trajectory, ref.trajectory, rtol=1e-5,
                                   atol=1e-5)
        assert launches.get("gain_update_eval") == k


def _evaluator_rank(rank, world, n):
    """One gloo rank of the standalone-evaluator test, on the one card."""
    torch.cuda.set_device(0)
    from repro_torch.core import EvalConfig
    from repro_torch.core import distributed
    from repro_torch.kernels import ops

    V, S, lengths, cache, _ = _problem("cuda", n=n, seed=3)
    d_e0 = torch.sum(V * V, dim=1)
    sh = distributed.resolve_mesh(None, ("data",))
    cfg = EvalConfig(backend="cuda")
    ops.LAUNCHES.clear()
    losses = distributed.make_distributed_eval(sh, cfg)(
        distributed.shard_ground_set(V, sh), S, lengths,
        distributed.shard_rows(d_e0, sh), n_total=n)
    gains = distributed.make_distributed_gains(sh, cfg)(
        distributed.shard_ground_set(V, sh), V[:257],
        distributed.shard_rows(cache, sh), n_total=n)
    torch.cuda.synchronize()
    return losses.cpu(), gains.cpu(), dict(ops.LAUNCHES)


@pytest.mark.cuda
def test_standalone_evaluators_launch_kernels_on_two_gloo_ranks(dev,
                                                                 tmp_path):
    """On the ``cuda`` backend, ``make_distributed_eval`` and
    ``make_distributed_gains`` launch the exemplar-eval and gain kernels on
    each rank's rows with the global n (n = 2 051, which 2 does not
    divide), and the shards' sum is within the fp32 band of the kernels
    launched once on the whole ground set."""
    from repro_torch.core.distributed import spawn_local
    from repro_torch.kernels import _build, ops

    _build.build_all(["exemplar_eval", "marginal_gain"])
    n = 2051
    V, S, lengths, cache, scale = _problem(dev, n=n, seed=3)
    d_e0 = torch.sum(V * V, dim=1)
    ref_l = ops.exemplar_eval(V, S, lengths, d_e0)
    ref_g = ops.marginal_gain(V, V[:257], cache)
    ranks = spawn_local(_evaluator_rank, 2, store_dir=tmp_path, args=(n,),
                        timeout=300)
    for losses, gains, launches in ranks:
        assert torch.equal(losses, ranks[0][0])
        assert torch.equal(gains, ranks[0][1])
        _band(losses, ref_l, BANDS["fp32"], scale)
        _band(gains, ref_g, BANDS["fp32"], scale)
        assert launches.get("fused_eval") == 1
        assert launches.get("gain_eval") == 1


@pytest.mark.cuda
def test_contract_audit_quick_on_the_card(dev):
    """The audit's quick grid on the card: the cuda backend's cases launch
    the gain and sieve kernels (every call a launch, no plain version),
    the sync-free cases run under the sync debug mode, and every contract
    holds."""
    import collections

    from repro_torch.analysis import audit
    from repro_torch.kernels import ops

    calls0 = collections.Counter(ops.CALLS)
    launches0 = collections.Counter(ops.LAUNCHES)
    teardown = audit._ensure_group()
    try:
        results, rt, uncovered, _ = audit.run_audit("cuda", quick=True)
    finally:
        teardown()
    assert not uncovered
    assert all(r.ok for r in results), [
        (r.label, list(map(str, r.violations))) for r in results if not r.ok]
    assert all(r["ok"] for r in rt), rt
    calls = collections.Counter(ops.CALLS) - calls0
    assert calls == collections.Counter(ops.LAUNCHES) - launches0
    assert {"gain_eval", "gain_update_eval", "gain_eval_batched",
            "gain_update_eval_batched", "sieve_gain_eval",
            "sieve_gain_eval_batched"} <= set(calls)
