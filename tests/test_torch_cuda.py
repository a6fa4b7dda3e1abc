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
