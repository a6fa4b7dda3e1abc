"""The bf16 and fp16 policies' tensor-core tile (csrc/tc_tile.cuh) on the
CPU, where no kernel can run.

* ``kernels/ops.py``'s mirrors of the tile (``smem_bytes``,
  ``kernel_config``, ``gain_block_cols``, ``gain_grid``) against the
  constants the CUDA sources declare, and the shapes the main path and the
  sweep's ends launch fitting Hopper's 227 KB.
* The band argument: ``chip_smoke.py`` holds the tile to the plain version
  within ``BANDS[policy]`` of the scale. The tile sums the products of the
  rounded payload in fp32 in its own order (the MMA's); any fp32 order of a
  d-term Gram sum of the same rounded values — feature order, 16-feature
  chunks, reversed — stays within half that band of the float64 sum.
* The port's bf16 and fp16 plain versions, the tile's oracle on the card,
  against the JAX package's plain path (``repro.kernels.ref``) at the
  reference's per-policy bands, at the widths and segment edges the tile
  masks (d = 1, 45, 100, 129; n around SEG).
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax.numpy as jnp  # noqa: E402

from repro.core.precision import resolve as jresolve  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.precision import resolve as tresolve  # noqa: E402
from repro_torch.kernels import exemplar_eval as tee  # noqa: E402
from repro_torch.kernels import marginal_gain as tmg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
HALF = ("bf16", "fp16")
#: The reference's per-policy bands (tests/test_kernel_parity.py).
POLICY_TOLS = {"bf16": 5e-2, "fp16": 1e-2}


def _constants() -> dict:
    """Every ``constexpr int NAME = value;`` of the CUDA sources."""
    text = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu*")))
    found = {}
    for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text):
        assert found.setdefault(k, int(v)) == int(v), k
    return found


def _tc_smem(ncols, oc, d, kc):
    """csrc/tc_tile.cuh ``smem_bytes``, from the parsed constants: a ring of
    three V chunks of kc 16-bit features."""
    c = _constants()
    r16 = lambda x: (x + 15) & ~15  # noqa: E731
    kp = -(-d // c["KSTEP"]) * c["KSTEP"] if d > 0 else c["KSTEP"]
    return (3 * c["TM"] * kc * 2 + r16(ncols * kp * 2) + r16(ncols * 4)
            + 4 * oc * 4)


def test_mirrors_hold_the_tensor_core_constants():
    c = _constants()
    assert tops.TC_ROWS == c["TM"] == 64
    assert tops.TC_CHUNK_D == c["KCH"] == 64   # one 128-byte swizzle row
    assert tops.TC_EXEMPLAR_CHUNK_D == c["TC_KCH"] == 2 * c["KCH"]
    assert tops.TC_K_STEP == c["KSTEP"] == 16
    assert tops.TC_SETS == c["TC_SETS"] == 2 * 16
    assert tops.TC_SLOTS == c["TC_SLOTS"]
    assert tops.TC_GAIN_BLOCK_M == (2 * c["TC_NW"], 2 * c["TC_NW_NARROW"])
    assert c["TX"] * c["TY"] == 2 * c["WGT"] and c["SEG"] % c["TM"] == 0
    assert tops.SMEM_BUDGET == c["SMEM_LIMIT"]
    assert tops.TC_POLICIES == HALF
    assert [tops.tensor_cores(tresolve(p)) for p in chip_smoke.POLICIES] == \
        [p in HALF for p in chip_smoke.POLICIES]


@pytest.mark.parametrize("policy", HALF)
@pytest.mark.parametrize("d", [1, 45, 100, 129, 400, 1024])
def test_smem_mirror_is_the_c_formula(policy, d):
    """ops.smem_bytes at the tensor-core policies is the C launchers' sum:
    exemplar-eval blocks stage 32 sets × k_chunk slots (1, 2, or rounded up
    to 4),
    gain blocks their candidates (the row pass holds the winner)."""
    p = tresolve(policy)
    for kc in (1, 2, 3, 4, 10, 13):
        cap = kc if kc <= 2 else -(-kc // 4) * 4
        want = _tc_smem(tops.TC_SETS * cap, tops.TC_SETS, d,
                        _constants()["TC_KCH"])
        assert tops.smem_bytes(kc, d, p) == want
    for bc in tops.TC_GAIN_BLOCK_M:
        for update in (False, True):
            assert tops.smem_bytes(1, d, p, bc, update) == \
                _tc_smem(bc, bc, d, _constants()["KCH"])


@pytest.mark.parametrize("d", [1, 45, 100, 129])
def test_row_space_mirror(d):
    """The wrappers' workspace holds, after the partials, the row pass's
    norms and its 16-byte aligned rows of kpad(d) 16-bit values
    (csrc/tc_tile.cuh ``RowSpace``) on the tensor cores, nothing on the
    SIMT tile."""
    from repro_torch.kernels import _build

    kp = tops.tc_kpad(d)
    for head, B, n in ((0, 1, 255), (196 * 33, 1, 50_000), (5, 3, 1031)):
        got = _build.workspace_floats(head, B, n, d, True)
        start = -(-(head + B * n) // 4) * 4   # float offset of the rows
        assert start * 4 % 16 == 0 and start >= head + B * n
        assert got == start + B * n * kp // 2 and kp % 16 == 0
        assert _build.workspace_floats(head, B, n, d, False) == head


@pytest.mark.parametrize("policy", HALF)
def test_paper_and_sweep_shapes_fit_the_tile(policy):
    """The paper's shape (k = 10, d = 100), d = 129 and d = 1 024 fit 232 448
    bytes; k_chunk is the most slots that fit, all 10 at the paper's shape;
    the gain blocks take 256 candidates up to d = 320 and 64 from 400."""
    p = tresolve(policy)
    c = _constants()
    for k, d in ((10, 100), (10, 129), (12, 1024), (500, 100), (7, 45),
                 (1, 1)):
        cfg = tops.kernel_config(k, d, p)
        assert cfg.smem_bytes == tops.smem_bytes(cfg.k_chunk, d, p)
        assert cfg.smem_bytes <= c["SMEM_LIMIT"]
        assert 1 <= cfg.k_chunk <= k
        if cfg.k_chunk < k:
            assert tops.smem_bytes(cfg.k_chunk + 1, d, p) > c["SMEM_LIMIT"]
        assert cfg.block_l == tops.TC_SETS and cfg.block_n == tops.TC_ROWS
    assert tops.kernel_config(10, 100, p).k_chunk == 10
    assert tops.kernel_config(10, 100, p).grid(5000, 50_000) == (157, 25)
    for update in (False, True):
        for d, bc in ((1, 256), (100, 256), (129, 256), (320, 256),
                      (400, 64), (1024, 64)):
            assert tops.gain_block_cols(d, p, update) == bc
            assert tops.smem_bytes(1, d, p, bc, update) <= c["SMEM_LIMIT"]
    # a dense round at the paper's size, CELF's m = 256 re-score, a batched
    # round (B = 64, n = m = 8 192)
    assert tops.gain_grid(50_000, 50_000, 100, p) == (196, 25, 1)
    assert tops.gain_grid(50_000, 256, 100, p) == (1, 196, 1)
    assert tops.gain_grid(8192, 8192, 100, p, batch=64, update=True) == \
        (32, 4, 64)


def _rounded(a, policy):
    dt = {"bf16": torch.bfloat16, "fp16": torch.float16}[policy]
    return torch.as_tensor(a, dtype=torch.float32).to(dt).float().numpy()


def _payload(n, d, payload, seed):
    rng = np.random.default_rng(seed)
    sigma, shift = (1.0, 2.0) if payload == "wide" else ((2 * d) ** -0.5, 0.1)
    return rng.normal(size=(n, d)) * sigma + shift


def _gram_f32(X, Y, order):
    """fp32 sums of the exact products x_f·y_f (the rounded payloads'
    products are exact in fp32) over the features in one order."""
    d = X.shape[1]
    prods = (X[:, None, :].astype(np.float64) * Y[None, :, :]).astype(
        np.float32)
    if order == "chunks16":
        total = np.zeros(prods.shape[:2], np.float32)
        for c in range(0, d, 16):
            part = np.zeros(prods.shape[:2], np.float32)
            for f in range(c, min(d, c + 16)):
                part = part + prods[:, :, f]
            total = total + part
        return total
    feats = range(d - 1, -1, -1) if order == "reversed" else range(d)
    total = np.zeros(prods.shape[:2], np.float32)
    for f in feats:
        total = total + prods[:, :, f]
    return total


@pytest.mark.parametrize("payload", ["wide", "unit"])
@pytest.mark.parametrize("d", [1, 45, 100, 129, 1024])
@pytest.mark.parametrize("policy", HALF)
def test_any_fp32_order_of_the_gram_sum_stays_in_half_the_band(policy, d,
                                                               payload):
    X = _rounded(_payload(48, d, payload, d), policy)
    Y = _rounded(_payload(40, d, payload, d + 1), policy)
    G64 = X.astype(np.float64) @ Y.astype(np.float64).T
    vn = (X.astype(np.float64) ** 2).sum(1)
    sn = (Y.astype(np.float64) ** 2).sum(1)
    D64 = np.maximum(vn[:, None] + sn[None, :] - 2 * G64, 0.0)
    scale = max(1.0, float(np.abs(D64).max()), float(vn.max() + sn.max()))
    band = chip_smoke.BANDS[policy] * scale
    for order in ("features", "chunks16", "reversed"):
        G = _gram_f32(X, Y, order)
        err_g = float(np.abs(G.astype(np.float64) - G64).max())
        assert err_g <= 0.5 * band, (order, err_g / band)
        # the tile's epilogue: norms summed in fp32, (vn + sn) - 2g in fp32.
        # Its error grows with the norms' sums too: up to 0.73 of the band
        # here (bf16, d = 1 024, ``unit``, feature order), against 0.08 for
        # the Gram sums alone.
        vn32 = np.array([_gram_f32(x[None], x[None], order)[0, 0]
                         for x in X], np.float32)
        sn32 = np.array([_gram_f32(y[None], y[None], order)[0, 0]
                         for y in Y], np.float32)
        D = np.maximum((vn32[:, None] + sn32[None, :]) - np.float32(2) * G,
                       np.float32(0))
        err_d = float(np.abs(D.astype(np.float64) - D64).max())
        assert err_d <= band, (order, err_d / band)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _band(got, ref, band):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    assert err <= band * max(1.0, float(np.max(np.abs(ref)))), err


@pytest.mark.parametrize("n", [255, 257])
@pytest.mark.parametrize("d", [1, 45, 100, 129])
@pytest.mark.parametrize("policy", HALF)
def test_half_plain_versions_match_the_reference_plain_path(policy, d, n):
    """fused_eval, two_pass_eval and gain_eval's plain versions (min fold,
    sqeuclidean and rbf) against repro.kernels.ref on the same numpy
    inputs."""
    rng = np.random.default_rng(d * 1000 + n)
    l, k, m = 19, 7, 33
    V = (rng.normal(size=(n, d)) + 2.0).astype(np.float32)
    S = (rng.normal(size=(l, k, d)) + 2.0).astype(np.float32)
    lengths = rng.integers(1, k + 1, size=l).astype(np.int32)
    d_e0 = (rng.uniform(0.5, 1.5, size=n) * 2 * d).astype(np.float32)
    cache = (rng.uniform(0.5, 1.5, size=n) * 2 * d).astype(np.float32)
    C = V[rng.choice(n, size=m, replace=False)]
    tp, jp = tresolve(policy), jresolve(policy)
    tol = POLICY_TOLS[policy]
    for gamma in (None, 1.0 / d):
        e0 = d_e0 if gamma is None else 2 * (1 - np.exp(-gamma * d_e0))
        ca = cache if gamma is None else 2 * (1 - np.exp(-gamma * cache))
        e0, ca = e0.astype(np.float32), ca.astype(np.float32)
        kw = dict(n_total=n, policy=tp, rbf_gamma=gamma)
        args_j = (jnp.asarray(V), jnp.asarray(S), jnp.asarray(lengths),
                  jnp.asarray(e0), jp)
        _band(tee.fused_eval_plain(_t(V), _t(S), _t(lengths, torch.int32),
                                   _t(e0), layout="loop", **kw).numpy(),
              np.asarray(jref.exemplar_eval_ref(*args_j, rbf_gamma=gamma)),
              tol)
        _band(tee.two_pass_eval_plain(_t(V), _t(S), _t(lengths, torch.int32),
                                      _t(e0), **kw).numpy() * n,
              np.asarray(jref.work_matrix_ref(*args_j, rbf_gamma=gamma)) * n,
              tol)
        _band(tmg.gain_eval_plain(_t(V), _t(C), _t(ca), **kw).numpy(),
              np.asarray(jref.marginal_gain_ref(
                  jnp.asarray(V), jnp.asarray(C), jnp.asarray(ca), jp,
                  rbf_gamma=gamma)), tol)


@pytest.mark.parametrize("policy", HALF)
def test_half_inputs_take_the_same_plain_path_as_rounded_fp32(policy):
    """A payload already in the compute dtype and the same values in fp32
    give the same plain outputs (the tile rounds fp32 as it stages, to the
    same bits), bit for bit."""
    p = tresolve(policy)
    rng = np.random.default_rng(3)
    n, l, k, d = 300, 11, 5, 45
    V = _t(rng.normal(size=(n, d)) + 2.0)
    S = _t(rng.normal(size=(l, k, d)) + 2.0)
    lengths = _t(rng.integers(1, k + 1, size=l), torch.int32)
    d_e0 = _t(rng.uniform(0.5, 1.5, size=n) * 2 * d)
    kw = dict(n_total=n, policy=p, layout="loop")
    a = tee.fused_eval_plain(V, S, lengths, d_e0, **kw)
    b = tee.fused_eval_plain(V.to(p.compute_dtype), S.to(p.compute_dtype),
                             lengths, d_e0, **kw)
    assert torch.equal(a, b)
    g1 = tmg.gain_eval_plain(V, V[:40], d_e0, n_total=n, policy=p)
    g2 = tmg.gain_eval_plain(V.to(p.compute_dtype), V[:40].to(p.compute_dtype),
                             d_e0, n_total=n, policy=p)
    assert torch.equal(g1, g2)
