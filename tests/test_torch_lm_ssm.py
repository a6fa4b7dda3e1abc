"""The port's recurrent blocks (``repro_torch.models.ssm``) and its
cross-attention against the JAX package's, block by block, on the same
numpy inputs, with the reference's parameters carried across.

Tolerances: fp32 outputs and states within 1e-5 of their max |value|
(``REL``, ROADMAP's fp32 band); bf16 within 5e-2 of it (``REL_BF16``: the
two packages round a bf16 cumsum, logaddexp or conv tap at different
points). Reduced widths (the xlstm / hymba / whisper ``REDUCED`` configs).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as ref_reduced
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models.params import split_tree
from repro_torch.configs import get_reduced_config
from repro_torch.convert import tensor_from_array
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

REL = 1e-5
REL_BF16 = 5e-2
DTYPES = ["float32", "bfloat16"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, rel=REL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(got)), what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} > {rel} x {scale:.3e}"


def _rel(dtype):
    return REL if dtype == "float32" else REL_BF16


def _to_torch(tree):
    """A JAX tree as tensors of the same dtypes (bf16 bits carried)."""
    return jax.tree.map(lambda a: tensor_from_array(np.asarray(a), "cpu"), tree)


def _pair(a: np.ndarray, dtype="float32"):
    j = jnp.asarray(a, dtype=jnp.dtype(dtype))
    return j, tensor_from_array(np.asarray(j), "cpu")


def _params(init, arch, dtype, seed=0, **scale):
    """The reference's ``init_*`` block parameters and their torch twin;
    ``scale`` multiplies named leaves (wider gates stress the
    stabiliser)."""
    cfg = ref_reduced(arch)
    jp, _ = split_tree(init(jax.random.PRNGKey(seed), cfg, jnp.dtype(dtype)))
    for name, s in scale.items():
        jp[name] = (jp[name] * s).astype(jp[name].dtype)
    return cfg, get_reduced_config(arch), jp, _to_torch(jp)


def _states_close(got, want, rel, what):
    """A state tree (tuples of tensors) leaf by leaf: the reference's
    dtypes, values within ``rel``."""
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert str(g.dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name
        _close(g, w, rel, f"{what} leaf {i}")


RNG = np.random.default_rng(11)


@functools.lru_cache(maxsize=None)
def _jit(fn):
    """A reference block jitted (one compile per shape and mode instead of
    one per op)."""
    return jax.jit(fn, static_argnums=(1,), static_argnames=("mode",))


@pytest.mark.parametrize("dtype", DTYPES)
def test_headwise_rmsnorm(dtype):
    x = RNG.standard_normal((2, 5, 3, 8)).astype(np.float32) * 2
    scale = RNG.uniform(0.5, 1.5, (3, 8)).astype(np.float32)
    (jx, tx), (js, ts) = _pair(x, dtype), _pair(scale, dtype)
    got = TS._headwise_rmsnorm(tx, ts, 1e-6)
    assert got.dtype == tx.dtype
    _close(got, JS._headwise_rmsnorm(jx, js, 1e-6), _rel(dtype))


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` past 20, where ``F.softplus`` returns x."""
    x = np.linspace(-40, 40, 161).astype(np.float32)
    np.testing.assert_allclose(TS._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6)
    np.testing.assert_allclose(TS._log_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.log_sigmoid(x)), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv(with_state, dtype):
    x = RNG.standard_normal((2, 7, 12)).astype(np.float32)
    w = RNG.standard_normal((4, 12)).astype(np.float32) * 0.5
    st = RNG.standard_normal((2, 3, 12)).astype(np.float32)
    (jx, tx), (jw, tw), (jst, tst) = (_pair(a, dtype) for a in (x, w, st))
    jy, jn = JS._causal_conv(jx, jw, jst if with_state else None)
    ty, tn = TS._causal_conv(tx, tw, tst if with_state else None)
    assert ty.dtype == tx.dtype
    _close(ty, jy, _rel(dtype), "conv out")
    _close(tn, jn, 0.0, "conv state")


@pytest.mark.parametrize("n", [1, 2, 5, 7, 64, 128])
def test_associative_scan_is_laxs(n):
    """The odd/even recursion of ``lax.associative_scan``, odd lengths
    included, in fp32."""
    a = RNG.uniform(0.2, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = RNG.standard_normal((2, n, 3, 4)).astype(np.float32)

    def compose(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    jA, jB = jax.jit(functools.partial(jax.lax.associative_scan, compose,
                                       axis=1))((jnp.asarray(a), jnp.asarray(b)))
    tA, tB = TS._associative_scan(TS._compose, (torch.from_numpy(a),
                                                torch.from_numpy(b)))
    _close(tA, jA, what="A")
    _close(tB, jB, what="B")


@pytest.mark.parametrize("S,chunk", [(16, 16), (128, 128), (200, 40)])
def test_selective_scan_chunked(S, chunk):
    a = RNG.uniform(0.5, 1.0, (2, S, 6, 4)).astype(np.float32)
    b = RNG.standard_normal((2, S, 6, 4)).astype(np.float32) * 0.1
    h0 = RNG.standard_normal((2, 6, 4)).astype(np.float32)
    jh, jl = jax.jit(JS._selective_scan_chunked, static_argnums=3)(
        *map(jnp.asarray, (a, b, h0)), chunk)
    th, tl = TS._selective_scan_chunked(*map(torch.from_numpy, (a, b, h0)),
                                        chunk)
    _close(th, jh, what="hs")
    _close(tl, jl, what="h_last")


def _block_train_prefill(block_j, block_t, jp, tp, jcfg, tcfg, S, dtype):
    """The port's train mode (fresh state tensors) and prefill mode (the
    state written into the cache it is handed) against the reference's
    one full-sequence call: the output and the final state."""
    x = RNG.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jy, jc = _jit(block_j)(jp, jcfg, jx, mode="prefill")
    cache = _to_torch(jax.tree.map(jnp.zeros_like, jc))
    ptrs = [t.data_ptr() for t in jax.tree.leaves(cache)]
    for mode in ("train", "prefill"):
        ty, tc = block_t(tp, tcfg, tx, mode=mode,
                         cache=cache if mode == "prefill" else None)
        assert ty.dtype == tx.dtype
        _close(ty, jy, _rel(dtype), f"{mode} y")
        _states_close(tc, jc, _rel(dtype), f"{mode} state")
    assert tc is cache
    assert [t.data_ptr() for t in jax.tree.leaves(tc)] == ptrs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [16, 64, 100])
def test_mlstm_block(S, dtype):
    """One chunk, exactly one, and a padded two-chunk sequence (whose 28
    zero-gate steps move the running max); gates at 30x the init's scale,
    so the stabiliser works."""
    jcfg, tcfg, jp, tp = _params(JS.init_mlstm, "xlstm-1.3b", dtype,
                                 w_if=30.0)
    _block_train_prefill(JS.mlstm_block, TS.mlstm_block, jp, tp, jcfg, tcfg,
                         S, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_block(dtype):
    jcfg, tcfg, jp, tp = _params(JS.init_slstm, "xlstm-1.3b", dtype, r=10.0)
    _block_train_prefill(JS.slstm_block, TS.slstm_block, jp, tp, jcfg, tcfg,
                         24, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [16, 200])
def test_mamba_block(S, dtype):
    """One padded chunk of 128, and two (a = 1, b = 0 padding)."""
    jcfg, tcfg, jp, tp = _params(JS.init_mamba, "hymba-1.5b", dtype)
    assert tp["a_log"].dtype == torch.float32
    _block_train_prefill(JS.mamba_block, TS.mamba_block, jp, tp, jcfg, tcfg,
                         S, dtype)


def _random_state(spec, dtype):
    """A random cache of the reference's state shapes (mLSTM's m and the
    sLSTM's n kept positive, as a run leaves them)."""
    out = {}
    for name, s in spec.items():
        leaves = s if isinstance(s, tuple) else (s,)
        arrs = []
        for a in leaves:
            r = RNG.standard_normal(a.shape).astype(np.float32)
            arrs.append(r if a.dtype == jnp.float32 else
                        np.asarray(jnp.asarray(r, jnp.dtype(dtype))))
        out[name] = tuple(arrs) if isinstance(s, tuple) else arrs[0]
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["mlstm", "slstm", "mamba"])
def test_decode_step_from_a_given_state(kind, dtype):
    """One decode step from a random state: the output, and the new state
    written into the cache tensors the block was handed."""
    init, block_j, block_t, arch = {
        "mlstm": (JS.init_mlstm, JS.mlstm_block, TS.mlstm_block, "xlstm-1.3b"),
        "slstm": (JS.init_slstm, JS.slstm_block, TS.slstm_block, "xlstm-1.3b"),
        "mamba": (JS.init_mamba, JS.mamba_block, TS.mamba_block, "hymba-1.5b"),
    }[kind]
    jcfg, tcfg, jp, tp = _params(init, arch, dtype)
    _, spec = jax.eval_shape(
        functools.partial(block_j, cfg=jcfg, mode="prefill"), jp,
        x=jax.ShapeDtypeStruct((2, 4, jcfg.d_model), jnp.dtype(dtype)))
    state = _random_state(spec, dtype)
    if kind == "slstm":     # n is a running sum of positive weights
        state["ssm"] = tuple(np.abs(s) if i == 1 else s
                             for i, s in enumerate(state["ssm"]))
    jcache = jax.tree.map(jnp.asarray, state)
    tcache = _to_torch(state)
    leaves = jax.tree.leaves(tcache)
    x = RNG.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jy, jc = _jit(block_j)(jp, jcfg, jx, mode="decode", cache=jcache)
    ty, tc = block_t(tp, tcfg, tx, mode="decode", cache=tcache)
    assert tc is tcache
    assert all(a is b for a, b in zip(jax.tree.leaves(tc), leaves))
    _close(ty, jy, _rel(dtype), "decode y")
    _states_close(tc, jc, _rel(dtype), "decode state")


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_prefill_and_decode(dtype):
    """``attention(cross_x=)``: prefill takes K/V from the encoder's output
    into a frontend_len cache (no RoPE, no k-norm); decode reads that
    cache unchanged."""
    jcfg, tcfg = ref_reduced("whisper-small"), get_reduced_config(
        "whisper-small")
    jp, _ = split_tree(JL.init_attention(jax.random.PRNGKey(3), jcfg,
                                         jnp.dtype(dtype), cross=True))
    tp = _to_torch(jp)
    F_len = jcfg.frontend_len
    x = RNG.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    enc = RNG.standard_normal((2, F_len, jcfg.d_model)).astype(np.float32)
    (jx, tx), (je, te) = _pair(x, dtype), _pair(enc, dtype)
    kw = dict(mask_kind="cross", mode="prefill")
    attend = jax.jit(JL.attention, static_argnums=(1,),
                     static_argnames=("mask_kind", "mode"))
    jy, jc = attend(jp, jcfg, jx, cross_x=je, **kw)
    cache = {"k": torch.zeros((2, F_len, tcfg.num_kv_heads, tcfg.head_dim),
                              dtype=tx.dtype),
             "v": torch.zeros((2, F_len, tcfg.num_kv_heads, tcfg.head_dim),
                              dtype=tx.dtype)}
    ty, tc = TL.attention(tp, tcfg, tx, cross_x=te, cache=cache, **kw)
    assert tc is cache
    _close(ty, jy, _rel(dtype), "cross prefill")
    for name in ("k", "v"):
        _close(tc[name], jc[name], _rel(dtype), f"cross cache {name}")
    before = {k: v.clone() for k, v in tc.items()}
    x1 = RNG.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jx1, tx1 = _pair(x1, dtype)
    jy, _ = attend(jp, jcfg, jx1, mode="decode", pos_offset=5, cache=jc,
                   cross_x=je, mask_kind="cross")
    ty, tc2 = TL.attention(tp, tcfg, tx1, mode="decode", pos_offset=5,
                           cache=tc, cross_x=te, mask_kind="cross")
    assert tc2 is tc and all(torch.equal(tc[k], before[k]) for k in tc)
    _close(ty, jy, _rel(dtype), "cross decode")
