"""The port's LM layers (``repro_torch.models.layers``) against the JAX
package's, op by op, on the same numpy inputs.

Tolerances: fp32 outputs within 1e-5 of their max |value| (``REL``);
bf16 outputs within 2⁻⁷ of it (``REL_BF16``: one bf16 rounding of the
largest value, which a different fp32 accumulation order can move by one
step); masks, GQA repeats and MoE routing exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as ref_reduced
from repro.models import layers as JL
from repro_torch.configs import get_reduced_config
from repro_torch.convert import tensor_from_array
from repro_torch.models import layers as TL

REL = 1e-5
REL_BF16 = 2.0 ** -7


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


def _pair(a: np.ndarray, dtype="float32"):
    """The same array as a JAX and a torch tensor (bf16 rounded alike)."""
    j = jnp.asarray(a, dtype=jnp.dtype(dtype))
    return j, tensor_from_array(np.asarray(j), "cpu")


def _tree_pair(tree, dtype="float32"):
    j = jax.tree.map(lambda a: jnp.asarray(a, dtype=jnp.dtype(dtype)), tree)
    t = jax.tree.map(lambda a: tensor_from_array(np.asarray(a), "cpu"), j)
    return j, t


RNG = np.random.default_rng(7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_layer_norm(dtype):
    x = RNG.standard_normal((2, 5, 24)).astype(np.float32) * 3 + 0.5
    scale = RNG.uniform(0.5, 1.5, 24).astype(np.float32)
    bias = RNG.standard_normal(24).astype(np.float32)
    jx, tx = _pair(x, dtype)
    (jp, tp) = _tree_pair({"scale": scale, "bias": bias}, dtype)
    rel = REL if dtype == "float32" else REL_BF16
    got = TL.rms_norm(tp, tx, 1e-6)
    assert got.dtype == tx.dtype
    _close(got, JL.rms_norm(jp, jx, 1e-6), rel, "rms_norm")
    _close(TL.layer_norm(tp, tx, 1e-5), JL.layer_norm(jp, jx, 1e-5), rel,
           "layer_norm")


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(theta, batched, dtype):
    x = RNG.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = (RNG.integers(0, 600, (2, 7)) if batched
           else np.arange(590, 597)).astype(np.int32)
    jx, tx = _pair(x, dtype)
    got = TL.rope(tx, torch.from_numpy(pos), theta)
    assert got.dtype == tx.dtype
    _close(got, JL.rope(jx, jnp.asarray(pos), theta),
           REL if dtype == "float32" else REL_BF16, "rope")


@pytest.mark.parametrize("kind", ["causal", "sliding", "bidir", "cross"])
@pytest.mark.parametrize("kv_valid", [False, True])
def test_mask_bias_exact(kind, kv_valid):
    q_pos = np.arange(3, 12, dtype=np.int32)
    kv_pos = np.arange(14, dtype=np.int32)
    valid = RNG.random((2, 14)) > 0.3 if kv_valid else None
    want = JL._mask_bias("train", kind, 9, 14, jnp.asarray(q_pos),
                         jnp.asarray(kv_pos),
                         None if valid is None else jnp.asarray(valid), 4)
    got = TL._mask_bias("train", kind, 9, 14, torch.from_numpy(q_pos),
                        torch.from_numpy(kv_pos),
                        None if valid is None else torch.from_numpy(valid), 4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("g", [1, 2, 4])
def test_repeat_kv_is_jnp_repeat(g):
    k = RNG.standard_normal((2, 5, 3, 4)).astype(np.float32)
    got = TL._repeat_kv(torch.from_numpy(k), g)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.repeat(k, g, 2)))
    np.testing.assert_array_equal(
        got.numpy(), torch.from_numpy(k).repeat_interleave(g, dim=2).numpy())


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("batched_bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa(g, batched_bias, dtype):
    B, Q, K, Hk, D = 2, 6, 9, 2, 16
    q = RNG.standard_normal((B, Q, Hk * g, D)).astype(np.float32)
    k = RNG.standard_normal((B, K, Hk, D)).astype(np.float32)
    v = RNG.standard_normal((B, K, Hk, D)).astype(np.float32)
    valid = RNG.random((B, K)) > 0.2
    valid[:, 0] = True
    q_pos, kv_pos = np.arange(3, 9, dtype=np.int32), np.arange(K, dtype=np.int32)
    args = ("train", "causal", Q, K)
    jb = JL._mask_bias(*args, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                       jnp.asarray(valid) if batched_bias else None, None)
    tb = TL._mask_bias(*args, torch.from_numpy(q_pos),
                       torch.from_numpy(kv_pos),
                       torch.from_numpy(valid) if batched_bias else None, None)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    got = TL._sdpa(tq, tk, tv, tb, g)
    assert got.dtype == tq.dtype
    _close(got, JL._sdpa(jq, jk, jv, jb, None, g),
           REL if dtype == "float32" else REL_BF16, "sdpa")


def _attn_params(cfg, seed):
    from repro.models.layers import init_attention

    p = init_attention(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return jax.tree.map(lambda leaf: np.asarray(leaf.value), p,
                        is_leaf=lambda x: hasattr(x, "dims"))


def _attention_pair(arch, S, mask_kind, window, mode="train", B=1):
    jcfg, tcfg = ref_reduced(arch), get_reduced_config(arch)
    jp, tp = _tree_pair(_attn_params(jcfg, 3))
    x = RNG.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jx, tx = _pair(x)
    kw = dict(mask_kind=mask_kind, window=window, mode=mode)
    jy, jc = JL.attention(jp, jcfg, jx, **kw)
    ty, tc = TL.attention(tp, tcfg, tx, **kw)
    return (jy, jc), (ty, tc), (tp, tcfg, tx, kw)


@pytest.mark.parametrize("mask_kind,window", [("causal", None),
                                              ("sliding", 40)])
def test_blocked_attention_patched_block(monkeypatch, mask_kind, window):
    """The query-blocked path with its constants patched alike in both
    modules (block 16 from S = 32): equal to the reference's blocked path
    and to the port's own unblocked path; prefill's cache as well."""
    for mod in (JL, TL):
        monkeypatch.setattr(mod, "_BLOCK_Q_THRESHOLD", 32)
        monkeypatch.setattr(mod, "_BLOCK_Q", 16)
    for mode in ("train", "prefill"):
        (jy, jc), (ty, tc), (tp, tcfg, tx, kw) = _attention_pair(
            "qwen3-0.6b", 64, mask_kind, window, mode=mode, B=2)
        _close(ty, jy, what=f"blocked {mode}")
        if mode == "prefill":
            for n in ("k", "v"):
                _close(tc[n], jc[n], what=f"blocked prefill cache {n}")
    monkeypatch.setattr(TL, "_BLOCK_Q_THRESHOLD", 1 << 30)
    unblocked, _ = TL.attention(tp, tcfg, tx, **dict(kw, mode="train"))
    _close(ty, unblocked, what="blocked vs unblocked")


def test_blocked_attention_at_8192():
    """S = 8 192 reaches the blocked path with the real constants (sliding
    window, GQA 2)."""
    assert 8192 >= TL._BLOCK_Q_THRESHOLD and 8192 % TL._BLOCK_Q == 0
    (jy, _), (ty, _), _ = _attention_pair("qwen3-0.6b", 8192, "sliding", 300)
    _close(ty, jy, what="attention S=8192")


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_act(name):
    x = RNG.standard_normal(1000).astype(np.float32) * 4
    _close(TL._act(name)(torch.from_numpy(x)), JL._act(name)(jnp.asarray(x)),
           what=name)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(act, gated):
    from repro.models.layers import init_mlp

    p = init_mlp(jax.random.PRNGKey(5), 32, 48, jnp.float32, gated=gated)
    p = jax.tree.map(lambda leaf: np.asarray(leaf.value), p,
                     is_leaf=lambda x: hasattr(x, "dims"))
    jp, tp = _tree_pair(p)
    jx, tx = _pair(RNG.standard_normal((2, 5, 32)).astype(np.float32))
    _close(TL.mlp(tp, tx, act), JL.mlp(jp, jx, act), what=f"mlp {act}")


def _moe_pair(arch, capacity, zero_router=False, T=(2, 12), dtype="float32"):
    from repro.models.layers import init_moe

    jcfg, tcfg = ref_reduced(arch), get_reduced_config(arch)
    p = init_moe(jax.random.PRNGKey(9), jcfg, jnp.float32)
    p = jax.tree.map(lambda leaf: np.asarray(leaf.value), p,
                     is_leaf=lambda x: hasattr(x, "dims"))
    if zero_router:   # every logit equal: top-k ties to the lowest experts
        p["router"] = np.zeros_like(p["router"])
    x = RNG.standard_normal(T + (jcfg.d_model,)).astype(np.float32)
    jp, tp = _tree_pair(p, dtype)
    jx, tx = _pair(x, dtype)
    want = JL.moe(jp, jcfg, jx, jcfg.act, capacity_factor=capacity)
    got = TL.moe(tp, tcfg, tx, tcfg.act, capacity_factor=capacity)
    # the most assignments any expert gets, against the capacity C
    logits = x.reshape(-1, jcfg.d_model) @ p["router"]
    logits[:, jcfg.num_experts:] = -np.inf
    top = np.argsort(-logits, axis=1, kind="stable")[:, :jcfg.experts_per_tok]
    n_tok = int(np.prod(T))
    C = max(int(np.ceil(n_tok * jcfg.experts_per_tok / jcfg.expert_pad_to
                        * capacity)), 1)
    return got, want, int(np.bincount(top.ravel()).max()), C


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("capacity", [8.0, 1.0, 0.25])
def test_moe_with_and_without_drops(arch, capacity):
    """8.0 drops nothing; 1.0 and 0.25 drop the assignments past C
    (granite also pads 5 experts to 6, the pad never routed)."""
    got, want, most, C = _moe_pair(arch, capacity)
    assert (most > C) == (capacity < 8.0), (most, C)
    _close(got, want, what=f"moe capacity {capacity}")


@pytest.mark.parametrize("capacity", [8.0, 0.5])
def test_moe_ties_route_to_lower_experts(capacity):
    """A zero router ties every expert: lax.top_k takes the lowest K, and
    so must the port. At capacity 0.5 an expert keeps its first C tokens,
    so the later tokens get nothing."""
    got, want, most, C = _moe_pair("granite-moe-3b-a800m", capacity,
                                   zero_router=True)
    _close(got, want, what="moe ties")
    rows = got.reshape(-1, got.shape[-1]).abs().amax(dim=1)
    assert bool((rows[:min(C, 24)] > 0).all())
    assert bool((rows[C:] == 0).all()) and (C < 24) == (capacity < 8.0)


def test_moe_bf16():
    got, want, _, _ = _moe_pair("granite-moe-3b-a800m", 1.25, dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    _close(got, want, REL_BF16, "moe bf16")


def test_moe_decode_sized_call_drops():
    """C comes from this call's T: a decode-sized call (T = B = 2) at the
    configured 1.25 has C = 1 and drops what a prompt-sized call keeps,
    as in the reference."""
    got, want, most, C = _moe_pair("granite-moe-3b-a800m", 1.25, T=(2, 1))
    assert C == 1 and most > C
    _close(got, want, what="moe decode-sized call")
