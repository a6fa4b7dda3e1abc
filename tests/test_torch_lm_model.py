"""The port's LM assembly (``repro_torch.models.model``) against the JAX
package's ``forward``, with the reference's random parameters carried
across by ``convert.lm_params_from_arrays``, for every reduced config of
the ported families (``dense``, ``moe``, ``vlm``), in train, prefill and
decode.

Tolerances: fp32 logits and caches within 1e-5 of their max |value|
(``REL``); fp32 greedy tokens identical; decode against the port's own
full forward within the reference's bound, 5e-4 (``tests/test_models.py``).
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as JM
from repro.models.params import count_params as ref_count_params
from repro.models.params import dense_init as ref_dense_init
from repro.models.params import tree_bytes as ref_tree_bytes
from repro_torch import configs
from repro_torch.convert import (lm_caches_from_arrays, lm_params_from_arrays,
                                 tensor_from_array)
from repro_torch.models import model as TM
from repro_torch.models.params import count_params, dense_init, tree_bytes

REL = 1e-5
DECODE_BOUND = 5e-4

ARCHS = ["qwen3-0.6b", "gemma3-1b", "qwen3-32b", "stablelm-12b",
         "pixtral-12b", "granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
UNPORTED = ["xlstm-1.3b", "whisper-small", "hymba-1.5b"]
B, S, PRE = 2, 16, 8


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, rel=REL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} > {rel} x {scale:.3e}"


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f"{k}/{p}", t) for k in sorted(tree)
                for p, t in _leaves(tree[k])]
    return [("", tree)]


def _same_caches(got, want, what):
    gl, wl = _leaves(got), _leaves(jax.tree.map(np.asarray, want))
    assert [p for p, _ in gl] == [p for p, _ in wl], what
    for (p, g), (_, w) in zip(gl, wl):
        _close(g, w, what=f"{what} {p}")


@functools.lru_cache(maxsize=None)
def _jit_forward():
    return jax.jit(JM.forward, static_argnums=(1,),
                   static_argnames=("mode", "cache_len", "remat"))


def _inputs(cfg, B=B, S=S, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["frontend"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


def _cut(batch, lo, hi):
    return {k: (v[:, lo:hi] if k == "tokens" else v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """The reference's forward in all three modes, once per arch: the full
    sequence (train), the first PRE tokens (prefill) and the rest one
    token at a time (decode)."""
    arch = request.param
    jcfg = ref_configs.get_reduced_config(arch)
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    batch = _inputs(jcfg)
    P = jcfg.frontend_len if jcfg.family == "vlm" else 0
    fwd = _jit_forward()
    jb = jax.tree.map(jnp.asarray, batch)
    train, _ = fwd(params, jcfg, jb, mode="train", remat=False)
    pre_logits, pre_caches = fwd(params, jcfg, _cut(jb, 0, PRE),
                                 mode="prefill", cache_len=P + S, remat=False)
    caches, dec = pre_caches, []
    for pos in range(PRE, S):
        lg, caches = fwd(params, jcfg, {"tokens": jb["tokens"][:, pos:pos + 1]},
                         mode="decode", caches=caches,
                         pos_offset=jnp.int32(P + pos), remat=False)
        dec.append(np.asarray(lg[:, 0]))
    tcfg = configs.get_reduced_config(arch)
    return dict(
        arch=arch, cfg=tcfg, P=P, batch=batch, params=params,
        model=lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, params),
                                    device="cpu"),
        train=np.asarray(train), pre_logits=np.asarray(pre_logits),
        pre_caches=jax.tree.map(np.asarray, pre_caches),
        dec=np.stack(dec, 1), dec_caches=jax.tree.map(np.asarray, caches))


def test_train_matches_reference(case):
    with torch.no_grad():
        logits, caches = TM.forward(case["model"], _torch(case["batch"]))
    assert caches is None
    assert logits.shape == (B, S, case["cfg"].vocab_size)
    _close(logits, case["train"], what="train logits")


def test_prefill_matches_reference(case):
    """Logits, and the cache leaf by leaf (one allocation: the buffers the
    layers filled are the returned tree's)."""
    with torch.no_grad():
        logits, caches = TM.forward(case["model"],
                                    _torch(_cut(case["batch"], 0, PRE)),
                                    mode="prefill",
                                    cache_len=case["P"] + S)
    _close(logits, case["pre_logits"], what="prefill logits")
    _same_caches(caches, case["pre_caches"], "prefill cache")


def test_decode_matches_reference(case):
    """From the reference's prefill cache (``lm_caches_from_arrays``): each
    decode step's logits, the greedy tokens, and the cache after the last
    step, written in place."""
    cfg, P = case["cfg"], case["P"]
    caches = lm_caches_from_arrays(cfg, case["pre_caches"], device="cpu")
    ptrs = [t.data_ptr() for _, t in _leaves(caches)]
    toks = torch.from_numpy(case["batch"]["tokens"])
    out = []
    with torch.no_grad():
        for pos in range(PRE, S):
            lg, new = TM.forward(case["model"], {"tokens": toks[:, pos:pos + 1]},
                                 mode="decode", caches=caches,
                                 pos_offset=P + pos)
            assert new is caches
            out.append(lg[:, 0])
    got = torch.stack(out, 1)
    _close(got, case["dec"], what="decode logits")
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  case["dec"].argmax(-1))
    _same_caches(caches, case["dec_caches"], "decode cache")
    assert [t.data_ptr() for _, t in _leaves(caches)] == ptrs


def test_decode_matches_full_forward(case):
    """The port's own prefill + decode against its train-mode forward."""
    model, P = case["model"], case["P"]
    batch = _torch(case["batch"])
    with torch.no_grad():
        full, _ = TM.forward(model, batch)
        _, caches = TM.forward(model, _torch(_cut(case["batch"], 0, PRE)),
                               mode="prefill", cache_len=P + S)
        for pos in range(PRE, S):
            lg, caches = TM.forward(
                model, {"tokens": batch["tokens"][:, pos:pos + 1]},
                mode="decode", caches=caches, pos_offset=P + pos)
            err = float((lg[:, 0] - full[:, pos]).abs().max())
            assert err < DECODE_BOUND, f"pos {pos}: {err}"


def test_cache_specs_match_prefill(case):
    cfg, P = case["cfg"], case["P"]
    specs = TM.cache_specs(cfg, B, P + S)
    with torch.no_grad():
        _, caches = TM.forward(case["model"],
                               _torch(_cut(case["batch"], 0, PRE)),
                               mode="prefill", cache_len=P + S)
    got = [(p, tuple(t.shape), t.dtype) for p, t in _leaves(caches)]
    want = [(p, tuple(s.shape), s.dtype) for p, s in _leaves(specs)]
    assert got == want
    ref = JM.cache_specs(ref_configs.get_reduced_config(case["arch"]), B, P + S)
    assert [tuple(t.shape) for _, t in _leaves(caches)] == [
        tuple(s.shape) for s in jax.tree.leaves(ref)]


def test_param_counts(case):
    """The port's count equals the reference's tree exactly, and the
    analytic ``approx_params`` within 2 %, as the reference's test."""
    n = count_params(case["model"])
    assert n == ref_count_params(case["params"])
    assert tree_bytes(case["model"]) == ref_tree_bytes(case["params"]) == 4 * n
    approx = case["cfg"].approx_params()
    assert abs(n - approx) / n < 0.02, (n, approx)
    drawn = TM.init_model(case["cfg"], 0, device="cpu")
    assert count_params(drawn) == n


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS + ["paper-exemplar"])
def test_configs_match_reference(arch):
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for get in ("get_config", "get_reduced_config"):
        if arch == "paper-exemplar" and get == "get_reduced_config":
            continue
        ours, ref = (getattr(m, get)(arch) for m in (configs, ref_configs))
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        if arch != "paper-exemplar":
            assert ours.layer_types() == ref.layer_types()
            assert ours.groups() == ref.groups()
            assert ours.approx_params() == ref.approx_params()
            assert ours.q_per_kv == ref.q_per_kv
    cfg = configs.replace(configs.get_config("qwen3-0.6b"), dtype="float32")
    assert cfg.dtype == "float32" and cfg.name == "qwen3-0.6b"


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_families_raise(arch):
    cfg = configs.get_reduced_config(arch)
    for call in (lambda: TM.init_model(cfg, 0, device="cpu"),
                 lambda: TM.cache_specs(cfg, 1, 8),
                 lambda: TM.param_specs(cfg)):
        with pytest.raises(NotImplementedError, match=cfg.family):
            call()


def test_init_distribution_matches_reference():
    """``dense_init`` draws what the reference's does: a truncated normal
    (±2) scaled by the reference's fan-in — 1/√E for an expert stack
    (E, d, d_ff), 1/√(d·h) … for a matrix — and a drawn model's leaves
    have the reference's spread."""
    shape = (48, 64, 96)
    ours = dense_init(torch.Generator().manual_seed(0), shape, torch.float32)
    ref = np.asarray(ref_dense_init(jax.random.PRNGKey(0), shape, jnp.float32))
    assert abs(float(ours.std()) / float(ref.std()) - 1) < 0.02
    assert abs(float(ours.std()) * np.sqrt(48) / 0.8796 - 1) < 0.02
    assert float(ours.abs().max()) <= 2 / np.sqrt(48) + 1e-7
    cfg = configs.get_reduced_config("granite-moe-3b-a800m")
    model = TM.init_model(cfg, 3, device="cpu")
    params, _ = JM.init_model(ref_configs.get_reduced_config(
        "granite-moe-3b-a800m"), jax.random.PRNGKey(3))
    layer = model.groups["g0_moe"][0]
    ref_layer = params["groups"]["g0_moe"]
    for name in ("router", "w_gate", "w_up", "w_down"):
        a = float(layer["moe"][name].std())
        b = float(np.asarray(ref_layer["moe"][name][0]).std())
        assert abs(a / b - 1) < 0.1, (name, a, b)
    assert float(model.embed["w"].std()) == pytest.approx(0.02 * 0.8796,
                                                          rel=0.05)
    assert bool((model.final_norm["scale"] == 1).all())


def test_float64_serves_a_finer_reference():
    """A float64 config (the chip script's finer reference for the card)
    allocates float64 caches and decodes; its logits stay within 1e-5 of
    the fp32 model's with the same weights."""
    cfg = configs.get_reduced_config("granite-moe-3b-a800m")
    model = TM.init_model(cfg, 0, device="cpu")
    wide = copy.deepcopy(model).double()
    wide.cfg = configs.replace(cfg, dtype="float64")
    toks = torch.from_numpy(_inputs(cfg)["tokens"])
    with torch.no_grad():
        for m in (model, wide):
            _, caches = TM.forward(m, {"tokens": toks[:, :PRE]},
                                   mode="prefill", cache_len=S)
            lg, _ = TM.forward(m, {"tokens": toks[:, PRE:PRE + 1]},
                               mode="decode", caches=caches, pos_offset=PRE)
            if m is model:
                narrow = lg
    assert lg.dtype == torch.float64
    assert caches["g0_moe"]["attn"]["k"].dtype == torch.float64
    _close(narrow, lg.float(), what="fp32 vs float64")


def test_init_is_seeded():
    cfg = configs.get_reduced_config("qwen3-0.6b")
    a, b, c = (TM.init_model(cfg, s, device="cpu") for s in (0, 0, 1))
    assert torch.equal(a.embed["w"], b.embed["w"])
    assert not torch.equal(a.embed["w"], c.embed["w"])


def test_gemma_ring_cache_long_decode():
    """The reference's ``test_sliding_window_ring_cache_long_decode``
    inputs (B = 1, 40 tokens, window 16, prefill 8): decode spans 2.5
    windows. Each step equals the reference's decode and the port's own
    full forward; the caches after the last step equal the reference's."""
    jcfg = ref_configs.get_reduced_config("gemma3-1b")
    cfg = configs.get_reduced_config("gemma3-1b")
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, 40), 0,
                                         jcfg.vocab_size), np.int32)
    fwd = _jit_forward()
    _, jc = fwd(params, jcfg, {"tokens": jnp.asarray(toks[:, :8])},
                mode="prefill", cache_len=40, remat=False)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        full, _ = TM.forward(model, {"tokens": t})
        _, caches = TM.forward(model, {"tokens": t[:, :8]}, mode="prefill",
                               cache_len=40)
        for pos in range(8, 40):
            jl, jc = fwd(params, jcfg, {"tokens": jnp.asarray(toks[:, pos:pos + 1])},
                         mode="decode", caches=jc, pos_offset=jnp.int32(pos),
                         remat=False)
            lg, caches = TM.forward(model, {"tokens": t[:, pos:pos + 1]},
                                    mode="decode", caches=caches,
                                    pos_offset=pos)
            _close(lg, jl, what=f"pos {pos}")
            assert float((lg[:, 0] - full[:, pos]).abs().max()) < DECODE_BOUND
    _same_caches(caches, jc, "ring cache")


@pytest.mark.parametrize("prompt", [8, 16, 24, 32, 37])
def test_gemma_prefill_around_the_window(prompt):
    """Prompts shorter than, equal to and longer than the window (16),
    multiples of it and not: the ring cache leaf by leaf (the roll by
    ``kv_len % buf``), then 6 decode steps past it."""
    jcfg = ref_configs.get_reduced_config("gemma3-1b")
    cfg = configs.get_reduced_config("gemma3-1b")
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(2))
    model = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    toks = _inputs(jcfg, B=2, S=prompt + 6, seed=prompt)["tokens"]
    fwd = _jit_forward()
    jl, jc = fwd(params, jcfg, {"tokens": jnp.asarray(toks[:, :prompt])},
                 mode="prefill", cache_len=prompt + 6, remat=False)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        lg, caches = TM.forward(model, {"tokens": t[:, :prompt]},
                                mode="prefill", cache_len=prompt + 6)
        _close(lg, jl, what="prefill logits")
        _same_caches(caches, jc, f"prefill {prompt}")
        for pos in range(prompt, prompt + 6):
            jl, jc = fwd(params, jcfg, {"tokens": jnp.asarray(toks[:, pos:pos + 1])},
                         mode="decode", caches=jc, pos_offset=jnp.int32(pos),
                         remat=False)
            lg, caches = TM.forward(model, {"tokens": t[:, pos:pos + 1]},
                                    mode="decode", caches=caches,
                                    pos_offset=pos)
            _close(lg, jl, what=f"decode {pos}")
    _same_caches(caches, jc, f"decoded {prompt}")


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_reference(masked):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 7, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.4).astype(np.float32) if masked else None
    want = JM.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                      None if mask is None else jnp.asarray(mask))
    got = TM.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                     None if mask is None else torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_converters_reject_wrong_trees():
    cfg = configs.get_reduced_config("qwen3-0.6b")
    params, _ = JM.init_model(ref_configs.get_reduced_config("qwen3-0.6b"),
                              jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    tree["embed"]["w"] = tree["embed"]["w"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_arrays(cfg, tree, device="cpu")
    caches = jax.tree.map(np.asarray, JM.zero_caches(
        ref_configs.get_reduced_config("gemma3-1b"), 1, 8))
    with pytest.raises(ValueError, match="cache"):
        lm_caches_from_arrays(cfg, caches, device="cpu")


def test_bf16_arrays_carry_their_bits():
    a = np.asarray(jnp.asarray([1.0, -2.5, 3.14159, 1e-3], jnp.bfloat16))
    t = tensor_from_array(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
