"""The port's LM assembly (``repro_torch.models.model``) against the JAX
package's ``forward``, with the reference's random parameters carried
across by ``convert.lm_params_from_arrays``, for every reduced config
(all six families: ``dense``, ``moe``, ``vlm``, ``encdec``, ``ssm``,
``hybrid``), in train, prefill and decode.

Tolerances: fp32 logits and caches within 1e-5 of their max |value|
(``REL``); fp32 greedy tokens identical; decode against the port's own
full forward within the reference's bound, 5e-4 (``tests/test_models.py``).
"""
import copy
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

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
         "pixtral-12b", "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
         "whisper-small", "xlstm-1.3b", "hymba-1.5b"]
#: The families whose caches hold more than K/V: recurrent state tuples,
#: conv states, whisper's encoder output.
NEW_FAMILIES = ["whisper-small", "xlstm-1.3b", "hymba-1.5b"]
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


_leaves = TM.tree_leaves


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
    if cfg.family in ("encdec", "vlm"):
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
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for _, t in _leaves(caches)] == [
        (tuple(s.shape), jnp.dtype(s.dtype).name) for s in jax.tree.leaves(ref)]


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


def _port_param_shapes(model) -> dict:
    """Path → (shape, dtype, layers) of the port's parameters, a group's
    per-layer trees folded into one entry (all layers alike)."""
    out = {}
    for name, t in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "groups":     # groups.<key>.<layer>.<path>
            key = "/".join(["", "groups", parts[1], *parts[3:]])
            shape, dtype, n = out.get(key, (tuple(t.shape), t.dtype, 0))
            assert (shape, dtype) == (tuple(t.shape), t.dtype), name
            out[key] = (shape, dtype, n + 1)
        else:
            out["/" + "/".join(parts)] = (tuple(t.shape), t.dtype, None)
    return out


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_init_model_matches_reference_tree(arch):
    """Every architecture builds on the CPU, and the drawn model's tree has
    the reference's paths, shapes and dtypes, in bf16: every leaf bf16 but
    ``a_log``, fp32 in both."""
    cfg = configs.replace(configs.get_reduced_config(arch), dtype="bfloat16")
    jcfg = ref_configs.replace(ref_configs.get_reduced_config(arch),
                               dtype="bfloat16")
    model = TM.init_model(cfg, 0, device="cpu")
    got = _port_param_shapes(model)
    want = dict(TM.tree_leaves(jax.eval_shape(
        lambda k: JM.init_model(jcfg, k)[0], jax.random.PRNGKey(0))))
    assert sorted(got) == sorted(want)
    for path, (shape, dtype, layers) in got.items():
        w = want[path]
        assert shape == (w.shape if layers is None else w.shape[1:]), path
        assert layers in (None, w.shape[0]), path
        assert str(dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name, \
            path
    a_log = [p for p in got if p.endswith("/a_log")]
    assert bool(a_log) == (cfg.family == "hybrid")
    assert all(got[p][1] == torch.float32 for p in a_log)
    assert count_params(model) == sum(math.prod(w.shape)
                                      for w in want.values())


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


@pytest.mark.parametrize("length", [16, 1500])
def test_sinusoid_matches_reference(length):
    """Whisper's frame positions, at the reduced and the published
    ``frontend_len``. Both tables round the angle to fp32, so at 1 500 rad
    they cannot agree closer than that rounding: the port is held to half
    an fp32 ulp of its largest angle."""
    want = np.asarray(JM._sinusoidal(length, 768))
    got = TM._sinusoidal(length, 768, "cpu").numpy()
    tol = 0.5 * float(np.spacing(np.float32(length - 1)))
    assert got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= tol


def test_unknown_init_raises():
    with pytest.raises(ValueError, match="unknown init"):
        TM._materialize(TM.Leaf((2,), "ones"), None, torch.float32, "cpu")


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


def test_params_keep_a_log_fp32_in_a_bf16_model():
    """``lm_params_from_arrays`` gives each leaf its spec's dtype: Mamba's
    ``a_log`` stays fp32 (bit for bit) while the rest is bf16."""
    jcfg = ref_configs.replace(ref_configs.get_reduced_config("hymba-1.5b"),
                               dtype="bfloat16")
    cfg = configs.replace(configs.get_reduced_config("hymba-1.5b"),
                          dtype="bfloat16")
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    for key in ("g0_hybrid_full", "g1_hybrid_sw"):
        mamba = model.groups[key][0]["mamba"]
        assert mamba["a_log"].dtype == torch.float32
        assert mamba["w_in"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            mamba["a_log"].numpy(),
            np.asarray(params["groups"][key]["mamba"]["a_log"][0]))


def _ref_prefill_cache(arch, cache_len=S):
    """Random arrays in the shape of the reference's prefill cache tree."""
    jcfg = ref_configs.get_reduced_config(arch)
    batch = jax.tree.map(jnp.asarray, _cut(_inputs(jcfg), 0, PRE))
    spec = jax.eval_shape(
        lambda k: JM.forward(JM.init_model(jcfg, k)[0], jcfg, batch,
                             mode="prefill", cache_len=cache_len,
                             remat=False)[1], jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    return jax.tree.map(lambda s: np.asarray(jnp.asarray(
        rng.standard_normal(s.shape), s.dtype)), spec)


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_caches_round_trip_new_families(arch):
    """``lm_caches_from_arrays`` takes the reference's cache tree (state
    tuples, conv states, ``enc_out``), its batch and buffer read off the
    tree, and keeps every leaf's bits and structure."""
    cfg = configs.get_reduced_config(arch)
    tree = _ref_prefill_cache(arch)
    got = lm_caches_from_arrays(cfg, tree, device="cpu")
    assert [p for p, _ in _leaves(got)] == [p for p, _ in _leaves(tree)]
    for (p, g), (_, w) in zip(_leaves(got), _leaves(tree)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=p)
    assert ("enc_out" in got) == (cfg.family == "encdec")
    assert any(type(v) is tuple for g in got.values() if isinstance(g, dict)
               for v in g.values()) == (cfg.family == "ssm")
    assert TM.cache_specs(cfg, B, S).keys() == got.keys()


@pytest.mark.parametrize("arch,other", [("xlstm-1.3b", "hymba-1.5b"),
                                        ("hymba-1.5b", "gemma3-1b"),
                                        ("whisper-small", "qwen3-0.6b"),
                                        ("qwen3-0.6b", "whisper-small")])
def test_caches_of_another_family_are_rejected(arch, other):
    tree = _ref_prefill_cache(arch)
    with pytest.raises(ValueError, match="cache"):
        lm_caches_from_arrays(configs.get_reduced_config(other), tree,
                              device="cpu")
