"""The port's train step (``repro_torch.train.step.make_train_step`` and
``train.optimizer``) against the JAX package's, one reduced config per
family (``dense``, ``moe``, local/global ``dense``, ``encdec``, ``ssm``,
``hybrid``), on the reference's state carried across by
``convert.lm_train_state_from_arrays``.

The state is the reference's after two of its own steps, so the moments
are warm: AdamW's first step divides each gradient by its own magnitude
(``m̂ / (√v̂ + eps)`` with ``v̂ = g²``), which turns a 1e-8 absolute
difference in a gradient of 1e-8 into a move of the full ``lr``; from the
third step the history dominates those entries.

Tolerances: loss, grad_norm, lr and every leaf of the updated state
(params, fp32 master, m, v) within 1e-5 of its max |value| (``REL``); for
xlstm's moments ``MOMENT_REL`` (see there). ``remat`` on and off are bit
for bit equal; ``microbatches=4`` is within the reference's own 1e-4 of one
batch (``tests/test_data_and_trainer.py``); ``lr_at`` exactly in the
warm-up and within lr·2⁻²³ on the cosine.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

from repro import configs as ref_configs
from repro.train import optimizer as JO
from repro.train import step as JSt
from repro_torch import configs
from repro_torch.convert import (lm_train_state_from_arrays,
                                 lm_train_state_to_arrays)
from repro_torch.models.model import tree_leaves
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TSt

REL = 1e-5
#: xlstm's m and v against the reference's. The mLSTM's normaliser
#: max(|den|, exp(−m)) makes the gradients of its projections ill
#: conditioned: on this state the reference's fp32 gradients of ``wq`` are
#: 7.9e-6 of their max from a float64 replay of the same arithmetic (the
#: port's 3.4e-6), and v squares the gradient, doubling that; the port's m
#: and v were 1.2e-5 and 1.6e-5 from the reference's. The reference's
#: xlstm cannot run in float64 (its scan carries are fp32), so this is the
#: closest check there is. Every other leaf of xlstm, and every leaf of the
#: other families, is held to ``REL``.
MOMENT_REL = {"xlstm-1.3b": 3e-5}
ARCHS = ["qwen3-0.6b", "granite-moe-3b-a800m", "gemma3-1b", "whisper-small",
         "xlstm-1.3b", "hymba-1.5b"]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B, S, WARM = 4, 16, 2


def _batches(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
        if cfg.family in ("encdec", "vlm"):
            b["frontend"] = rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype != np.int32 else np.asarray(a), tree)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """The reference's state after WARM steps, its next step and metrics;
    the port's step from the same state and batch."""
    arch = request.param
    jcfg = ref_configs.get_reduced_config(arch)
    tcfg = configs.get_reduced_config(arch)
    state, _ = JSt.init_train_state(jcfg, jax.random.PRNGKey(0))
    step = jax.jit(JSt.make_train_step(jcfg, JO.OptimizerConfig(**OPT), None))
    *warm, batch = _batches(jcfg, WARM + 1)
    for b in warm:
        state, _ = step(state, jax.tree.map(jnp.asarray, b))
    before = jax.tree.map(np.asarray, state)
    after, metrics = step(state, jax.tree.map(jnp.asarray, batch))
    port = lm_train_state_from_arrays(tcfg, before, device="cpu")
    new, pm = TSt.make_train_step(tcfg, TO.OptimizerConfig(**OPT))(
        port, _torch(batch))
    return dict(arch=arch, cfg=tcfg, before=before, batch=batch,
                want=_f32(after), got=lm_train_state_to_arrays(new),
                want_metrics={k: float(v) for k, v in metrics.items()},
                got_metrics={k: float(v) for k, v in pm.items()})


def test_train_step_matches_reference(case):
    for k, w in case["want_metrics"].items():
        g = case["got_metrics"][k]
        assert abs(g - w) <= REL * abs(w), (k, g, w)
    want, got = tree_leaves(case["want"]), tree_leaves(case["got"])
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        rel = REL
        if path.startswith(("/opt/m/", "/opt/v/")):
            rel = MOMENT_REL.get(case["arch"], REL)
        scale = float(np.abs(w).max())
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= rel * scale, f"{path}: {err:.3e} > {rel} x {scale:.3e}"


def test_step_counter_and_lr_follow_the_reference(case):
    assert int(case["got"]["opt"]["step"]) == WARM + 1
    assert case["got_metrics"]["lr"] == case["want_metrics"]["lr"]


def _port_state(cfg, seed=0):
    return TSt.init_train_state(cfg, seed, device="cpu")


def _leaves(state):
    return [t.detach().clone() for t in state["params"].parameters()] + [
        t.clone() for k in ("master", "m", "v")
        for t in state["opt"][k].values()]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-small"])
def test_remat_is_bit_for_bit(arch):
    """Each layer under ``torch.utils.checkpoint`` recomputes the same
    forward (whisper: the encoder's layers too): the updated state equals
    the one without remat bit for bit."""
    cfg = configs.get_reduced_config(arch)
    s1 = _port_state(cfg)
    s2 = copy.deepcopy(s1)
    batch = _torch(_batches(cfg, 1, seed=3)[0])
    opt = TO.OptimizerConfig(**OPT)
    _, m1 = TSt.make_train_step(cfg, opt, remat=True)(s1, batch)
    _, m2 = TSt.make_train_step(cfg, opt, remat=False)(s2, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(_leaves(s1), _leaves(s2)):
        assert torch.equal(a, b)


def test_microbatch_equivalence():
    """Gradient accumulation over microbatches ≈ full-batch step (the
    reference's ``test_trainer_microbatch_equivalence``, on the port)."""
    cfg = configs.get_reduced_config("qwen3-0.6b")
    opt = TO.OptimizerConfig(warmup_steps=1, total_steps=5)
    s1 = _port_state(cfg)
    s2 = copy.deepcopy(s1)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (8, 17)).astype(np.int32)
    batch = _torch({"tokens": toks[:, :16], "labels": toks[:, 1:]})
    _, m1 = TSt.make_train_step(cfg, opt)(s1, batch)
    _, m2 = TSt.make_train_step(cfg, opt, microbatches=4)(s2, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    diffs = [float((a.detach() - b.detach()).abs().max())
             for a, b in zip(s1["params"].parameters(),
                             s2["params"].parameters())]
    assert max(diffs) < 1e-4
    with pytest.raises(ValueError, match="microbatches"):
        TSt.make_train_step(cfg, opt, microbatches=3)(s2, batch)


@pytest.mark.parametrize("kw", [{}, dict(lr=1e-3, warmup_steps=10,
                                         total_steps=100),
                                dict(lr=3e-3, warmup_steps=5, total_steps=30,
                                     min_lr_ratio=0.0)])
def test_lr_schedule_matches_reference(kw):
    """Steps 0–120: the warm-up exactly; the cosine within lr·2⁻²³, the
    last bit of fp32 ``cos`` (XLA's and ATen's round differently, and
    neither is correctly rounded everywhere) carried through
    ``(1 − min_lr_ratio)/2 · lr`` and the ops after it."""
    want = np.asarray(JO.lr_at(JO.OptimizerConfig(**kw),
                               jnp.arange(121, dtype=jnp.int32)))
    got = TO.lr_at(TO.OptimizerConfig(**kw),
                   torch.arange(121, dtype=torch.int32)).numpy()
    assert got.dtype == want.dtype == np.float32
    warm = TO.OptimizerConfig(**kw).warmup_steps
    np.testing.assert_array_equal(got[:warm], want[:warm])
    lr = TO.OptimizerConfig(**kw).lr
    np.testing.assert_allclose(got, want, rtol=0, atol=lr * 2.0 ** -23)


def test_adamw_update_matches_reference_from_equal_gradients():
    """The update alone at step 0 and at a later step (bias corrections,
    clipping, weight decay), fed the same fp32 gradients on both sides."""
    rng = np.random.default_rng(4)
    shapes = [(3, 5), (7,), (2, 3, 4)]
    master = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [3 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    m = [0.1 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    v = [0.01 * rng.random(s).astype(np.float32) for s in shapes]
    for step, cfg in ((0, dict(grad_clip=1.0)), (7, dict(grad_clip=1e3))):
        jcfg = JO.OptimizerConfig(warmup_steps=3, total_steps=20, **cfg)
        names = [f"w{i}" for i in range(len(shapes))]
        jstate = {"master": dict(zip(names, map(jnp.asarray, master))),
                  "m": dict(zip(names, map(jnp.asarray, m))),
                  "v": dict(zip(names, map(jnp.asarray, v))),
                  "step": jnp.asarray(step, jnp.int32)}
        jp, js, jm = JO.adamw_update(jcfg, dict(zip(names, map(jnp.asarray,
                                                               grads))),
                                     jstate, jnp.float32)
        tstate = {"master": {n: torch.tensor(a) for n, a in
                             zip(names, master)},
                  "m": {n: torch.tensor(a) for n, a in zip(names, m)},
                  "v": {n: torch.tensor(a) for n, a in zip(names, v)},
                  "step": torch.tensor(step, dtype=torch.int32)}
        params = [torch.zeros(s) for s in shapes]
        ts, tm = TO.adamw_update(TO.OptimizerConfig(**dataclasses.asdict(
            jcfg)), [torch.tensor(g) for g in grads], tstate, params)
        assert int(ts["step"]) == step + 1
        for key in ("grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= REL * abs(
                float(jm[key]))
        for n, p in zip(names, params):
            for k in ("master", "m", "v"):
                w = np.asarray(js[k][n])
                err = np.abs(ts[k][n].numpy() - w).max()
                assert err <= REL * np.abs(w).max(), (step, k, n, err)
            np.testing.assert_array_equal(p.numpy(), ts["master"][n].numpy())


def test_global_norm_holds_at_large_leaves():
    """The clip's norm at an embedding-sized leaf (2·10⁷ elements) within
    1e-6 of float64's: a leaf summed sequentially in fp32 (the CPU's
    ``_foreach_norm``) is 5e-4 low there, and the clip scale, m and v
    carry that error."""
    g = torch.Generator().manual_seed(0)
    grads = [1e-3 * torch.randn(20_000_000, generator=g),
             torch.randn(3, 5, generator=g)]
    want = sum(float((t.double() ** 2).sum()) for t in grads) ** 0.5
    got = float(TO.global_norm(grads))
    assert abs(got - want) <= 1e-6 * want, (got, want)
