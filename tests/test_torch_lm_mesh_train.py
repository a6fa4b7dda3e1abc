"""LM training on a mesh (``train.step.make_train_step(rules=)``,
``train.trainer.train(mesh=)``, the state's placement, FSDP and
tensor-parallel products with their gradients, expert parallelism's
backward, ``distributed/compression.py``, the checkpoint's mesh forms)
against the JAX package's own mesh training, on the CPU.

The rule tables run in-process: for every leaf of ``state_dims`` on the
rule meshes of ``tests/test_torch_lm_mesh.py``, the port's spec is the
reference's ``state_shardings`` spec (on an ``AbstractMesh``).

Everything else runs on gloo ranks (``spawn_local``), one spawn per mesh
shape (data, model) ∈ {(1, 2), (2, 2), (1, 4), (2, 4)}, each rank with one
torch thread. The reference runs in one subprocess (``run_with_devices``,
8 host devices) on meshes with ``Auto`` axes, in a thread beside the
ranks: its ``train(mesh=)`` resumes from the checkpoint that the port
wrote after two single-device warm steps (the compared batches' tokens
shuffled, so every embedding row the compared steps touch has a
gradient history: AdamW's step on a row with none is lr·sign(g), which
fp32 leaves undecided where g nearly cancels) and takes two steps on
each mesh. The port restores the same checkpoint onto its mesh and takes
the same two steps. Bands:

* the loss of each step within 1e-5 relative of the reference's on the
  same mesh shape, and of the port's single-device steps (``REL``);
* every leaf of params, master, m and v, gathered whole, within 1e-5 of
  the leaf's max |value| of both (``REL``; xlstm's and hymba's within
  ``SPREAD_FACTOR`` times the reference's own mesh-vs-one-device spread,
  see ``SPREAD``);
* each rank's bytes of params, master, m and v the sum of its blocks'
  (``MeshRules.local_shape``), replicated leaves bit for bit the same on
  every rank;
* with the clip binding, the grad norm within 1e-6 relative of the
  single-device norm (``NORM_REL``); a data-parallel sum left out and a
  replicated leaf counted on every rank in the norm each move the state
  out of the band;
* ``ef_int8_psum`` on four ranks bit for bit the reference's on the same
  x (seed 2, as ``tests/test_distributed.py``), ``bf16_psum`` within 1e-6
  of the sum's max, and that test's bounds;
* the reference's own elastic restore test, twinned; a checkpoint saved
  on (2, 2) after its two steps, restored on (1, 4) and on one device,
  whose next step is the (2, 2) run's within ``REL``; ``train(mesh=)``
  crashed and resumed bit for bit the straight run; the gather to one
  rank the all-gather's state;
* on (2, 4), the sequence-split decode of gemma3 within 5e-4 of the
  reference's flash-decoding run (the body of
  ``test_flash_decoding_matches_full_forward`` on an ``Auto`` mesh), and
  ``moe_ep`` within 1e-4 of the reference's (``test_moe_ep_matches_dense``'s
  inputs and mesh).

The ranks import this module: it imports no JAX.
"""
import json
import pathlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

from repro_torch import configs  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.distributed.sharding import MeshRules  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402

ARCHS = ("qwen3-0.6b", "qwen3-moe-30b-a3b", "granite-moe-3b-a800m",
         "whisper-small", "xlstm-1.3b", "hymba-1.5b", "pixtral-12b")
MOE = ("qwen3-moe-30b-a3b", "granite-moe-3b-a800m")
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4), "2x4": (2, 4)}
TRAIN_ON = {"1x2": ARCHS, "2x2": ARCHS, "1x4": MOE}
TRAIN_CASES = [(m, a) for m, archs in TRAIN_ON.items() for a in archs]
RULE_MESHES = [{"data": 1, "model": 4}, {"data": 2, "model": 2},
               {"pod": 2, "data": 2, "model": 2}, {"data": 16, "model": 16},
               {"pod": 2, "data": 16, "model": 16}, {"data": 8}]
B, S, WARM = 4, 16, 2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
#: the clip case: a clip far under the gradient's norm
CLIP = 0.05
REL = 1e-5
NORM_REL = 1e-6
DECODE_BOUND = 5e-4      # tests/test_distributed.py's flash-decoding bound
EP_BOUND = 1e-4          # and its moe_ep bound
PARTS = ("params", "master", "m", "v")
#: The families held to the reference's own spread: xLSTM's and hymba's
#: recurrent blocks make the gradients of their projections ill
#: conditioned (``tests/test_torch_lm_train.py``'s ``MOMENT_REL``), and v
#: squares the gradient. On these cases the reference's own
#: ``train(mesh=)`` and its single-device ``train`` from the same
#: checkpoint part by 2.3e-5–5.8e-5 of a leaf's max in m or v, and by up
#: to 1.7e-5 in the params (xlstm's embedding; hymba's ``dt_bias``, a leaf
#: that starts at zero, 5.2e-6), though only their summation orders
#: differ. Their leaves are held within ``SPREAD_FACTOR`` times that
#: spread, measured by the reference in each run for params and master
#: and for m and v apart (at least ``REL``); every other family within
#: ``REL``.
SPREAD = ("xlstm-1.3b", "hymba-1.5b")
SPREAD_FACTOR = 3.0
#: worker processes of the reference's subprocess
REF_WORKERS = 4


def _batches(cfg, seed=1):
    """The two compared batches and the two warm ones (their tokens and
    labels shuffled), numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
        if cfg.family in ("encdec", "vlm"):
            b["frontend"] = rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        out.append(b)
    warm = []
    for b in out:
        w = dict(b)
        for k in ("tokens", "labels"):
            w[k] = b[k].reshape(-1)[rng.permutation(B * S)].reshape(B, S)
        warm.append(w)
    return out, warm


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _mesh_rules(world, data):
    from torch.distributed.device_mesh import DeviceMesh

    grid = np.arange(world).reshape(data, world // data).tolist()
    return MeshRules.for_mesh(DeviceMesh("cpu", grid,
                                         mesh_dim_names=("data", "model")))


def _opt(**kw):
    return OptimizerConfig(**{**OPT, **kw})


def _arrays(state) -> dict:
    """``{part: {name: array}}`` of a whole train state (float32)."""
    out = {"params": {n: p.detach().float().numpy().copy()
                      for n, p in state["params"].named_parameters()}}
    for k in ("master", "m", "v"):
        out[k] = {n: t.numpy().copy() for n, t in state["opt"][k].items()}
    out["step"] = int(state["opt"]["step"])
    return out


def _gap(got: dict, want: dict, parts=PARTS) -> tuple:
    """Largest max|got − want| / max|want| over the leaves of ``parts``,
    and its leaf."""
    worst = (0.0, "")
    for part in parts:
        for n, w in want[part].items():
            err = float(np.abs(got[part][n].astype(np.float64) - w).max())
            worst = max(worst, (err / (float(np.abs(w).max()) or 1.0),
                                f"{part}/{n}"))
    return worst


GROUPS = (("params", "master"), ("m", "v"))


def _assert_close(got: dict, want: dict, bands=(REL, REL)):
    """params and master within ``bands[0]``, m and v within
    ``bands[1]``."""
    for parts, band in zip(GROUPS, bands):
        err, leaf = _gap(got, want, parts)
        assert err <= band, (leaf, err, band)


def _warm_dir(root, arch) -> pathlib.Path:
    return pathlib.Path(root) / "warm" / arch


def _steps(state, cfg, rules, batches, **opt):
    step = TS.make_train_step(cfg, _opt(**opt), rules=rules)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, _torch(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def _restore(root, arch, rules=None, step=None):
    cfg = configs.get_reduced_config(arch)
    target = TS.init_train_state(cfg, 0, "cpu")
    state, _ = CheckpointManager(_warm_dir(root, arch) if step is None
                                 else root, async_write=False).restore(
        target, step=step, device="cpu", shardings=rules)
    return cfg, state


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _replicated_digests(state, rules) -> dict:
    """Every replicated leaf's bits (params, master, m, v)."""
    plan = state["params"].placement
    out = {}
    for n, p in state["params"].named_parameters():
        if all(phys is None for phys in plan.specs[n]):
            out[f"params/{n}"] = p.detach().numpy().tobytes()
            for k in ("master", "m", "v"):
                out[f"{k}/{n}"] = state["opt"][k][n].numpy().tobytes()
    return out


def _bytes(state) -> tuple:
    """(this rank's bytes of params, master, m and v; the sum of its
    blocks' local shapes)."""
    plan = state["params"].placement
    rules = plan.rules
    dims = TM.named_param_dims(state["params"].cfg)
    cfg = state["params"].cfg
    whole = {n: s.shape for n, s in _named_shapes(cfg).items()}
    held = want = 0
    for n, p in state["params"].named_parameters():
        local = rules.local_shape(whole[n], dims[n])
        want += int(np.prod(local)) * (p.element_size() + 3 * 4)
        held += p.numel() * p.element_size()
        held += sum(state["opt"][k][n].numel() * 4 for k in ("master", "m",
                                                             "v"))
    return held, want


def _named_shapes(cfg) -> dict:
    out = {}
    TM._walk_named(cfg, lambda n, s: out.__setitem__(n, s))
    return out


def _train_cases(rules, name, root) -> dict:
    out = {}
    for arch in TRAIN_ON.get(name, ()):
        cfg, state = _restore(root, arch, rules)
        batches, _ = _batches(cfg)
        state, losses, norms = _steps(state, cfg, rules, batches)
        r = {"losses": losses, "bytes": _bytes(state),
             "replicated": _replicated_digests(state, rules)}
        r["whole"] = _arrays(TS.gather_train_state(state))
        out[arch] = r
    return out


def _clip_and_faults(rules, root) -> dict:
    """(2, 2): qwen3 and granite with the clip binding, and the two
    planted faults."""
    from repro_torch.distributed import parallel

    out = {}
    for arch in ("qwen3-0.6b", "granite-moe-3b-a800m"):
        cfg, state = _restore(root, arch, rules)
        batches, _ = _batches(cfg)
        state, losses, norms = _steps(state, cfg, rules, batches,
                                      grad_clip=CLIP)
        out[arch] = {"clip": {"norms": norms, "losses": losses,
                              "whole": _arrays(TS.gather_train_state(state))}}
    arch = "qwen3-0.6b"
    real_reduce, real_first = parallel._data_reduce, TS._first_replica
    try:   # a data-parallel gradient sum left out: each shard its own
        parallel._data_reduce = lambda sh, g, dim: (
            g if dim is None else g.chunk(sh.p, dim)[sh.index].contiguous())
        cfg, state = _restore(root, arch, rules)
        state, _, _ = _steps(state, cfg, rules, _batches(cfg)[0])
        out["no data sum"] = _arrays(TS.gather_train_state(state))
    finally:
        parallel._data_reduce = real_reduce
    try:   # a replicated leaf counted on every rank in the clip norm
        TS._first_replica = lambda rules, spec: True
        cfg, state = _restore(root, arch, rules)
        state, _, norms = _steps(state, cfg, rules, _batches(cfg)[0],
                                 grad_clip=CLIP)
        out["norm per rank"] = {"norms": norms,
                                "whole": _arrays(TS.gather_train_state(
                                    state))}
    finally:
        TS._first_replica = real_first
    return out


def _elastic_save(rules, root) -> dict:
    """(2, 2): two steps, a checkpoint at step 2 (every rank saves, rank
    0 writes), the third step."""
    cfg, state = _restore(root, "qwen3-0.6b", rules)
    batches, warm = _batches(cfg)
    three = batches + warm[:1]
    step = TS.make_train_step(cfg, _opt(), rules=rules)
    for b in three[:2]:
        state, _ = step(state, _torch(b))
    CheckpointManager(pathlib.Path(root) / "elastic", async_write=False) \
        .save(4, state)
    state, m = step(state, _torch(three[2]))
    return {"step3": _arrays(TS.gather_train_state(state)),
            "loss3": float(m["loss"])}


def _elastic_restore(rules, root) -> dict:
    """A checkpoint saved on another mesh, restored onto this one: the
    next step."""
    cfg, state = _restore(pathlib.Path(root) / "elastic", "qwen3-0.6b",
                          rules, step=4)
    batches, warm = _batches(cfg)
    state, losses, _ = _steps(state, cfg, rules, warm[:1])
    return {"step3": _arrays(TS.gather_train_state(state)),
            "loss3": losses[0]}


def _reshard_twin(rules, root) -> dict:
    """``tests/test_checkpoint.py::test_elastic_reshard_restore``'s twin:
    a whole (8, 8) leaf saved by rank 0, restored onto the mesh split
    ("data", "model")."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    cm = CheckpointManager(pathlib.Path(root) / "reshard", async_write=False)
    if dist.get_rank() == 0:
        cm.save(1, state)
    dist.barrier()
    sh = {"w": (rules.mesh, [Shard(0), Shard(1)])}
    restored, _ = cm.restore(state, shardings=sh)
    w = restored["w"]
    return {"placements": [str(p) for p in w.placements],
            "local": w.to_local().numpy(),
            "full": w.full_tensor().numpy()}


def _train_loop(rules, root) -> dict:
    """``train(mesh=)`` on (2, 2): four straight steps, and two steps with
    a checkpoint then a resume to four (the crash)."""
    from repro_torch.train.trainer import TrainConfig, train

    cfg = configs.get_reduced_config("qwen3-0.6b")
    batches = [b for pair in (_batches(cfg, s)[0] for s in (1, 2))
               for b in pair]
    mesh = rules.mesh
    straight, hist = train(cfg, TrainConfig(steps=4, log_every=1), _opt(),
                           iter(batches), mesh=mesh, device="cpu")
    d = str(pathlib.Path(root) / "loop")
    train(cfg, TrainConfig(steps=2, ckpt_every=2, ckpt_dir=d, log_every=1),
          _opt(), iter(batches), mesh=mesh, device="cpu")
    resumed, hist_r = train(cfg, TrainConfig(steps=4, ckpt_every=2,
                                             ckpt_dir=d, resume="auto",
                                             log_every=1),
                            _opt(), iter(batches[2:]), mesh=mesh,
                            device="cpu")
    return {"straight": _arrays(TS.gather_train_state(straight)),
            "resumed": _arrays(TS.gather_train_state(resumed)),
            "losses": [h["loss"] for h in hist],
            "resumed_losses": [h["loss"] for h in hist_r],
            "steps": CheckpointManager(d).all_steps()}


def _gather_to_one(rules) -> dict:
    """``gather_train_state(dst=0)`` against the all-gather path, an fp32
    and a bf16 model: rank 0 gets the same whole state, the others None."""
    import torch.distributed as dist

    out = {}
    for arch, dtype in (("granite-moe-3b-a800m", "float32"),
                        ("hymba-1.5b", "bfloat16")):
        cfg = configs.replace(configs.get_reduced_config(arch), dtype=dtype)
        state = TS.init_train_state(cfg, 0, "cpu", rules=rules)
        a = TS.gather_train_state(state)
        b = TS.gather_train_state(state, dst=0)
        if dist.get_rank() != 0:
            out[arch] = b is None
            continue
        same = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(
            a["params"].parameters(), b["params"].parameters()))
        out[arch] = same and all(
            torch.equal(a["opt"][k][n], b["opt"][k][n])
            for k in ("master", "m", "v") for n in a["opt"][k])
    return out


def _compression(rank) -> dict:
    from repro_torch.distributed.compression import bf16_psum, ef_int8_psum

    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 64)).astype(np.float32))[rank]
    err = torch.zeros_like(x)
    once, _ = ef_int8_psum(x, err)
    acc = torch.zeros_like(x)
    err = torch.zeros_like(x)
    for _ in range(20):
        y, err = ef_int8_psum(x, err)
        acc += y
    return {"once": once.numpy(), "avg": (acc / 20).numpy(),
            "bf16": bf16_psum(x).numpy()}


def _satellites(rules, root) -> dict:
    """(2, 4): gemma3's sequence-split decode and ``moe_ep`` on the
    reference's inputs."""
    import dataclasses

    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.models.moe_ep import moe_ep

    sat = _await(pathlib.Path(root) / "sat.npz")
    cfg = configs.get_reduced_config("gemma3-1b")
    tree: dict = {}
    for k in sat.files:
        if k.startswith("gemma/"):
            from repro_torch.convert import put_path
            put_path(tree, tuple(k.split("/")[1:]), sat[k])
    model = lm_params_from_arrays(cfg, tree, "cpu")
    tokens = torch.from_numpy(sat["tokens"])
    pre, n = int(sat["pre"]), tokens.shape[1]
    prefill = TS.make_prefill_step(cfg, n, rules=rules)
    serve = TS.make_serve_step(cfg, rules=rules)
    rows, real = [], TM.forward

    def tap(*a, **kw):
        logits, caches = real(*a, **kw)
        rows.append(logits[:, -1].clone())
        return logits, caches

    _, caches = prefill(model, {"tokens": tokens[:, :pre]})
    TM.forward = tap
    try:
        for pos in range(pre, n):
            _, caches = serve(model, {"tokens": tokens[:, pos:pos + 1],
                                      "caches": caches, "pos": pos})
    finally:
        TM.forward = real
    moe_cfg = dataclasses.replace(
        configs.get_reduced_config("qwen3-moe-30b-a3b"), moe_capacity=8.0)
    p = {k: torch.from_numpy(sat[f"moe/{k}"])
         for k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(sat["moe_x"])
    with torch.no_grad():
        ep = moe_ep(p, moe_cfg, TM.local_rows(rules, x), moe_cfg.act, rules)
    return {"decode": torch.stack(rows, 1).numpy(), "moe_ep": ep.numpy()}


def _await(path: pathlib.Path, timeout: float = 240.0):
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.2)
    return np.load(path)


def _rank_cases(rank, world, data, root):
    """Every case of one mesh shape, on one rank."""
    torch.set_num_threads(1)
    name = f"{data}x{world // data}"
    rules = _mesh_rules(world, data)
    out = {"data": rank // (world // data)}
    if name == "2x4":
        out.update(_satellites(rules, root))
        return out
    out["train"] = _train_cases(rules, name, root)
    if name == "2x2":
        out["faults"] = _clip_and_faults(rules, root)
        out["elastic"] = _elastic_save(rules, root)
        out["twin"] = _reshard_twin(rules, root)
        out["loop"] = _train_loop(rules, root)
        out["compression"] = _compression(rank)
        out["gather_to_one"] = _gather_to_one(rules)
    if name == "1x4":
        out["elastic"] = _elastic_restore(rules, root)
    return out


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

_REF_CODE = """
import json, pathlib
from functools import partial
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_reduced_config
from repro.distributed.compression import bf16_psum, ef_int8_psum
from repro.distributed.sharding import MeshRules
from repro.models import layers as L
from repro.models.model import forward, init_model
from repro.models.moe_ep import moe_ep
from repro.train.optimizer import OptimizerConfig
from repro.train.trainer import TrainConfig, train

ROOT = pathlib.Path({root!r})
TRAIN_ON = {train_on!r}
MESHES = {meshes!r}
OPT = OptimizerConfig(**{opt!r})


def mesh(shape):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, ("data", "model")[:len(shape)],
                         axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])


def flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, prefix + k + "/", out)
        else:
            out[prefix + k] = np.asarray(v)


# train(mesh=) on Auto meshes, resumed from the port's warm checkpoint,
# the cases spread over worker processes (each compiles its own steps;
# four host devices are enough for their meshes), started first
import os, sys
from concurrent.futures import ProcessPoolExecutor
import multiprocessing as mp
sys.path.insert(0, str(ROOT))
import ref_cases
cases = [(name, arch) for name, archs in TRAIN_ON.items() for arch in archs]
cases += [(None, arch) for arch in {spread!r}]
cases.sort(key=lambda c: -ref_cases.COST[c[1]])
jax.devices()          # this process keeps its 8 devices
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
ex = ProcessPoolExecutor({workers}, mp_context=mp.get_context("spawn"))
futures = [ex.submit(ref_cases.run, str(ROOT), *c) for c in cases]

sat = {{}}
# compression: tests/test_distributed.py's body on 4 devices
m4 = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,),
                   devices=jax.devices()[:4])
x = jnp.asarray(np.random.default_rng(2).normal(size=(4, 64)).astype(np.float32))

@partial(shard_map, mesh=m4, in_specs=(P("data"), P("data")),
         out_specs=(P("data"), P("data")), check_rep=False)
def reduce_once(xs, err):
    y, e = ef_int8_psum(xs[0], err[0], "data")
    return y[None], e[None]

@partial(shard_map, mesh=m4, in_specs=P("data"), out_specs=P("data"),
         check_rep=False)
def reduce_bf16(xs):
    return bf16_psum(xs[0], "data")[None]

y, _ = reduce_once(x, jnp.zeros_like(x))
sat["ef_once"] = np.asarray(y)
acc = np.zeros((4, 64), np.float32)
err = jnp.zeros_like(x)
for t in range(20):
    y, err = reduce_once(x, err)
    acc += np.asarray(y)
sat["ef_avg"] = acc / 20
sat["bf16"] = np.asarray(reduce_bf16(x))

# test_flash_decoding_matches_full_forward's body on an Auto (2, 4) mesh
cfg = get_reduced_config("gemma3-1b")
m24 = mesh((2, 4))
rules = MeshRules.for_mesh(m24)
params, _ = init_model(cfg, jax.random.PRNGKey(0))
Bd, Sd, PRE = 2, 24, 4
tokens = jax.random.randint(jax.random.PRNGKey(1), (Bd, Sd), 0, cfg.vocab_size)
full, _ = forward(params, cfg, {{"tokens": tokens}}, mode="train", remat=False)
_, caches = forward(params, cfg, {{"tokens": tokens[:, :PRE]}},
                    mode="prefill", cache_len=Sd, remat=False)

@jax.jit
def step(tok, caches, pos):
    return forward(params, cfg, {{"tokens": tok}}, mode="decode",
                   caches=caches, pos_offset=pos, rules=rules, remat=False)

rows, errs = [], []
with m24:
    for pos in range(PRE, Sd):
        lg, caches = step(tokens[:, pos:pos+1], caches,
                          jnp.asarray(pos, jnp.int32))
        rows.append(np.asarray(lg[:, 0]))
        errs.append(float(jnp.max(jnp.abs(lg[:, 0] - full[:, pos]))))
assert max(errs) < 5e-4, max(errs)
sat["decode"] = np.stack(rows, 1)
sat["tokens"] = np.asarray(tokens, np.int32)
sat["pre"] = np.asarray(PRE)
flat(params, "gemma/", sat)

# test_moe_ep_matches_dense's body on the same mesh
import dataclasses
mcfg = dataclasses.replace(get_reduced_config("qwen3-moe-30b-a3b"),
                           moe_capacity=8.0)
p_leaf = L.init_moe(jax.random.PRNGKey(0), mcfg, jnp.float32)
p = jax.tree.map(lambda l: l.value, p_leaf,
                 is_leaf=lambda x: hasattr(x, "dims"))
xm = jax.random.normal(jax.random.PRNGKey(1), (8, 16, mcfg.d_model))
dense = L.moe(p, mcfg, xm, mcfg.act, rules=None)
ep = jax.jit(lambda x: moe_ep(p, mcfg, x, mcfg.act, rules))(xm)
assert float(jnp.max(jnp.abs(dense - ep))) < 1e-4
sat["moe_ep"] = np.asarray(ep)
sat["moe_x"] = np.asarray(xm)
for k, v in p.items():
    sat["moe/" + k] = np.asarray(v)
np.savez(ROOT / "sat.tmp.npz", **sat)
(ROOT / "sat.tmp.npz").rename(ROOT / "sat.npz")
print("LOSSES " + json.dumps(dict(f.result() for f in futures)))
ex.shutdown()
"""

#: The reference's worker module: one ``train(mesh=)`` case a call
#: (``name`` None: one device, the spread's control).
_REF_CASES = """
import pathlib, shutil
import numpy as np
import jax
from jax.sharding import AxisType
from repro.configs import get_reduced_config
from repro.train.optimizer import OptimizerConfig
from repro.train.trainer import TrainConfig, train

MESHES = {meshes!r}
OPT = OptimizerConfig(**{opt!r})
#: rough compile seconds, to start the longest first
COST = {{"hymba-1.5b": 30, "xlstm-1.3b": 17, "whisper-small": 9,
        "granite-moe-3b-a800m": 8, "pixtral-12b": 6,
        "qwen3-moe-30b-a3b": 5, "qwen3-0.6b": 4}}


def run(root, name, arch):
    root = pathlib.Path(root)
    cfg = get_reduced_config(arch)
    d = root / "ref" / (name or "one") / arch
    shutil.copytree(root / "warm" / arch, d)
    data = np.load(root / "batches" / (arch + ".npz"))
    batches = [{{k.split("/")[1]: data[k] for k in data.files
                if k.startswith(f"{{i}}/")}} for i in range(2)]
    mesh = None
    if name is not None:
        shape = MESHES[name]
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
    _, hist = train(cfg, TrainConfig(steps=4, ckpt_every=4, ckpt_dir=str(d),
                                     resume="auto", log_every=1),
                    OPT, iter(batches), mesh=mesh)
    return (name or "one") + "/" + arch, [h["loss"] for h in hist]
"""


class _Reference:
    """The reference's subprocess, run in a thread beside the ranks."""

    def __init__(self, root):
        from conftest import run_with_devices

        meshes = {k: MESHES[k] for k in TRAIN_ON}
        (pathlib.Path(root) / "ref_cases.py").write_text(
            _REF_CASES.format(meshes=meshes, opt=OPT))
        code = _REF_CODE.format(root=str(root),
                                train_on={k: list(v)
                                          for k, v in TRAIN_ON.items()},
                                meshes=meshes, opt=OPT, spread=SPREAD,
                                workers=REF_WORKERS)
        self.out, self.error = None, None

        def run():
            try:
                self.out = run_with_devices(code, n_devices=8, timeout=900)
            except BaseException as e:      # raised on the test's thread
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def losses(self) -> dict:
        self.thread.join()
        if self.error is not None:
            raise self.error
        line = next(ln for ln in self.out.splitlines()
                    if ln.startswith("LOSSES "))
        return json.loads(line[len("LOSSES "):])


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The port's warm checkpoints (two single-device steps from the
    seed on the shuffled tokens) and the compared batches, one directory
    per architecture."""
    root = tmp_path_factory.mktemp("lm_mesh_train")
    (root / "batches").mkdir()
    for arch in ARCHS:
        cfg = configs.get_reduced_config(arch)
        batches, warm = _batches(cfg)
        state = TS.init_train_state(cfg, 0, "cpu")
        step = TS.make_train_step(cfg, _opt())
        for b in warm:
            state, _ = step(state, _torch(b))
        CheckpointManager(_warm_dir(root, arch), async_write=False) \
            .save(WARM, state)
        np.savez(root / "batches" / f"{arch}.npz",
                 **{f"{i}/{k}": v for i, b in enumerate(batches)
                    for k, v in b.items()})
    return root


@pytest.fixture(scope="module", autouse=True)
def reference(root):
    """Started with the module's first test, so the reference's compiles
    run beside the in-process tests and the ranks; waited for at the
    module's end, so no subprocess outlives it."""
    ref = _Reference(root)
    yield ref
    ref.thread.join()


_RANKS: dict = {}


@pytest.fixture(scope="module")
def mesh_run(root, reference):
    """``mesh_run(name)``: every rank's results on that mesh (one spawn
    per mesh shape; (1, 4) restores the (2, 2) run's checkpoint)."""
    def get(name):
        if name == "1x4":
            get("2x2")
        if name not in _RANKS:
            data, model = MESHES[name]
            try:
                _RANKS[name] = distributed.spawn_local(
                    _rank_cases, data * model, store_dir=root,
                    args=(data, str(root)), timeout=420)
            except (RuntimeError, TimeoutError) as e:
                _RANKS[name] = e
        if isinstance(_RANKS[name], Exception):
            raise _RANKS[name]
        return _RANKS[name]
    return get


_ONE: dict = {}


@pytest.fixture(scope="module")
def one_device(root):
    """The port's single-device steps from the same warm checkpoint:
    ``one_device(arch, **opt) -> (arrays, losses, norms)``."""
    def get(arch, **opt):
        key = (arch, tuple(sorted(opt.items())))
        if key not in _ONE:
            cfg, state = _restore(root, arch)
            state, losses, norms = _steps(state, cfg, None, _batches(cfg)[0],
                                          **opt)
            _ONE[key] = (_arrays(state), losses, norms)
        return _ONE[key]
    return get


def _ref_state(root, name, arch) -> dict:
    cfg = configs.get_reduced_config(arch)
    state, _ = CheckpointManager(pathlib.Path(root) / "ref" / name / arch) \
        .restore(TS.init_train_state(cfg, 0, "cpu"), step=4, device="cpu")
    return _arrays(state)


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


# ---------------------------------------------------------------------------
# the rule tables, in-process
# ---------------------------------------------------------------------------


def _ref_state_shardings(arch, meshes):
    """Per mesh, the reference's ``state_shardings`` flattened with their
    paths; and its state's shapes (traced abstractly once)."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config
    from repro.distributed.sharding import MeshRules as JRules
    from repro.train import step as JSt

    box = {}

    def init(key):
        state, dims = JSt.init_train_state(get_config(arch), key)
        box["dims"] = dims
        return state

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    sdims = JSt.state_dims(box["dims"])
    out = []
    for mesh in meshes:
        rules = JRules.for_mesh(AbstractMesh(tuple(mesh.values()),
                                             tuple(mesh)))
        sh = JSt.state_shardings(rules, shapes, sdims)
        out.append(jax.tree_util.tree_flatten_with_path(sh)[0])
    return out, shapes


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_state_specs_match_reference_state_shardings(arch):
    """Every leaf of the train state: the port's spec (``state_dims`` over
    ``Leaf.dims``) = the reference's ``state_shardings`` spec on every rule
    mesh, and ``state_shardings``' placements are the spec's; a
    parameter's own spec (its name's dims, unstacked) is the stacked
    leaf's without the layer dim."""
    import jax

    cfg = configs.get_config(arch)
    sdims = TS.state_dims(TM.param_dims(cfg))
    named = TM.named_param_dims(cfg)
    shapes = _named_shapes(cfg)
    flats, ref_shapes = _ref_state_shardings(arch, RULE_MESHES)
    tree = jax.tree.map(lambda s: TM.TensorSpec(tuple(s.shape), None),
                        ref_shapes)
    for mesh, flat in zip(RULE_MESHES, flats):
        rules = MeshRules.for_mesh(mesh)
        ours = TS.state_specs(rules, tree, sdims)
        placed = TS.state_shardings(rules, tree, sdims)
        for path, sharding in flat:
            leaf, pl = ours, placed
            for k in path:
                leaf, pl = leaf[k.key], pl[k.key]
            assert leaf == tuple(sharding.spec), (mesh, path)
            assert [str(p) for p in pl] == _placements_of(leaf, mesh), \
                (mesh, path)
        for n, s in shapes.items():
            spec = rules.spec(s.shape, named[n])
            path = n.split(".")
            stacked = ours["params"]
            if path[0] == "groups":
                for k in path[:2] + path[3:]:
                    stacked = stacked[k]
                assert stacked == (None,) + spec, (mesh, n)
            else:
                for k in path:
                    stacked = stacked[k]
                assert stacked == spec, (mesh, n)


def _placements_of(spec, mesh) -> list:
    """Per mesh dim, "S(i)" for the tensor dim it splits, else "R"."""
    out = []
    for ax in mesh:
        dims = [i for i, p in enumerate(spec)
                if p == ax or (isinstance(p, tuple) and ax in p)]
        out.append(f"S({dims[0]})" if dims else "R")
    return out


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_compression_matches_reference(mesh_run, root, reference):
    ranks = mesh_run("2x2")
    reference.losses()
    sat = np.load(root / "sat.npz")
    x = np.random.default_rng(2).normal(size=(4, 64)).astype(np.float32)
    exact = x.sum(0)
    scale = float(np.abs(exact).max())
    for q, r in enumerate(ranks):
        c = r["compression"]
        np.testing.assert_array_equal(c["once"], sat["ef_once"][q])
        np.testing.assert_array_equal(c["avg"], sat["ef_avg"][q])
        assert float(np.abs(c["bf16"] - sat["bf16"][q]).max()) <= \
            1e-6 * scale
        rel1 = float(np.abs(c["once"] - exact).max()) / scale
        relT = float(np.abs(c["avg"] - exact).max()) / scale
        assert rel1 < 0.05 and relT < rel1 / 2, (rel1, relT)
        assert float(np.abs(c["bf16"] - exact).max()) / scale < 0.02


# ---------------------------------------------------------------------------
# mesh training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,arch", TRAIN_CASES)
def test_mesh_train_matches_reference_mesh_train(mesh_run, root, reference,
                                                 name, arch):
    """Two steps on the mesh from the warm checkpoint: each step's loss
    within ``REL`` of the reference's ``train(mesh=)`` on an ``Auto`` mesh
    of the same shape, every leaf of the state within ``REL`` of its
    max."""
    r0 = mesh_run(name)[0]["train"][arch]
    want = reference.losses()[f"{name}/{arch}"]
    for got, w in zip(r0["losses"], want):
        assert _rel(got, w) <= REL, (r0["losses"], want)
    ref = _ref_state(root, name, arch)
    assert r0["whole"]["step"] == ref["step"] == WARM + 2
    _assert_close(r0["whole"], ref, _bands(root, reference, name, arch))


@pytest.mark.parametrize("name,arch", TRAIN_CASES)
def test_mesh_train_matches_single_device(mesh_run, one_device, root,
                                          reference, name, arch):
    r0 = mesh_run(name)[0]["train"][arch]
    one, losses, _ = one_device(arch)
    for got, w in zip(r0["losses"], losses):
        assert _rel(got, w) <= REL, (r0["losses"], losses)
    _assert_close(r0["whole"], one, _bands(root, reference, name, arch))


def _bands(root, reference, name, arch) -> tuple:
    """(params and master's band, m and v's): ``REL``, or for the
    ``SPREAD`` families ``SPREAD_FACTOR`` times the reference's own spread
    between its mesh run and its single-device run (at least ``REL``)."""
    if arch not in SPREAD:
        return REL, REL
    reference.losses()
    mesh, one = _ref_state(root, name, arch), _ref_state(root, "one", arch)
    return tuple(max(REL, SPREAD_FACTOR * _gap(mesh, one, parts)[0])
                 for parts in GROUPS)


@pytest.mark.parametrize("name", ["1x2", "2x2", "1x4"])
def test_each_rank_holds_its_blocks(mesh_run, name):
    """Each rank's bytes of params, master, m and v are its blocks'; at
    (2, 2) a quarter of the whole state but the replicated leaves."""
    ranks = mesh_run(name)
    for arch in TRAIN_ON[name]:
        cfg = configs.get_reduced_config(arch)
        shapes = _named_shapes(cfg)
        dims = TM.named_param_dims(cfg)
        whole = sum(int(np.prod(s.shape)) for s in shapes.values()) * 16
        rules = MeshRules.for_mesh(dict(zip(("data", "model"),
                                            MESHES[name])))
        replicated = sum(int(np.prod(s.shape)) * 16 for n, s in
                         shapes.items() if all(p is None for p in rules.spec(
                             s.shape, dims[n])))
        for r in ranks:
            held, want = r["train"][arch]["bytes"]
            assert held == want, (arch, held, want)
            if name == "2x2":      # a quarter, but leaves split once
                assert held <= (whole - replicated) / 4 + replicated \
                    + _split_once(rules, shapes, dims) / 4, arch


def _split_once(rules, shapes, dims) -> int:
    """Bytes (params, master, m, v) of the leaves split over one mesh dim
    only (a half each on (2, 2))."""
    return sum(int(np.prod(s.shape)) * 16 for n, s in shapes.items()
               if sum(p is not None for p in rules.spec(s.shape, dims[n]))
               == 1)


@pytest.mark.parametrize("name", ["1x2", "2x2", "1x4"])
def test_replicated_leaves_bit_equal_on_every_rank(mesh_run, name):
    ranks = mesh_run(name)
    for arch in TRAIN_ON[name]:
        first = ranks[0]["train"][arch]["replicated"]
        assert first
        for r in ranks[1:]:
            assert r["train"][arch]["replicated"] == first, arch


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_clip_norm_matches_single_device(mesh_run, one_device, arch):
    """The clip binds (norm ≫ clip) and the mesh's grad norm is the
    single-device norm within ``NORM_REL``; the clipped steps' state within
    ``REL``."""
    c = mesh_run("2x2")[0]["faults"][arch]["clip"]
    one, losses, norms = one_device(arch, grad_clip=CLIP)
    for got, w in zip(c["norms"], norms):
        assert w > 10 * CLIP
        assert _rel(got, w) <= NORM_REL, (c["norms"], norms)
    assert _gap(c["whole"], one)[0] <= REL


def test_planted_data_sum_left_out_is_caught(mesh_run, one_device):
    got = mesh_run("2x2")[0]["faults"]["no data sum"]
    assert _gap(got, one_device("qwen3-0.6b")[0])[0] > 100 * REL


def test_planted_norm_per_rank_is_caught(mesh_run, one_device):
    f = mesh_run("2x2")[0]["faults"]["norm per rank"]
    one, _, norms = one_device("qwen3-0.6b", grad_clip=CLIP)
    assert _rel(f["norms"][0], norms[0]) > 100 * NORM_REL
    assert _gap(f["whole"], one)[0] > REL


def test_gather_to_one_rank_is_the_all_gather(mesh_run):
    """The gather to rank 0 (the checkpoint's save) = the all-gather,
    fp32 and bf16 leaves bit for bit; the other ranks get None."""
    for r in mesh_run("2x2"):
        assert r["gather_to_one"] == {"granite-moe-3b-a800m": True,
                                      "hymba-1.5b": True}


# ---------------------------------------------------------------------------
# checkpoints on the mesh
# ---------------------------------------------------------------------------


def test_elastic_reshard_restore(mesh_run):
    """The port twin of ``tests/test_checkpoint.py``'s: a whole leaf saved
    unsharded, restored onto a (2, 2) mesh split ("data", "model")."""
    whole = np.arange(64, dtype=np.float32).reshape(8, 8)
    for q, r in enumerate(mesh_run("2x2")):
        t = r["twin"]
        assert t["placements"] == ["S(0)", "S(1)"]
        i, j = divmod(q, 2)
        np.testing.assert_array_equal(t["local"],
                                      whole[4 * i:4 * i + 4, 4 * j:4 * j + 4])
        np.testing.assert_array_equal(t["full"], whole)


@pytest.mark.parametrize("target", ["1x4", "one device"])
def test_restore_on_another_mesh_takes_the_same_step(mesh_run, root,
                                                     target):
    """Saved on (2, 2) at step 2; restored on (1, 4) or on one device, its
    next step is the (2, 2) run's step 3 within ``REL``."""
    want = mesh_run("2x2")[0]["elastic"]
    if target == "1x4":
        got = mesh_run("1x4")[0]["elastic"]
    else:
        cfg, state = _restore(pathlib.Path(root) / "elastic", "qwen3-0.6b",
                              None, step=4)
        state, losses, _ = _steps(state, cfg, None, _batches(cfg)[1][:1])
        got = {"step3": _arrays(state), "loss3": losses[0]}
    assert got["step3"]["step"] == want["step3"]["step"] == WARM + 3
    assert _rel(got["loss3"], want["loss3"]) <= REL
    assert _gap(got["step3"], want["step3"])[0] <= REL


def test_train_on_a_mesh_resumes_bit_for_bit(mesh_run):
    """``train(mesh=)`` on (2, 2), crashed after a checkpoint at step 2 and
    resumed: bit for bit the straight run of four steps; every rank the
    same losses."""
    ranks = mesh_run("2x2")
    loop = ranks[0]["loop"]
    assert loop["steps"] == [2, 4]
    assert loop["resumed_losses"] == loop["losses"][2:]
    for part in PARTS:
        for n, a in loop["straight"][part].items():
            np.testing.assert_array_equal(loop["resumed"][part][n], a)
    for r in ranks[1:]:
        assert r["loop"]["losses"] == loop["losses"]
    assert all(np.isfinite(loop["losses"]))


# ---------------------------------------------------------------------------
# the serving mesh against the reference's own mesh path
# ---------------------------------------------------------------------------


def _whole_rows(ranks, key):
    firsts = {}
    for r in ranks:
        firsts.setdefault(r["data"], r)
    return np.concatenate([firsts[d][key] for d in sorted(firsts)], axis=0)


def test_seqshard_decode_matches_reference_mesh(mesh_run, root, reference):
    """gemma3 (kv 1: the buffer split four ways) decoded 20 steps on
    (2, 4) from the reference's weights and tokens: each step's logits
    within 5e-4 of the reference's flash-decoding run on an ``Auto``
    (2, 4) mesh."""
    ranks = mesh_run("2x4")
    want = np.load(root / "sat.npz")["decode"]
    got = _whole_rows(ranks, "decode")
    assert got.shape == want.shape == (2, 20, want.shape[-1])
    assert float(np.abs(got - want).max()) < DECODE_BOUND


def test_moe_ep_matches_reference_mesh(mesh_run, root, reference):
    """``moe_ep`` on (2, 4) on ``test_moe_ep_matches_dense``'s inputs within
    1e-4 of the reference's ``moe_ep`` on its ``Auto`` (2, 4) mesh."""
    ranks = mesh_run("2x4")
    want = np.load(root / "sat.npz")["moe_ep"]
    got = _whole_rows(ranks, "moe_ep")
    assert float(np.abs(got - want).max()) < EP_BOUND
