"""The LM stack's mesh (``repro_torch.distributed.sharding``, the placement
tables of ``train/step.py``, ``models/moe_ep.py``, the sequence-split
decode) against the JAX package, on the CPU.

The rule system runs in-process: the reference's ``MeshRules`` reads only
``mesh.shape`` and ``mesh.axis_names``, so a stand-in object drives it with
no devices. Its specs, every parameter's dim spec (``Leaf.dims`` against
``PLeaf.dims``, all ten architectures at their published sizes) and the
cache and batch tables must equal the reference's exactly.

The collectives run on gloo ranks (``spawn_local``), one spawn per mesh
shape (data, model) ∈ {(1, 1), (1, 2), (2, 2), (1, 4)}, each rank with one
torch thread, running every case of its mesh:

* ``moe_ep`` on the reduced qwen3-moe at capacity 8.0, B = 8, S = 16, held
  within 1e-4 of the reference's dense ``layers.moe`` (the bound of
  ``tests/test_distributed.py``), and the dense MoE on rows split over the
  data axes at capacity 1.0 (drops), within 1e-5 of the reference's on
  the whole batch;
* gemma3's sequence-split decode (kv = 1, window 16), B = 2, a 4-token
  prompt, decoded to 24 so the ring wraps, the port's seeded weights
  carried to the reference:
  logits within 5e-4 of the reference's ``forward(mode="train")`` at
  each position (the reference's own bound; its own flash-decoding test
  fails under jax 0.9.0, so the reference side runs unsharded);
* the whole serve path of other families (heads-split caches, expert
  parallelism, recurrent states split over the model axis, whisper's
  cross-attention, pixtral's prefix), teacher-forced, within 5e-4 of the
  reference's ``forward(mode="train")`` at each position on the port's
  seeded weights, and within 1e-5 of the logits' max of the port's
  single-device path on the same weights;
* every rank's tokens the same, and the logits of the ranks that share a
  data shard bit for bit the same;
* a census of one gemma3 decode step on two ranks.

The ranks import this module: it imports no JAX.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

from repro_torch import configs  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.distributed.sharding import MeshRules, NoRules  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.moe_ep import ep_applicable  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

MESHES = {"1x1": (1, 1), "1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
#: every family's mesh path, served against the port's single-device path
SERVE_ARCHS = ("qwen3-0.6b", "qwen3-moe-30b-a3b", "granite-moe-3b-a800m",
               "whisper-small", "xlstm-1.3b", "hymba-1.5b", "pixtral-12b")
SERVE_ON = {"1x1": ("qwen3-0.6b", "qwen3-moe-30b-a3b"),
            "1x2": SERVE_ARCHS, "2x2": SERVE_ARCHS,
            "1x4": ("qwen3-0.6b", "qwen3-moe-30b-a3b", "granite-moe-3b-a800m",
                    "hymba-1.5b")}
SERVE_CASES = [(m, a) for m, archs in SERVE_ON.items() for a in archs]
#: the rule meshes of the in-process parity tests
RULE_MESHES = [{"data": 1, "model": 4}, {"data": 2, "model": 2},
               {"pod": 2, "data": 2, "model": 2}, {"data": 16, "model": 16},
               {"pod": 2, "data": 16, "model": 16}, {"data": 8}]
EP_BOUND = 1e-4          # tests/test_distributed.py's moe_ep bound
DECODE_BOUND = 5e-4      # tests/test_distributed.py's flash-decoding bound
REL = 1e-5               # mesh against one device, of the logits' max
GEMMA = dict(B=2, PRE=4, S=24)
#: the serve cases: B rows, a PRE-token prompt, teacher-forced to S
#: (past the window of a sliding layer)
SERVE = dict(B=2, PRE=4)
MOE_X = dict(B=8, S=16)
#: the drop case: few tokens at capacity 1.0, so experts overflow
DROP_X = dict(B=4, S=2, capacity=1.0)


def _ref_mesh(shape: dict):
    return SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _ref_rules(shape: dict):
    from repro.distributed.sharding import MeshRules as JRules

    return JRules.for_mesh(_ref_mesh(shape))


# ---------------------------------------------------------------------------
# the rules, in-process
# ---------------------------------------------------------------------------

SPEC_CASES = [
    ((8, 128, 3, 64), (("batch",), (None,), ("tp",), (None, "tp")),
     (("pod", "data"), None, None, "model")),
    ((8, 128, 4, 64), (("batch",), (None,), ("tp",), (None, "tp")),
     (("pod", "data"), None, "model", None)),
    ((1, 4096, 512), (("batch",), ("sp",), (None,)), (None, "data", None)),
    ((49155, 1536), (("tp",), ("fsdp",)), (None, ("pod", "data"))),
]


@pytest.mark.parametrize("shape,dims,want", SPEC_CASES)
def test_spec_fallback_matches_reference(shape, dims, want):
    """The four cases of the reference's ``test_sharding_rules_fallback``
    on its (pod 2, data 2, model 2) mesh."""
    mesh = {"pod": 2, "data": 2, "model": 2}
    got = MeshRules.for_mesh(mesh).spec(shape, dims)
    assert got == want
    assert got == tuple(_ref_rules(mesh).spec(shape, dims))


def test_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard

    rules = MeshRules.for_mesh({"pod": 2, "data": 2, "model": 2})
    dims = (("batch",), (None,), ("tp",), (None, "tp"))
    assert rules.placements((8, 128, 3, 64), dims) == [Shard(0), Shard(0),
                                                       Shard(3)]
    assert rules.placements((1, 128, 4, 64), dims) == [Replicate(),
                                                       Replicate(), Shard(2)]
    assert rules.local_shape((8, 128, 3, 64), dims) == (2, 128, 3, 32)
    assert NoRules().spec((8, 4), (("batch",), (None,))) == ()
    with pytest.raises(ValueError, match="sizes alone"):
        rules.local(torch.zeros(8, 4), (("batch",), (None,)))


_REF_TREES: dict = {}


def _ref_params(arch):
    """(shapes, dims) of the reference's ``init_model`` at the published
    config, traced abstractly (no arrays allocated)."""
    if arch not in _REF_TREES:
        import jax

        from repro.configs import get_config
        from repro.models.model import init_model

        box = {}

        def init(key):
            params, dims = init_model(get_config(arch), key)
            box["dims"] = dims
            return params

        shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
        _REF_TREES[arch] = (jax.tree.map(lambda s: tuple(s.shape), shapes),
                            box["dims"])
    return _REF_TREES[arch]


def _port_shapes(cfg):
    """The port's parameter shapes, a group's stacked as the reference's."""
    def walk(s, lead=()):
        if isinstance(s, TM.Leaf):
            return lead + tuple(s.shape)
        return {k: walk(v, lead) for k, v in s.items()}

    spec = TM.param_specs(cfg)
    out = {k: walk(v) for k, v in spec.items() if k != "groups"}
    out["groups"] = {k: walk(layers[0], (len(layers),))
                     for k, layers in spec["groups"].items()}
    return out


def _pairs(shapes, dims, path=""):
    if isinstance(shapes, dict):
        assert isinstance(dims, dict) and set(shapes) == set(dims), path
        return [x for k in sorted(shapes)
                for x in _pairs(shapes[k], dims[k], f"{path}/{k}")]
    return [(path, tuple(shapes), tuple(dims))]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_dims_and_specs_match_reference(arch):
    """``Leaf.dims`` = the reference's ``PLeaf.dims`` leaf by leaf (groups
    stacked, the layer dim first), and the spec of every parameter leaf on
    every rule mesh = the reference's."""
    cfg = configs.get_config(arch)
    ref_shapes, ref_dims = _ref_params(arch)
    assert TM.param_dims(cfg) == ref_dims
    pairs = _pairs(_port_shapes(cfg), TM.param_dims(cfg))
    ref_pairs = _pairs(ref_shapes, ref_dims)
    assert pairs == ref_pairs
    for mesh in RULE_MESHES:
        ours, theirs = MeshRules.for_mesh(mesh), _ref_rules(mesh)
        for path, shape, dims in pairs:
            assert ours.spec(shape, dims) == tuple(theirs.spec(shape, dims)), \
                (mesh, path)


def _cache_trees(arch, B, cache_len, mesh):
    from repro.configs import get_config as ref_config
    from repro.models.model import cache_specs as ref_cache_specs
    from repro.train.step import cache_dims_tree as ref_cache_dims

    cfg = configs.get_config(arch)
    ours = TS.cache_dims_tree(cfg, TM.cache_specs(cfg, B, cache_len),
                              MeshRules.for_mesh(mesh))
    specs = ref_cache_specs(ref_config(arch), B, cache_len)
    theirs = ref_cache_dims(ref_config(arch), specs, _ref_rules(mesh))
    return cfg, ours, theirs, specs


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_dims_tree_matches_reference(arch, model):
    """The cache placement of every family = the reference's, and each
    rank's block (``cache_specs(rules=)``) = the reference's spec applied
    to the whole leaf."""
    import jax

    mesh = {"data": 2, "model": model}
    B, cache_len = 8, 4096
    cfg, ours, theirs, specs = _cache_trees(arch, B, cache_len, mesh)
    assert ours == theirs
    flat, treedef = jax.tree.flatten(specs)
    flat_dims = treedef.flatten_up_to(theirs)
    ref_rules = _ref_rules(mesh)
    want = []
    for s, d in zip(flat, flat_dims):
        spec = tuple(ref_rules.spec(s.shape, d))
        want.append(tuple(
            n // int(np.prod([mesh[a] for a in
                              ((p,) if isinstance(p, str) else p or ())]))
            for n, p in zip(s.shape, spec)))
    local = TM.cache_specs(cfg, B, cache_len, MeshRules.for_mesh(mesh))
    assert [tuple(t.shape) for _, t in TM.tree_leaves(local)] == want


def test_cache_dims_seqshard_choice():
    """kv heads that do not divide the model axis split the buffer
    (gemma3: kv 1), heads that do split the heads (qwen3-0.6b: kv 8)."""
    for arch, model, want in (("gemma3-1b", 4, TS.KV_DIMS_SEQSHARD),
                              ("qwen3-0.6b", 4, TS.KV_DIMS),
                              ("qwen3-0.6b", 16, TS.KV_DIMS_SEQSHARD),
                              ("gemma3-1b", 1, TS.KV_DIMS)):
        cfg, ours, theirs, _ = _cache_trees(arch, 4, 2048,
                                            {"data": 1, "model": model})
        first = next(iter(v for k, v in ours.items() if k != "enc_out"))
        assert first["attn"]["k"] == ((None,),) + want, (arch, model)
    assert TS.cache_dims_tree(configs.get_config("gemma3-1b"),
                              TM.cache_specs(configs.get_config("gemma3-1b"),
                                             4, 64))["g0_attn_local"] == \
        {"attn": {"k": ((None,),) + TS.KV_DIMS, "v": ((None,),) + TS.KV_DIMS}}


def test_batch_dims_match_reference():
    from repro.train.step import batch_dims as ref_batch_dims

    cfg = configs.get_reduced_config("pixtral-12b")
    tree = {"tokens": np.zeros((2, 8)), "labels": np.zeros((2, 8)),
            "frontend": np.zeros((2, 8, 64)), "pos": 3}
    assert TS.batch_dims(cfg, tree) == ref_batch_dims(cfg, tree)
    with pytest.raises(KeyError):
        TS.batch_dims(cfg, {"other": np.zeros(2)})


EP_CASES = [("qwen3-moe-30b-a3b", {"data": 2, "model": 4}, 8, 16),
            ("qwen3-moe-30b-a3b", {"data": 2, "model": 4}, 8, 1),
            ("qwen3-moe-30b-a3b", {"data": 3, "model": 2}, 8, 16),
            ("granite-moe-3b-a800m", {"data": 1, "model": 4}, 8, 16),
            ("granite-moe-3b-a800m", {"data": 1, "model": 2}, 8, 16),
            ("granite-moe-3b-a800m", {"data": 8}, 8, 16),
            ("granite-moe-3b-a800m", {"data": 1, "model": 4}, 4, 512)]


@pytest.mark.parametrize("arch,mesh,B,S", EP_CASES)
def test_ep_applicable_matches_reference(arch, mesh, B, S):
    from repro import configs as ref_configs
    from repro.models.moe_ep import ep_applicable as ref_ep

    sizes = MeshRules.for_mesh(mesh)
    # a stand-in mesh: the check reads the sizes only
    ours = dataclasses.replace(sizes, mesh=SimpleNamespace())
    full = S == 512       # the card's granite prefill
    cfg = (configs.get_config if full else configs.get_reduced_config)(arch)
    jcfg = (ref_configs.get_config if full
            else ref_configs.get_reduced_config)(arch)
    assert ep_applicable(cfg, ours, B, S) == ref_ep(jcfg, _ref_rules(mesh),
                                                    B, S)
    assert not ep_applicable(cfg, sizes, B, S)       # no mesh, no EP
    assert not ep_applicable(cfg, None, B, S)


def test_train_on_a_mesh_names_the_next_slice():
    """``train(mesh=)`` runs on a process group: without one it raises,
    naming what to call (the mesh's training is
    ``tests/test_torch_lm_mesh_train.py``'s)."""
    from repro_torch.train.trainer import TrainConfig, train
    from repro_torch.train.optimizer import OptimizerConfig

    with pytest.raises(RuntimeError, match="init_process_group"):
        train(configs.get_reduced_config("qwen3-0.6b"), TrainConfig(),
              OptimizerConfig(), iter(()), mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _mesh_rules(world, data):
    from torch.distributed.device_mesh import DeviceMesh

    grid = np.arange(world).reshape(data, world // data).tolist()
    return MeshRules.for_mesh(DeviceMesh("cpu", grid,
                                         mesh_dim_names=("data", "model")))


def _serve(model, tokens, pre, rules, extra=None):
    """Teacher-forced serving through the steps: prefill ``tokens[:, :pre]``,
    then decode the rest one token at a time. Returns this rank's rows'
    logits at each step (B_loc, S − pre + 1, V) and the steps' whole-batch
    next tokens (B, S − pre + 1)."""
    cfg = model.cfg
    P = cfg.frontend_len if cfg.family == "vlm" else 0
    S = tokens.shape[1]
    rows, real = [], TM.forward

    def tap(*a, **kw):
        logits, caches = real(*a, **kw)
        rows.append(logits[:, -1].clone())
        return logits, caches

    TM.forward = tap
    try:
        prefill = TS.make_prefill_step(cfg, P + S, rules=rules)
        step = TS.make_serve_step(cfg, rules=rules)
        tok, caches = prefill(model, {"tokens": tokens[:, :pre],
                                      **(extra or {})})
        out = [tok]
        for pos in range(pre, S):
            tok, new = step(model, {"tokens": tokens[:, pos:pos + 1],
                                    "caches": caches, "pos": P + pos})
            assert new is caches
            out.append(tok)
    finally:
        TM.forward = real
    return torch.stack(rows, 1).numpy(), torch.cat(out, 1).numpy()


def _serve_len(cfg) -> int:
    return 24 if cfg.sliding_window else 12


def _inputs(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    extra = {}
    if cfg.family in ("encdec", "vlm"):
        extra["frontend"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    return tokens, extra


def _moe_inputs(B, S, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _moe_weights(cfg, seed=0) -> dict:
    """The MoE block's weights, numpy-seeded with the fan-in scale."""
    rng = np.random.default_rng(seed)
    E, d, f = cfg.expert_pad_to, cfg.d_model, cfg.d_ff
    shapes = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
              "w_down": (E, f, d)}
    return {k: (rng.standard_normal(sh) / np.sqrt(sh[-2])).astype(np.float32)
            for k, sh in shapes.items()}


def _gemma():
    cfg = configs.get_reduced_config("gemma3-1b")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (GEMMA["B"], GEMMA["S"]))
    return TM.init_model(cfg, 0, device="cpu"), torch.from_numpy(tokens)


def _census_of_a_step(model, tokens, rules, cache_len):
    from repro_torch.analysis.census import take_census

    cfg = model.cfg
    S = tokens.shape[1]
    _, caches = TS.make_prefill_step(cfg, cache_len, rules=rules)(
        model, {"tokens": tokens})
    step = TS.make_serve_step(cfg, rules=rules)
    _, c = take_census(step, model, {"tokens": tokens[:, -1:],
                                     "caches": caches, "pos": S})
    s = c.summary()
    return {k: s[k] for k in ("collectives", "max_collective_bytes", "syncs",
                              "staging")}


def _rank_cases(rank, world, data):
    """Every case of one mesh shape, on one rank."""
    from repro_torch.models import layers as TL
    from repro_torch.models.moe_ep import moe_ep

    torch.set_num_threads(1)
    name = f"{data}x{world // data}"
    rules = _mesh_rules(world, data)
    out = {"data": rank // (world // data)}

    moe_cfg = configs.get_reduced_config("qwen3-moe-30b-a3b")
    p = {k: torch.from_numpy(v) for k, v in _moe_weights(moe_cfg).items()}
    x = torch.from_numpy(_moe_inputs(MOE_X["B"], MOE_X["S"],
                                     moe_cfg.d_model))
    if ep_applicable(moe_cfg, rules, MOE_X["B"], MOE_X["S"]):
        x_loc = rules.local(x, (("batch",), (None,), (None,)))
        out["moe_ep"] = moe_ep(p, moe_cfg, x_loc, moe_cfg.act,
                               rules).numpy()
    drop = dataclasses.replace(moe_cfg, moe_capacity=DROP_X["capacity"])
    xd = torch.from_numpy(_moe_inputs(DROP_X["B"], DROP_X["S"],
                                      moe_cfg.d_model, seed=2))
    data_sh = TM.row_shards(rules, DROP_X["B"])
    out["moe_drops"] = TL.moe(p, drop, rules.local(
        xd, (("batch",), (None,), (None,))) if data_sh else xd, drop.act,
        data=data_sh).numpy()

    gemma, toks = _gemma()
    out["gemma"] = _serve(gemma, toks, GEMMA["PRE"], rules)
    if name == "1x1":
        out["gemma one"] = _serve(gemma, toks, GEMMA["PRE"], None)
        out["gemma norules"] = _serve(gemma, toks, GEMMA["PRE"], NoRules())
    if name == "1x2":
        out["census"] = {
            key: _census_of_a_step(gemma, toks[:, :GEMMA["PRE"]], r,
                                   GEMMA["S"])
            for key, r in (("mesh", rules), ("one", None))}

    for arch in SERVE_ON[name]:
        cfg = configs.get_reduced_config(arch)
        model = TM.init_model(cfg, 0, device="cpu")
        tokens, extra = _inputs(cfg, SERVE["B"], _serve_len(cfg))
        out[arch] = {"mesh": _serve(model, tokens, SERVE["PRE"], rules,
                                    extra),
                     "one": _serve(model, tokens, SERVE["PRE"], None, extra),
                     "ep": cfg.family == "moe"
                     and ep_applicable(cfg, rules, SERVE["B"],
                                       SERVE["PRE"])}
    return out


_RANKS: dict = {}


def _ref_params_of(model) -> dict:
    """The port's parameters as the reference's tree (a group's layers
    stacked), numpy."""
    from repro_torch.convert import lm_ref_leaves, put_path

    tree: dict = {}
    for path, ts in lm_ref_leaves(model.named_parameters()).items():
        arrays = [t.detach().numpy() for t in ts]
        put_path(tree, path, np.stack(arrays) if path[0] == "groups"
                 else arrays[0])
    return tree


@pytest.fixture(scope="module")
def reference():
    """The reference's side: gemma3's and every serve family's train-mode
    logits with the port's seeded weights (the serve families' at the
    positions the serve steps score), and the reduced qwen3-moe's dense
    MoE on the numpy-seeded weights: at capacity 8.0, and at 1.0 (drops)
    against 8.0 on the drop case's whole batch."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config as ref_reduced
    from repro.models import layers as JL
    from repro.models.model import forward

    cfg = ref_reduced("gemma3-1b")
    model, toks = _gemma()
    params = jax.tree.map(jnp.asarray, _ref_params_of(model))
    full, _ = jax.jit(lambda p, t: forward(p, cfg, {"tokens": t},
                                           mode="train", remat=False))(
        params, jnp.asarray(toks.numpy(), jnp.int32))

    serve = {}
    for arch in SERVE_ARCHS:
        cfg = configs.get_reduced_config(arch)
        S = _serve_len(cfg)
        tokens, extra = _inputs(cfg, SERVE["B"], S)
        batch = {"tokens": jnp.asarray(tokens.numpy(), jnp.int32),
                 **{k: jnp.asarray(v.numpy()) for k, v in extra.items()}}
        params = jax.tree.map(jnp.asarray, _ref_params_of(
            TM.init_model(cfg, 0, device="cpu")))
        logits, _ = jax.jit(lambda p, b, c=ref_reduced(arch): forward(
            p, c, b, mode="train", remat=False))(params, batch)
        serve[arch] = np.asarray(logits)[:, SERVE["PRE"] - 1:S]

    mcfg = ref_reduced("qwen3-moe-30b-a3b")
    moe = jax.tree.map(jnp.asarray, _moe_weights(mcfg))

    def dense(c, x):
        return np.asarray(jax.jit(lambda p, x: JL.moe(p, c, x, c.act))(
            moe, jnp.asarray(x)))

    drop = dataclasses.replace(mcfg, moe_capacity=DROP_X["capacity"])
    xd = _moe_inputs(DROP_X["B"], DROP_X["S"], mcfg.d_model, seed=2)
    return {"gemma_train": np.asarray(full), "serve": serve,
            "moe_dense": dense(mcfg, _moe_inputs(MOE_X["B"], MOE_X["S"],
                                                 mcfg.d_model)),
            "moe_drops": dense(drop, xd), "moe_nodrop": dense(mcfg, xd)}


@pytest.fixture(scope="module")
def mesh_run(reference, tmp_path_factory):
    """``mesh_run(name)``: every rank's results on that mesh (one spawn
    per mesh shape, run the first time a test asks for it)."""
    def get(name):
        if name not in _RANKS:
            data, model = MESHES[name]
            try:
                _RANKS[name] = distributed.spawn_local(
                    _rank_cases, data * model,
                    store_dir=tmp_path_factory.mktemp(f"mesh{name}"),
                    args=(data,), timeout=180)
            except (RuntimeError, TimeoutError) as e:
                _RANKS[name] = e
        if isinstance(_RANKS[name], Exception):
            raise _RANKS[name]
        return _RANKS[name]
    return get


def _firsts(ranks):
    """Each data shard's first rank, in shard order."""
    firsts = {}
    for r in ranks:
        firsts.setdefault(r["data"], r)
    return [firsts[d] for d in sorted(firsts)]


def _whole(ranks, key, part=None):
    """The whole batch: each data shard's rows, in shard order."""
    return np.concatenate([r[key] if part is None else r[key][part]
                           for r in _firsts(ranks)], axis=0)


def _same_within_data_shards(ranks, get):
    for r in ranks:
        first = next(q for q in ranks if q["data"] == r["data"])
        a, b = get(first), get(r)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["1x1", "1x2", "2x2", "1x4"])
def test_moe_ep_matches_reference_dense_moe(mesh_run, reference, name):
    ranks = mesh_run(name)
    got = _whole(ranks, "moe_ep")
    want = reference["moe_dense"]
    err = float(np.abs(got - want).max())
    assert err < EP_BOUND, err
    _same_within_data_shards(ranks, lambda r: r["moe_ep"])


@pytest.mark.parametrize("name", ["1x2", "2x2"])
def test_dense_moe_on_split_rows_drops_as_the_whole_batch(mesh_run,
                                                          reference, name):
    """Capacity is the whole batch's and an assignment's queue rank counts
    the earlier shards' assignments: the drops are the reference's."""
    want = reference["moe_drops"]
    assert float(np.abs(want - reference["moe_nodrop"]).max()) > 1e-2
    got = _whole(mesh_run(name), "moe_drops")
    assert float(np.abs(got - want).max()) <= REL * float(np.abs(want).max())


def _gemma_rows(reference):
    pre, S = GEMMA["PRE"], GEMMA["S"]
    return reference["gemma_train"][:, pre - 1:S]


@pytest.mark.parametrize("name", ["1x1", "1x2", "2x2", "1x4"])
def test_seqshard_decode_matches_reference_forward(mesh_run, reference, name):
    """gemma3 (kv 1: the buffer split over the model axis wherever it is
    > 1) decoded past its 16-slot window: each position's logits within
    the reference's bound of its train-mode forward."""
    ranks = mesh_run(name)
    got = _whole(ranks, "gemma", 0)
    want = _gemma_rows(reference)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) < DECODE_BOUND * scale
    _same_within_data_shards(ranks, lambda r: r["gemma"][0])
    for r in ranks:
        assert np.array_equal(r["gemma"][1], ranks[0]["gemma"][1])
    assert np.array_equal(ranks[0]["gemma"][1], got.argmax(-1))


def test_rules_none_is_todays_path(mesh_run):
    """On a (1, 1) mesh, with ``NoRules`` and with no rules, the dense
    serve path is bit for bit one path."""
    (r,) = mesh_run("1x1")
    for key in ("gemma", "gemma norules"):
        for a, b in zip(r[key], r["gemma one"]):
            assert np.array_equal(a, b), key
    for a, b in zip(r["qwen3-0.6b"]["mesh"], r["qwen3-0.6b"]["one"]):
        assert np.array_equal(a, b)


def _tokens_agree(got, want, logits_one, err):
    """Equal tokens, except where the single-device top-2 margin is
    within 2 × the logits' largest gap."""
    top2 = np.sort(logits_one, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) <= 2 * err
    assert np.all((got == want) | tie)


@pytest.mark.parametrize("name,arch", SERVE_CASES)
def test_mesh_serve_matches_reference_forward(mesh_run, reference, name,
                                              arch):
    """The mesh's teacher-forced logits (heads-split decode, expert
    parallelism, recurrent states split over the model axis and gathered
    each step, cross-attention, a prefix) at each position within the
    reference's bound of its train-mode forward on the same weights."""
    got = np.concatenate([r[arch]["mesh"][0] for r in _firsts(
        mesh_run(name))], axis=0)
    want = reference["serve"][arch]
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err < DECODE_BOUND * scale, err


@pytest.mark.parametrize("name,arch", SERVE_CASES)
def test_mesh_serve_matches_single_device(mesh_run, name, arch):
    ranks = mesh_run(name)
    mesh_logits = np.concatenate(
        [r[arch]["mesh"][0] for r in _firsts(ranks)], axis=0)
    one_logits, one_tokens = ranks[0][arch]["one"]
    scale = max(1.0, float(np.abs(one_logits).max()))
    err = float(np.abs(mesh_logits - one_logits).max())
    assert err <= REL * scale, err
    _same_within_data_shards(ranks, lambda r: r[arch]["mesh"][0])
    for r in ranks:
        assert np.array_equal(r[arch]["mesh"][1], ranks[0][arch]["mesh"][1])
    _tokens_agree(ranks[0][arch]["mesh"][1], one_tokens, one_logits, err)
    if arch == "granite-moe-3b-a800m" and name == "1x4":
        # the reduced granite pads 5 experts to 6: no expert parallelism
        # on 4 model ranks, the dense MoE runs
        assert not ranks[0][arch]["ep"]
    elif "moe" in arch:
        assert ranks[0][arch]["ep"]


def test_decode_census_on_two_ranks(mesh_run):
    """One gemma3 decode step on (1, 2): one all-gather per attention
    layer (the (m, denom, o) of the flash-decoding combine), each of
    O(B·H·D) floats and not O(B·buf·H·D), and no host sync or staging that
    the single-device step does not have."""
    cfg = configs.get_reduced_config("gemma3-1b")
    B, H, D = GEMMA["B"], cfg.num_heads, cfg.head_dim
    for r in mesh_run("1x2"):
        c = r["census"]
        assert c["mesh"]["collectives"] == {"allgather_": cfg.num_layers}
        assert c["one"]["collectives"] == {}
        assert c["mesh"]["max_collective_bytes"] == B * H * (D + 2) * 4
        # the smallest buffer, the 16-slot ring, split over two ranks
        assert c["mesh"]["max_collective_bytes"] < \
            B * (cfg.sliding_window // 2) * H * D * 4
        assert (c["mesh"]["syncs"], c["mesh"]["staging"]) == \
            (c["one"]["syncs"], c["one"]["staging"]) == (0, 0)
