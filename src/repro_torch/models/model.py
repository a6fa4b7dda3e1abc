"""Model assembly: embedding → layer groups → head, for all six families.

The port of the JAX package's ``models/model.py``: ``dense``, ``moe``,
``vlm``, ``encdec`` (whisper: a bidirectional encoder over the frontend's
frames with sinusoidal positions, and a decoder with learned positions
``dec_pos`` and cross-attention), ``ssm`` (xLSTM's 7:1 mLSTM:sLSTM) and
``hybrid`` (hymba: attention and Mamba heads in parallel). Layer
heterogeneity is kept as the reference's *grouping*: consecutive layers of
one kind form a group ``g{i}_{kind}``, here one ``nn.ModuleList`` of
per-layer parameter trees (the reference stacks them for ``lax.scan``);
whisper's encoder is group ``g0_enc_attn``.

Modes:
  * ``train``   — full-sequence forward, no caches; with ``remat=True``
    each layer runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` per layer): its activations are recomputed in the
    backward pass instead of kept.
  * ``prefill`` — full-sequence forward; allocates the decode cache once
    (:func:`zero_caches`) and fills it.
  * ``decode``  — one token at a host position against the caches, which
    it updates in place (ring buffers for sliding windows, O(1) recurrent
    states for the SSM blocks, the encoder's output read unchanged).

The cache is the reference's tree: a dict keyed like :func:`cache_specs`
with stacked ``(count, B, …)`` leaves per group — K and V, and the
recurrent states as the reference's tuples — plus whisper's ``enc_out``,
so the two can be compared leaf by leaf.

On a mesh (``rules``: a :class:`~repro_torch.distributed.sharding.MeshRules`
on a ``DeviceMesh``) every rank runs :func:`forward` with the whole
batch. It keeps its own rows (split over the data axes when the batch
divides them) and returns its rows' logits.

Serving (``prefill``, ``decode``) holds the weights whole on every rank
and each rank's own block of each cache leaf (the placement of
``train.step.cache_dims_tree``: a :class:`MeshCaches`); the dense layers
run on each rank's rows as they do on one device, and the collectives
are the two regions of the reference's mesh — expert-parallel MoE
(:mod:`repro_torch.models.moe_ep`) and the sequence-split decode
(``layers._decode_attn_seqshard``) — the attention heads' outputs where
the cache is split over its heads, the whole batch's expert counts where
the dense MoE drops, and, for a recurrent state split over the model
axis, its blocks gathered for the step (the blocks then keep their part).

Training (``train`` mode on a model placed by :func:`place_model`, the
rows then always split over the data axes) holds each parameter as this
rank's block of its leaf (:mod:`repro_torch.models.placed`). Each layer
gathers its leaves when it runs — again in remat's recompute — and the
backward adds each leaf's gradient over the ranks that computed it and
cuts it back to the block (FSDP over the data axes). Attention whose heads
split over the model axis and MLPs whose ``d_ff`` does are
tensor-parallel (column-split input products, row-split output products
added over the model group, ``layers._attention_tp`` and ``layers.mlp``);
expert-parallel MoE keeps each rank's experts and differentiates through
its exchanges; every other leaf (the SSM blocks, the embedding and the
tied head, ``dec_pos``, the norms) is gathered whole.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.core.distributed import gather_cat
from repro_torch.core.multiset import resolve_device
from repro_torch.distributed.sharding import MeshRules, on_mesh
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe_ep import ep_applicable, moe_ep
from repro_torch.models.params import dense_init
from repro_torch.models.placed import PlacedTree, PlacedWeights

ATTN_TYPES = ("attn", "attn_local", "attn_global", "moe")
HYBRID_TYPES = ("hybrid_full", "hybrid_sw")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}

#: A leaf of a parameter spec. ``init``: None for the fan-in rule, a float
#: for the truncated normal's scale, ``("full", value)``, or ``"a_log"``
#: (Mamba's log(1 … N) per channel). ``dtype``:
#: None for the model's, else a dtype name the leaf keeps in a narrower
#: model (``a_log`` is fp32 in a bf16 model). ``dims``: the reference's
#: logical dim spec of the leaf (one tuple of alternatives per dim, see
#: :mod:`repro_torch.distributed.sharding`); a group's stacked layer dim
#: is not in it (:func:`param_dims` prefixes it).
Leaf = collections.namedtuple("Leaf", "shape init dtype dims",
                              defaults=(None, None, None))
TensorSpec = collections.namedtuple("TensorSpec", "shape dtype")
ONES, ZEROS = ("full", 1.0), ("full", 0.0)


def leaf_dtype(leaf: Leaf, model_dtype: torch.dtype) -> torch.dtype:
    if leaf.dtype is None:
        return model_dtype
    return torch.promote_types(DTYPES[leaf.dtype], model_dtype)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def tree_map(fn, tree, *others):
    """``fn`` over the leaves of nested dicts and tuples (a namedtuple, as
    :class:`TensorSpec`, is a leaf), and over the matching leaves of
    ``others``, trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if type(tree) is tuple:
        return tuple(tree_map(fn, v, *(o[i] for o in others))
                     for i, v in enumerate(tree))
    return fn(tree, *others)


def tree_leaves(tree, path: str = "") -> list:
    """``(path, leaf)`` pairs of nested dicts (keys sorted, as
    ``jax.tree.leaves`` orders them) and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves(tree[k], f"{path}/{k}")]
    if type(tree) is tuple:
        return [x for i, v in enumerate(tree)
                for x in tree_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def tree_map_with_keys(fn, tree, keys=()):
    """``fn(dict keys on the path, leaf)`` over nested dicts and tuples
    (a tuple's index is no key, as in the reference's key filter)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_keys(fn, v, keys + (k,))
                for k, v in tree.items()}
    if type(tree) is tuple:
        return tuple(tree_map_with_keys(fn, v, keys) for v in tree)
    return fn(list(keys), tree)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: ``p["attn"]["wq"]`` and
    ``"q_norm" in p`` read it as the layer functions read a dict."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, k):
        return getattr(self, k)

    def __contains__(self, k) -> bool:
        return k in self._parameters or k in self._modules


#: dim specs of the reference's parameters
_REP1, _REP2 = ((None,),), ((None,), (None,))
_IN_OUT, _OUT_IN = (("fsdp",), ("tp",)), (("tp",), ("fsdp",))
_HEADS = (("fsdp",), ("tp",), (None, "tp"))
_EXPERTS = (("expert",), ("fsdp",), (None,))


def _rmsnorm(d: int) -> dict:
    return {"scale": Leaf((d,), ONES, dims=_REP1)}


def _layernorm(d: int) -> dict:
    return {"scale": Leaf((d,), ONES, dims=_REP1),
            "bias": Leaf((d,), ZEROS, dims=_REP1)}


def _attn_spec(cfg: ModelConfig, cross: bool = False) -> dict:
    d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = {"wq": Leaf((d, h, hd), dims=_HEADS),
            "wk": Leaf((d, hk, hd), dims=_HEADS),
            "wv": Leaf((d, hk, hd), dims=_HEADS),
            "wo": Leaf((h, hd, d), 1.0 / math.sqrt(h * hd),
                       dims=(("tp",), (None, "tp"), ("fsdp",)))}
    if cfg.qk_norm and not cross:
        attn["q_norm"] = _rmsnorm(hd)
        attn["k_norm"] = _rmsnorm(hd)
    return attn


def _mlp_spec(d: int, d_ff: int, gated: bool = True) -> dict:
    p = {"w_up": Leaf((d, d_ff), dims=_IN_OUT),
         "w_down": Leaf((d_ff, d), dims=_OUT_IN)}
    if gated:
        p["w_gate"] = Leaf((d, d_ff), dims=_IN_OUT)
    return p


def _mlstm_spec(cfg: ModelConfig) -> dict:
    d, h, bs = cfg.d_model, cfg.num_heads, cfg.ssm_qkv_block
    di = d * cfg.ssm_expand
    blk = Leaf((di // bs, bs, bs), dims=(("tp",), (None,), (None,)))
    return {"w_up": Leaf((d, di), dims=_IN_OUT),
            "w_z": Leaf((d, di), dims=_IN_OUT),
            "conv": Leaf((cfg.ssm_conv, di), dims=((None,), ("tp",))),
            "wq": blk, "wk": blk, "wv": blk,
            "w_if": Leaf((di, 2 * h), 0.01, dims=(("tp",), (None,))),
            "f_bias": Leaf((h,), ("full", 3.0), dims=_REP1),
            "norm": Leaf((h, di // h), ONES, dims=_REP2),
            "w_down": Leaf((di, d), dims=_OUT_IN)}


def _slstm_spec(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    dh, dff = d // h, int(d * 4 / 3)
    return {"w_in": Leaf((d, 4 * d), dims=_IN_OUT),
            "r": Leaf((h, dh, 4 * dh), 0.1, dims=((None,),) * 3),
            "f_bias": Leaf((h, dh), ("full", 3.0), dims=_REP2),
            "norm": Leaf((h, dh), ONES, dims=_REP2),
            "ffn_gate": Leaf((d, dff), dims=_IN_OUT),
            "ffn_up": Leaf((d, dff), dims=_IN_OUT),
            "ffn_down": Leaf((dff, d), dims=_OUT_IN)}


def _mamba_spec(cfg: ModelConfig) -> dict:
    d, N = cfg.d_model, cfg.ssm_state
    di = d * cfg.ssm_expand
    return {"w_in": Leaf((d, 2 * di), dims=_IN_OUT),
            "conv": Leaf((cfg.ssm_conv, di), dims=((None,), ("tp",))),
            "w_bcdt": Leaf((di, 2 * N + 1), dims=(("tp",), (None,))),
            "dt_bias": Leaf((di,), ZEROS, dims=_REP1),
            "a_log": Leaf((di, N), "a_log", "float32", dims=_REP2),
            "d_skip": Leaf((di,), ONES, dims=_REP1),
            "w_out": Leaf((di, d), dims=_OUT_IN)}


def _layer_spec(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    if kind in ATTN_TYPES:
        p = {"ln1": _rmsnorm(d), "attn": _attn_spec(cfg), "ln2": _rmsnorm(d)}
        if kind == "moe":
            e, dff = cfg.expert_pad_to, cfg.d_ff
            p["moe"] = {"router": Leaf((d, e), dims=(("fsdp",), (None,))),
                        "w_gate": Leaf((e, d, dff), dims=_EXPERTS),
                        "w_up": Leaf((e, d, dff), dims=_EXPERTS),
                        "w_down": Leaf((e, dff, d), dims=(("expert",), (None,),
                                                          ("fsdp",)))}
        else:
            p["mlp"] = _mlp_spec(d, cfg.d_ff, gated=cfg.act != "gelu_plain")
        return p
    if kind == "mlstm":
        return {"ln": _rmsnorm(d), "mlstm": _mlstm_spec(cfg)}
    if kind == "slstm":
        return {"ln": _rmsnorm(d), "slstm": _slstm_spec(cfg)}
    if kind in HYBRID_TYPES:
        return {"ln1": _rmsnorm(d), "attn": _attn_spec(cfg),
                "mamba": _mamba_spec(cfg), "attn_norm": _rmsnorm(d),
                "mamba_norm": _rmsnorm(d),
                "mix": {"w": Leaf((2,), ("full", 0.5), dims=_REP1)},
                "ln2": _rmsnorm(d),
                "mlp": _mlp_spec(d, cfg.d_ff)}
    if kind == "enc_attn":
        return {"ln1": _layernorm(d), "attn": _attn_spec(cfg),
                "ln2": _layernorm(d), "mlp": _mlp_spec(d, cfg.d_ff, False)}
    if kind == "dec_attn":
        return {"ln1": _layernorm(d), "attn": _attn_spec(cfg),
                "ln_cross": _layernorm(d), "cross": _attn_spec(cfg, True),
                "ln2": _layernorm(d), "mlp": _mlp_spec(d, cfg.d_ff, False)}
    raise ValueError(kind)


def _group_kinds(cfg: ModelConfig) -> list:
    """(kind, count) per group, in order: whisper's encoder and decoder,
    else the config's layer groups."""
    if cfg.encoder_layers:
        return [("enc_attn", cfg.encoder_layers), ("dec_attn", cfg.num_layers)]
    return cfg.groups()


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree's leaves (:class:`Leaf`), groups as lists of
    per-layer trees."""
    d = cfg.d_model
    spec = {"embed": {"w": Leaf((cfg.vocab_size, d), 0.02, dims=_OUT_IN)},
            "final_norm": (_layernorm(d) if cfg.family == "encdec"
                           else _rmsnorm(d))}
    if not cfg.tie_embeddings:
        spec["head"] = {"w": Leaf((d, cfg.vocab_size), dims=_IN_OUT)}
    if cfg.family == "encdec":
        spec["dec_pos"] = {"w": Leaf((cfg.max_seq_len, d), 0.02,
                                     dims=((None,), ("fsdp",)))}
    spec["groups"] = {f"g{i}_{kind}": [_layer_spec(cfg, kind)] * count
                      for i, (kind, count) in enumerate(_group_kinds(cfg))}
    return spec


def param_dims(cfg: ModelConfig) -> dict:
    """The dim-spec tree of the reference's ``init_model``: every leaf's
    :attr:`Leaf.dims`, a group's as one tree for its stacked layers, with
    the unsharded layer dim first."""
    def walk(s, stacked: bool):
        if isinstance(s, Leaf):
            return (((None,),) if stacked else ()) + tuple(s.dims)
        return {k: walk(v, stacked) for k, v in s.items()}

    spec = param_specs(cfg)
    out = {k: walk(v, False) for k, v in spec.items() if k != "groups"}
    out["groups"] = {k: walk(layers[0], True)
                     for k, layers in spec["groups"].items()}
    return out


def spec_map(fn, spec, tree, path: str = ""):
    """``fn(leaf_spec, value, path)`` over ``tree`` walked with its spec
    (dicts of :class:`Leaf`, groups as lists of per-layer specs); raises
    where the tree's keys or layer counts are not the spec's."""
    if isinstance(spec, Leaf):
        return fn(spec, tree, path)
    if isinstance(spec, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(spec):
            raise ValueError(f"{path}: expected {len(spec)} layers")
        return [spec_map(fn, s, t, f"{path}[{i}]")
                for i, (s, t) in enumerate(zip(spec, tree))]
    if not isinstance(tree, dict) or set(tree) != set(spec):
        raise ValueError(f"{path}: expected keys {sorted(spec)}, got "
                         f"{sorted(tree) if isinstance(tree, dict) else tree}")
    return {k: spec_map(fn, spec[k], tree[k], f"{path}/{k}") for k in spec}


def _check_leaf(spec: Leaf, t, path: str, dtype: torch.dtype) -> None:
    want = leaf_dtype(spec, dtype)
    if not isinstance(t, torch.Tensor) or tuple(t.shape) != spec.shape \
            or t.dtype != want:
        got = (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else t
        raise ValueError(f"{path}: expected shape {spec.shape} of {want}, "
                         f"got {got}")


class DecoderLM(nn.Module):
    """An LM of any family over a parameter tree (the shapes and dtypes of
    :func:`param_specs`, checked); for ``encdec`` it also holds the
    encoder. :func:`init_model` draws one;
    ``convert.lm_params_from_arrays`` carries the reference's across."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        spec_map(functools.partial(_check_leaf, dtype=DTYPES[cfg.dtype]),
                 param_specs(cfg), tree)
        self.cfg = cfg
        self.embed = ParamTree(tree["embed"])
        self.final_norm = ParamTree(tree["final_norm"])
        if not cfg.tie_embeddings:
            self.head = ParamTree(tree["head"])
        if cfg.family == "encdec":
            self.dec_pos = ParamTree(tree["dec_pos"])
        self.groups = nn.ModuleDict({
            key: nn.ModuleList(ParamTree(t) for t in layers)
            for key, layers in tree["groups"].items()})
        #: None, or how the parameters are placed on a mesh (each then
        #: this rank's block of its leaf: :func:`place_model`)
        self.placement: Optional[PlacedWeights] = None

    def __getitem__(self, k):
        return getattr(self, k)

    def __contains__(self, k) -> bool:
        return k in self._modules

    def forward(self, batch: dict, **kw):
        return forward(self, batch, **kw)


def _materialize(spec, gen, dtype, device):
    if isinstance(spec, list):
        return [_materialize(s, gen, dtype, device) for s in spec]
    if not isinstance(spec, Leaf):
        return {k: _materialize(v, gen, dtype, device) for k, v in spec.items()}
    dt = leaf_dtype(spec, dtype)
    if spec.init == "a_log":
        di, N = spec.shape
        row = torch.log(torch.linspace(1.0, float(N), N, device=device))
        return row[None, :].repeat(di, 1).to(dt)
    if isinstance(spec.init, tuple) and spec.init[0] == "full":
        return torch.full(spec.shape, spec.init[1], dtype=dt, device=device)
    if spec.init is None or isinstance(spec.init, float):
        return dense_init(gen, spec.shape, dt, scale=spec.init, device=device)
    raise ValueError(f"unknown init {spec.init!r}")


def _walk_named(cfg: ModelConfig, fn):
    """``fn(name, leaf spec)`` over the parameter spec, ``name`` as
    ``named_parameters()`` names the parameter (``groups.g0_attn.3.attn.wq``),
    in the spec's tree."""
    def walk(s, prefix):
        if isinstance(s, Leaf):
            return fn(prefix, s)
        if isinstance(s, list):
            return [walk(t, f"{prefix}.{i}") for i, t in enumerate(s)]
        return {k: walk(v, f"{prefix}.{k}" if prefix else k)
                for k, v in s.items()}

    return walk(param_specs(cfg), "")


def named_param_dims(cfg: ModelConfig) -> dict:
    """``{parameter name: its leaf's dim spec}`` (a group layer's without
    the stacked layer dim)."""
    out = {}
    _walk_named(cfg, lambda name, s: out.__setitem__(name, tuple(s.dims)))
    return out


def model_from_named(cfg: ModelConfig, named: dict) -> DecoderLM:
    """A :class:`DecoderLM` over ``{parameter name: tensor}`` (whole
    leaves, used as they are)."""
    return DecoderLM(cfg, _walk_named(cfg, lambda name, s: named[name]))


def place_model(model: DecoderLM, rules: MeshRules) -> DecoderLM:
    """Cut every parameter of a whole ``model`` to this rank's block of its
    leaf on ``rules``' mesh (in place; the parameters stay the same
    objects) and record the placement. A collective on the mesh's first
    use: every rank places its model in the same order."""
    if model.placement is not None:
        raise ValueError("the model is placed already")
    if not on_mesh(rules):
        raise ValueError("place_model needs MeshRules on a DeviceMesh")
    dims = named_param_dims(model.cfg)
    specs = {}
    for name, p in model.named_parameters():
        specs[name] = rules.spec(tuple(p.shape), dims[name])
        p.data = rules.local(p.data, dims[name]).clone()
    dp = rules.data_axes
    data = (rules.shards(dp) if math.prod(rules.shape[a] for a in dp) > 1
            else None)
    mdl = rules.shards(("model",)) if rules.shape.get("model", 1) > 1 \
        else None
    model.placement = PlacedWeights(rules, specs, data, mdl)
    return model


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> DecoderLM:
    """A random model with the reference's distribution, drawn from a
    ``torch.Generator`` seeded ``seed`` on ``device`` (``"cuda"`` unless
    named)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tree = _materialize(param_specs(cfg), gen, DTYPES[cfg.dtype], dev)
    return DecoderLM(cfg, tree)


def abstract_model(cfg: ModelConfig) -> DecoderLM:
    """A :class:`DecoderLM` whose every leaf is an empty meta tensor of
    its spec's shape and dtype: the counterpart of the reference's
    ``jax.eval_shape`` of ``init_model``. Nothing is allocated or drawn
    (a ``torch.Generator`` has no meta device, so :func:`init_model`
    cannot build one)."""
    dtype = DTYPES[cfg.dtype]
    return DecoderLM(cfg, _walk_named(cfg, lambda name, s: torch.empty(
        s.shape, dtype=leaf_dtype(s, dtype), device="meta")))


# ---------------------------------------------------------------------------
# per-layer application
# ---------------------------------------------------------------------------


def _attn_kind_args(cfg: ModelConfig, kind: str):
    if kind in ("attn_local", "hybrid_sw"):
        return dict(mask_kind="sliding", window=cfg.sliding_window,
                    theta=cfg.rope_theta)
    if kind == "attn_global":
        return dict(mask_kind="causal",
                    theta=cfg.rope_theta_global or cfg.rope_theta)
    if kind == "enc_attn":
        return dict(mask_kind="bidir", theta=cfg.rope_theta)
    return dict(mask_kind="causal", theta=cfg.rope_theta)


def apply_layer(p, cfg: ModelConfig, kind: str, x, *, mode: str,
                pos_offset: int, cache: Optional[dict],
                cache_len: Optional[int], cross_x=None, rules=None,
                place=None, layout=None, name: str = ""):
    """One layer of the given kind. Returns (x, new_cache); in prefill and
    decode the new cache is ``cache``'s tensors, written in place.

    On a mesh: ``rules``, the forward's :class:`Placement` and the
    layer's ``layout`` (per cache leaf, the dim split over the model axis,
    or None). A placed model's layer (``place.weights``) reads its
    parameters through a :class:`PlacedTree` made here (``name``: the
    layer's parameter prefix), so remat gathers them again."""
    eps = cfg.norm_eps
    norm = L.layer_norm if cfg.family == "encdec" else L.rms_norm
    if place is not None and place.weights is not None:
        p = place.weights.view(p, name)
    new_cache: dict = {}
    if kind in ATTN_TYPES or kind in ("enc_attn", "dec_attn"):
        h, c_attn = L.attention(
            p["attn"], cfg, norm(p["ln1"], x, eps), mode=mode,
            pos_offset=pos_offset, cache=cache["attn"] if cache else None,
            cache_len=cache_len, rules=rules, kv_dim=_kv_dim(layout, "attn"),
            tp=_tp(p, "attn", "wq"), **_attn_kind_args(cfg, kind))
        x = x + h
        if c_attn is not None:
            new_cache["attn"] = c_attn
        if kind == "dec_attn":
            h, c_cross = L.attention(
                p["cross"], cfg, norm(p["ln_cross"], x, eps), mode=mode,
                pos_offset=pos_offset, cache=cache["cross"] if cache else None,
                cross_x=cross_x, mask_kind="cross", rules=rules,
                kv_dim=_kv_dim(layout, "cross"), tp=_tp(p, "cross", "wq"))
            x = x + h
            if c_cross is not None:
                new_cache["cross"] = c_cross
        h2in = norm(p["ln2"], x, eps)
        if kind == "moe":
            if place is not None and ep_applicable(cfg, rules, place.batch,
                                                   h2in.shape[1]):
                h2 = moe_ep(p["moe"], cfg, h2in, cfg.act, rules)
            else:
                h2 = L.moe(p["moe"], cfg, h2in, cfg.act,
                           data=place.data if place is not None else None)
        else:
            h2 = L.mlp(p["mlp"], h2in,
                       "gelu" if cfg.family == "encdec" else cfg.act,
                       tp=_tp(p, "mlp", "w_up"))
        return x + h2, new_cache
    if kind == "mlstm":
        h, c = _whole_states(functools.partial(
            S.mlstm_block, p["mlstm"], cfg, L.rms_norm(p["ln"], x, eps),
            mode=mode), cache, layout, rules, mode)
        return x + h, c
    if kind == "slstm":
        h, c = _whole_states(functools.partial(
            S.slstm_block, p["slstm"], cfg, L.rms_norm(p["ln"], x, eps),
            mode=mode), cache, layout, rules, mode)
        return x + h, c
    if kind in HYBRID_TYPES:
        xin = L.rms_norm(p["ln1"], x, eps)
        ha, c_attn = L.attention(
            p["attn"], cfg, xin, mode=mode, pos_offset=pos_offset,
            cache=cache["attn"] if cache else None, cache_len=cache_len,
            rules=rules, kv_dim=_kv_dim(layout, "attn"),
            tp=_tp(p, "attn", "wq"), **_attn_kind_args(cfg, kind))
        hm, c_ssm = _whole_states(
            functools.partial(S.mamba_block, p["mamba"], cfg, xin, mode=mode),
            {"ssm": cache["ssm"], "conv": cache["conv"]} if cache else None,
            {"ssm": layout["ssm"], "conv": layout["conv"]} if layout
            else None, rules, mode)
        ha = L.rms_norm(p["attn_norm"], ha, eps)
        hm = L.rms_norm(p["mamba_norm"], hm, eps)
        w = p["mix"]["w"].to(ha.dtype)
        x = x + w[0] * ha + w[1] * hm
        x = x + L.mlp(p["mlp"], L.rms_norm(p["ln2"], x, eps), cfg.act,
                      tp=_tp(p, "mlp", "w_up"))
        if c_attn is not None:
            c_ssm["attn"] = c_attn
        return x, c_ssm
    raise ValueError(kind)


def _tp(p, block: str, leaf: str):
    """The model axis's shards when ``p[block]`` runs tensor-parallel
    (a placed layer whose ``leaf`` is split over the model axis along its
    dim 1: attention's q heads, the MLP's d_ff), else None."""
    if not isinstance(p, PlacedTree):
        return None
    return p.plan.model if p[block].model_dim(leaf) == 1 else None


def _kv_dim(layout, name: str):
    return layout[name]["k"] if layout and name in layout else None


def _whole_states(block, cache, layout, rules, mode: str):
    """``block(cache=cache)``, where ``layout`` may split some of the
    cache's leaves (recurrent states, conv buffers) over the model axis:
    those leaves are whole for the step — decode gathers their blocks in
    shard order, prefill starts from zeros as on one device — and the
    rank's block of the result is written back. Exact: the step runs as
    it does on one device."""
    if cache is None or layout is None or \
            all(d is None for _, d in tree_leaves(layout)):
        return block(cache=cache)
    sh = rules.shards(("model",))

    def whole(t, d):
        if d is None:
            return t
        if mode == "decode":
            return gather_cat(sh, t, d)
        shape = list(t.shape)
        shape[d] *= sh.p
        return t.new_zeros(shape)

    full = tree_map(whole, cache, layout)
    h, _ = block(cache=full)

    def keep(t, f, d):
        if d is not None:
            t.copy_(f.narrow(d, sh.index * t.shape[d], t.shape[d]))

    tree_map(keep, cache, full, layout)
    return h, cache


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------


def _layer_cache_spec(cfg: ModelConfig, kind: str, B: int, cache_len: int,
                      dtype) -> dict:
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    di = cfg.d_model * cfg.ssm_expand
    H = cfg.num_heads
    wide = S.state_dtype(dtype)

    def kv(slen):
        return {"k": TensorSpec((B, slen, hk, hd), dtype),
                "v": TensorSpec((B, slen, hk, hd), dtype)}

    conv = TensorSpec((B, cfg.ssm_conv - 1, di), dtype)
    if kind in ("attn", "attn_global", "moe"):
        return {"attn": kv(cache_len)}
    if kind == "attn_local":
        return {"attn": kv(min(cache_len, cfg.sliding_window))}
    if kind == "dec_attn":
        return {"attn": kv(cache_len), "cross": kv(cfg.frontend_len)}
    if kind == "mlstm":
        dh = di // H
        return {"ssm": (TensorSpec((B, H, dh, dh), wide),
                        TensorSpec((B, H, dh), wide),
                        TensorSpec((B, H), wide)),
                "conv": conv}
    if kind == "slstm":
        st = TensorSpec((B, H, cfg.d_model // H), wide)
        return {"ssm": (st, st, st, st)}
    if kind in HYBRID_TYPES:
        sw = (min(cache_len, cfg.sliding_window)
              if kind == "hybrid_sw" else cache_len)
        return {"attn": kv(sw),
                "ssm": TensorSpec((B, di, cfg.ssm_state), wide), "conv": conv}
    raise ValueError(kind)


def cache_specs(cfg: ModelConfig, B: int, cache_len: int,
                rules=None) -> dict:
    """:class:`TensorSpec` tree of the decode cache (stacked per group;
    the encoder's group holds none, whisper's ``enc_out`` is unstacked).
    With ``rules`` (:class:`MeshRules`), each leaf's shape is one rank's
    block under ``train.step.cache_dims_tree``'s placement."""
    dtype = DTYPES[cfg.dtype]
    out = {}
    if cfg.encoder_layers:
        out["enc_out"] = TensorSpec((B, cfg.frontend_len, cfg.d_model), dtype)
    for i, (kind, count) in enumerate(_group_kinds(cfg)):
        if kind != "enc_attn":
            out[f"g{i}_{kind}"] = tree_map(
                lambda s, count=count: TensorSpec((count,) + s.shape, s.dtype),
                _layer_cache_spec(cfg, kind, B, cache_len, dtype))
    if isinstance(rules, MeshRules):
        from repro_torch.train.step import cache_dims_tree

        out = tree_map(lambda s, d: TensorSpec(rules.local_shape(s.shape, d),
                                               s.dtype),
                       out, cache_dims_tree(cfg, out, rules))
    return out


class MeshCaches(dict):
    """A decode cache on a mesh: this rank's blocks of the tree of
    :func:`cache_specs` (``rules=``), with the whole batch and the buffer
    length their placement was computed from, which decode reads."""

    def __init__(self, tree: dict, batch: int, cache_len: int):
        super().__init__(tree)
        self.batch, self.cache_len = batch, cache_len


def zero_caches(cfg: ModelConfig, B: int, cache_len: int, device=None,
                rules=None) -> dict:
    """Zeroed caches for B requests; on a mesh (``rules``), this rank's
    blocks only, as a :class:`MeshCaches`."""
    dev = resolve_device(device)
    tree = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    cache_specs(cfg, B, cache_len, rules))
    return MeshCaches(tree, B, cache_len) if on_mesh(rules) else tree


# ---------------------------------------------------------------------------
# placement on a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """One forward on the mesh, as this rank sees it: the whole batch, the
    data axes' shards when its rows are split over them (else None), and
    per cache group the layer's layout (:func:`_layouts`)."""

    batch: int
    data: object
    layouts: dict
    weights: Optional[PlacedWeights] = None


def row_shards(rules, B: int):
    """The data axes' shards when B rows split over them, else None (a
    batch that does not divide runs whole on every data rank, as the
    reference's flash-decoding path replicates it)."""
    dp = rules.data_axes
    n = math.prod(rules.shape[a] for a in dp)
    return rules.shards(dp) if n > 1 and B % n == 0 else None


_ROWS = (("batch",),)


@functools.lru_cache(maxsize=32)
def _layouts(cfg: ModelConfig, B: int, cache_len: int, rules) -> dict:
    """Per cache group, a tree like one layer's cache whose leaves give
    the dim (of the layer's tensor) that the placement splits over the
    model axis, or None."""
    from repro_torch.train.step import cache_dims_tree

    specs = cache_specs(cfg, B, cache_len)
    dims = cache_dims_tree(cfg, specs, rules)
    nm = rules.shape.get("model", 1)

    def model_dim(s, d):
        if nm > 1:
            for i, phys in enumerate(rules.spec(s.shape, d)[1:]):
                if phys == "model" or (isinstance(phys, tuple)
                                       and "model" in phys):
                    return i
        return None

    return {k: tree_map(model_dim, specs[k], dims[k])
            for k in specs if k != "enc_out"}


def _placed(cfg: ModelConfig, batch: dict, mode: str, caches,
            cache_len: Optional[int], rules, weights=None):
    """(this rank's batch, :class:`Placement`, the whole buffer length)."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    if mode == "decode" or (mode == "prefill" and caches is not None):
        if not isinstance(caches, MeshCaches):
            raise ValueError("on a mesh, decode (and a prefill handed its "
                             "caches) needs the MeshCaches that prefill or "
                             "zero_caches(rules=...) made")
        if caches.batch != B:
            raise ValueError(f"the caches were placed for a batch of "
                             f"{caches.batch}, the batch has {B} rows")
        cache_len = caches.cache_len
    elif mode == "prefill" and cache_len is None:
        front = batch.get("frontend")
        cache_len = tokens.shape[1] + (front.shape[1] if cfg.family == "vlm"
                                       and front is not None else 0)
    data = row_shards(rules, B)
    if data is not None:
        batch = {k: local_rows(rules, v) for k, v in batch.items()}
    layouts = _layouts(cfg, B, cache_len, rules) if mode != "train" else {}
    return batch, Placement(B, data, layouts, weights), cache_len


def local_rows(rules, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole-batch tensor (split over the data
    axes)."""
    return rules.local(x, _ROWS + ((None,),) * (x.dim() - 1))


def _check_placed(model: DecoderLM, batch: dict, mode: str, rules):
    """A placed model trains on its own mesh, its rows split over the
    data axes; returns its placement."""
    plan = model.placement
    if mode != "train":
        raise ValueError("a placed model (each parameter one block of its "
                         "leaf) runs train mode only; gather the whole model "
                         "(train.step.gather_train_state) to serve it")
    if not on_mesh(rules) or rules.shape != plan.rules.shape or \
            rules.mesh is not plan.rules.mesh:
        raise ValueError("a placed model runs on the mesh it was placed on: "
                         "pass its rules")
    B = batch["tokens"].shape[0]
    n = math.prod(rules.shape[a] for a in rules.data_axes)
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split over the "
                         f"{n} data ranks")
    return plan


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------


def _embed(w, cfg: ModelConfig, tokens):
    e = F.embedding(tokens, w)
    if cfg.family in ("dense",) and cfg.name.startswith("gemma"):
        e = e * math.sqrt(cfg.d_model)
    return e


def _head(W, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        logits = x @ W["embed"]["w"].T
    else:
        logits = x @ W["head"]["w"]
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _sinusoidal(S_len: int, d: int, device) -> torch.Tensor:
    """(S_len, d) fp32 sin | cos table, rounded to fp32 where the
    reference's fp32 table rounds: the exponent 2i/d, the frequency
    10000^(2i/d) and the angle. The power and the sine are taken in
    float64 and rounded once, so every device reads the same table (fp32
    powers and sines differ by an ulp between math libraries, and an ulp
    of the frequency moves a 1 500 rad angle by 1e-4)."""
    pos = torch.arange(S_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    freq = (10000.0 ** (2 * dim / d).double()).float()
    ang = (pos / freq).double()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


def _layer_fn(remat: bool):
    """``apply_layer``, or ``apply_layer`` under a non-reentrant
    checkpoint (``remat``: the layer's activations are recomputed in the
    backward pass)."""
    if not remat:
        return apply_layer
    return functools.partial(torch.utils.checkpoint.checkpoint, apply_layer,
                             use_reentrant=False)


def _encode(model: DecoderLM, cfg: ModelConfig, frontend,
            layer_fn=apply_layer, rules=None, place=None):
    """Whisper's encoder over (B, frontend_len, d) frames: the sinusoid
    added in the frames' dtype, then the layers in the model's."""
    x = frontend + _sinusoidal(frontend.shape[1], cfg.d_model,
                               frontend.device).to(frontend.dtype)[None]
    x = x.to(model.embed["w"].dtype)
    for i, layer in enumerate(model.groups["g0_enc_attn"]):
        x, _ = layer_fn(layer, cfg, "enc_attn", x, mode="train",
                        pos_offset=0, cache=None, cache_len=None, rules=rules,
                        place=place, name=f"groups.g0_enc_attn.{i}")
    return x


def forward(model: DecoderLM, batch: dict, *, mode: str = "train",
            caches: Optional[dict] = None, pos_offset: int = 0,
            cache_len: Optional[int] = None, remat: bool = False,
            rules=None):
    """Returns (logits, caches | None).

    ``batch``: ``tokens`` (B, S) int and ``frontend`` (B, frontend_len,
    d_model) — for ``vlm`` a patch-embedding prefix outside decode
    (logits over the text positions only), for ``encdec`` the encoder's
    frames, needed outside decode (decode reads the encoder's output from
    ``caches["enc_out"]``). ``prefill`` fills ``caches`` if given, else
    allocates them (``cache_len``: the buffer length, the whole input's
    if None); ``decode`` updates ``caches`` in place and returns the same
    tree. ``remat`` checkpoints each layer in train mode (the other modes
    ignore it); the values are the same either way.

    ``rules`` (:class:`MeshRules` on a ``DeviceMesh``): every rank passes
    the whole batch and gets its own rows' logits (the rows split over the
    data axes when they divide them); ``caches`` are this rank's blocks, a
    :class:`MeshCaches`. With ``rules`` None (or ``NoRules``) nothing
    changes.
    """
    cfg = model.cfg
    layer_fn = _layer_fn(remat and mode == "train")
    place = None
    plan = (None if model.placement is None
            else _check_placed(model, batch, mode, rules))
    if on_mesh(rules):
        batch, place, cache_len = _placed(cfg, batch, mode, caches,
                                          cache_len, rules, plan)
    else:
        rules = None
    # the top-level leaves, gathered once (the tied embedding's two uses
    # share one gather)
    W = model if plan is None else plan.view(model, "")
    tokens = batch["tokens"]
    frontend = batch.get("frontend")
    if mode == "decode" and caches is None:
        raise ValueError("decode needs caches (from prefill or zero_caches)")
    cross_x = None
    if cfg.family == "encdec":
        if mode == "decode":
            cross_x = caches["enc_out"]
        elif frontend is None:
            raise ValueError(f"{cfg.name}: the encoder needs "
                             f"batch['frontend'] outside decode")
        else:
            cross_x = _encode(model, cfg, frontend, layer_fn, rules, place)

    x = _embed(W["embed"]["w"], cfg, tokens)
    if cfg.family == "encdec":
        if mode == "decode":
            if not 0 <= pos_offset < cfg.max_seq_len:
                raise IndexError(f"decode position {pos_offset} is past "
                                 f"dec_pos's {cfg.max_seq_len} rows")
            x = x + model.dec_pos["w"][pos_offset:pos_offset + 1][None]
        else:
            x = x + W["dec_pos"]["w"][None, :x.shape[1]]
    prefix = cfg.family == "vlm" and frontend is not None and mode != "decode"
    if prefix:
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
    if mode == "prefill":
        if caches is None and place is not None:
            caches = zero_caches(cfg, place.batch, cache_len,
                                 device=x.device, rules=rules)
        elif caches is None:
            caches = zero_caches(cfg, x.shape[0], x.shape[1] if cache_len
                                 is None else cache_len, device=x.device)
        if cross_x is not None:
            caches["enc_out"].copy_(cross_x)

    for key, group in model.groups.items():
        kind = key.split("_", 1)[1]
        if kind == "enc_attn":
            continue
        gcache = caches[key] if mode != "train" else None
        layout = place.layouts.get(key) if place is not None else None
        for i, layer in enumerate(group):
            lc = (tree_map(lambda t, i=i: t[i], gcache)
                  if gcache is not None else None)
            x, _ = layer_fn(layer, cfg, kind, x, mode=mode,
                            pos_offset=pos_offset, cache=lc,
                            cache_len=cache_len, cross_x=cross_x,
                            rules=rules, place=place, layout=layout,
                            name=f"groups.{key}.{i}")

    norm = L.layer_norm if cfg.family == "encdec" else L.rms_norm
    x = norm(W["final_norm"], x, cfg.norm_eps)
    if prefix:
        x = x[:, frontend.shape[1]:]
    logits = _head(W, cfg, x)
    return logits, (caches if mode in ("prefill", "decode") else None)


def lm_loss(logits, labels, mask=None):
    """Mean token cross-entropy in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return -torch.mean(ll)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
