"""Model assembly: embedding → layer groups → head, for the decoder families.

The port of the JAX package's ``models/model.py`` for the ``dense``,
``moe`` and ``vlm`` families. Layer heterogeneity (gemma3's 5:1
local:global) is kept as the reference's *grouping*: consecutive layers of
one kind form a group ``g{i}_{kind}``, here one ``nn.ModuleList`` of
per-layer parameter trees (the reference stacks them for ``lax.scan``).

Modes:
  * ``train``   — full-sequence forward, no caches.
  * ``prefill`` — full-sequence forward; allocates the decode cache once
    (:func:`zero_caches`) and fills it.
  * ``decode``  — one token at a host position against the caches, which
    it updates in place (ring buffers for sliding windows).

The cache is the reference's tree: a dict keyed like :func:`cache_specs`
with stacked ``(count, B, buf, Hk, hd)`` K and V per group, so the two can
be compared leaf by leaf.
"""
from __future__ import annotations

import collections
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.multiset import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import dense_init

ATTN_TYPES = ("attn", "attn_local", "attn_global", "moe")
#: Families whose serving path is ported; the others are later slices.
PORTED_FAMILIES = ("dense", "moe", "vlm")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}

#: A leaf of a parameter or cache spec. ``init``: "ones", or the
#: truncated normal's scale (None: the fan-in rule).
Leaf = collections.namedtuple("Leaf", "shape init", defaults=(None,))
TensorSpec = collections.namedtuple("TensorSpec", "shape dtype")


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to torch "
            f"yet (ROADMAP A.9.1: serving of the encdec, ssm and hybrid "
            f"families); ported: {PORTED_FAMILIES}")


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


def _layer_spec(cfg: ModelConfig, kind: str) -> dict:
    if kind not in ATTN_TYPES:
        raise ValueError(kind)
    d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ones = {"scale": Leaf((d,), "ones")}
    attn = {"wq": Leaf((d, h, hd)), "wk": Leaf((d, hk, hd)),
            "wv": Leaf((d, hk, hd)),
            "wo": Leaf((h, hd, d), 1.0 / math.sqrt(h * hd))}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": Leaf((hd,), "ones")}
        attn["k_norm"] = {"scale": Leaf((hd,), "ones")}
    p = {"ln1": ones, "attn": attn, "ln2": dict(ones)}
    if kind == "moe":
        e, dff = cfg.expert_pad_to, cfg.d_ff
        p["moe"] = {"router": Leaf((d, e)), "w_gate": Leaf((e, d, dff)),
                    "w_up": Leaf((e, d, dff)), "w_down": Leaf((e, dff, d))}
    else:
        p["mlp"] = {"w_up": Leaf((d, cfg.d_ff)), "w_down": Leaf((cfg.d_ff, d))}
        if cfg.act != "gelu_plain":
            p["mlp"]["w_gate"] = Leaf((d, cfg.d_ff))
    return p


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree's leaves (:class:`Leaf`), groups as lists of
    per-layer trees."""
    require_ported(cfg)
    spec = {"embed": {"w": Leaf((cfg.vocab_size, cfg.d_model), 0.02)},
            "final_norm": {"scale": Leaf((cfg.d_model,), "ones")}}
    if not cfg.tie_embeddings:
        spec["head"] = {"w": Leaf((cfg.d_model, cfg.vocab_size))}
    spec["groups"] = {f"g{i}_{kind}": [_layer_spec(cfg, kind)] * count
                      for i, (kind, count) in enumerate(cfg.groups())}
    return spec


def _check(spec, tree, path="") -> None:
    if isinstance(spec, Leaf):
        if not isinstance(tree, torch.Tensor) or tuple(tree.shape) != spec.shape:
            got = tuple(tree.shape) if isinstance(tree, torch.Tensor) else tree
            raise ValueError(f"{path}: expected shape {spec.shape}, got {got}")
        return
    if isinstance(spec, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(spec):
            raise ValueError(f"{path}: expected {len(spec)} layers")
        for i, (s, t) in enumerate(zip(spec, tree)):
            _check(s, t, f"{path}[{i}]")
        return
    if not isinstance(tree, dict) or set(tree) != set(spec):
        raise ValueError(f"{path}: expected keys {sorted(spec)}, got "
                         f"{sorted(tree) if isinstance(tree, dict) else tree}")
    for k in spec:
        _check(spec[k], tree[k], f"{path}/{k}")


class DecoderLM(nn.Module):
    """A decoder-only LM of a ported family over a parameter tree (the
    shapes of :func:`param_specs`, checked). :func:`init_model` draws one;
    ``convert.lm_params_from_arrays`` carries the reference's across."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        _check(param_specs(cfg), tree)
        self.cfg = cfg
        self.embed = ParamTree(tree["embed"])
        self.final_norm = ParamTree(tree["final_norm"])
        if not cfg.tie_embeddings:
            self.head = ParamTree(tree["head"])
        self.groups = nn.ModuleDict({
            key: nn.ModuleList(ParamTree(t) for t in layers)
            for key, layers in tree["groups"].items()})

    def forward(self, batch: dict, **kw):
        return forward(self, batch, **kw)


def _materialize(spec, gen, dtype, device):
    if isinstance(spec, Leaf):
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        return dense_init(gen, spec.shape, dtype, scale=spec.init,
                          device=device)
    if isinstance(spec, list):
        return [_materialize(s, gen, dtype, device) for s in spec]
    return {k: _materialize(v, gen, dtype, device) for k, v in spec.items()}


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> DecoderLM:
    """A random model with the reference's distribution, drawn from a
    ``torch.Generator`` seeded ``seed`` on ``device`` (``"cuda"`` unless
    named)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tree = _materialize(param_specs(cfg), gen, DTYPES[cfg.dtype], dev)
    return DecoderLM(cfg, tree)


# ---------------------------------------------------------------------------
# per-layer application
# ---------------------------------------------------------------------------


def _attn_kind_args(cfg: ModelConfig, kind: str):
    if kind == "attn_local":
        return dict(mask_kind="sliding", window=cfg.sliding_window,
                    theta=cfg.rope_theta)
    if kind == "attn_global":
        return dict(mask_kind="causal",
                    theta=cfg.rope_theta_global or cfg.rope_theta)
    return dict(mask_kind="causal", theta=cfg.rope_theta)


def apply_layer(p, cfg: ModelConfig, kind: str, x, *, mode: str,
                pos_offset: int, cache: Optional[dict],
                cache_len: Optional[int]):
    """One layer of the given kind. Returns (x, new_cache)."""
    if kind not in ATTN_TYPES:
        raise NotImplementedError(f"layer kind {kind!r} is not ported "
                                  f"(ROADMAP A.9.1)")
    h, c_attn = L.attention(
        p["attn"], cfg, L.rms_norm(p["ln1"], x, cfg.norm_eps), mode=mode,
        pos_offset=pos_offset, cache=cache.get("attn") if cache else None,
        cache_len=cache_len, **_attn_kind_args(cfg, kind))
    x = x + h
    h2in = L.rms_norm(p["ln2"], x, cfg.norm_eps)
    if kind == "moe":
        h2 = L.moe(p["moe"], cfg, h2in, cfg.act)
    else:
        h2 = L.mlp(p["mlp"], h2in, cfg.act)
    return x + h2, ({"attn": c_attn} if c_attn is not None else {})


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------


def _layer_cache_spec(cfg: ModelConfig, kind: str, B: int, cache_len: int,
                      dtype) -> dict:
    hk, hd = cfg.num_kv_heads, cfg.head_dim

    def kv(slen):
        return {"k": TensorSpec((B, slen, hk, hd), dtype),
                "v": TensorSpec((B, slen, hk, hd), dtype)}

    if kind in ("attn", "attn_global", "moe"):
        return {"attn": kv(cache_len)}
    if kind == "attn_local":
        return {"attn": kv(min(cache_len, cfg.sliding_window))}
    raise ValueError(kind)


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cache_specs(cfg: ModelConfig, B: int, cache_len: int) -> dict:
    """:class:`TensorSpec` tree of the decode cache (stacked per group)."""
    require_ported(cfg)
    dtype = DTYPES[cfg.dtype]
    return {f"g{i}_{kind}": tree_map(
                lambda s, count=count: TensorSpec((count,) + s.shape, s.dtype),
                _layer_cache_spec(cfg, kind, B, cache_len, dtype))
            for i, (kind, count) in enumerate(cfg.groups())}


def zero_caches(cfg: ModelConfig, B: int, cache_len: int, device=None) -> dict:
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                     cache_specs(cfg, B, cache_len))


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------


def _embed(model: DecoderLM, cfg: ModelConfig, tokens):
    e = F.embedding(tokens, model.embed["w"])
    if cfg.family in ("dense",) and cfg.name.startswith("gemma"):
        e = e * math.sqrt(cfg.d_model)
    return e


def _head(model: DecoderLM, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        logits = x @ model.embed["w"].T
    else:
        logits = x @ model.head["w"]
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def forward(model: DecoderLM, batch: dict, *, mode: str = "train",
            caches: Optional[dict] = None, pos_offset: int = 0,
            cache_len: Optional[int] = None):
    """Returns (logits, caches | None).

    ``batch``: ``tokens`` (B, S) int and, for ``vlm``, ``frontend``
    (B, frontend_len, d_model), a patch-embedding prefix outside decode
    (logits over the text positions only). ``prefill`` fills ``caches``
    if given, else allocates them (``cache_len``: the buffer length, the
    whole input's if None); ``decode`` updates ``caches`` in place and
    returns the same tree.
    """
    cfg = model.cfg
    tokens = batch["tokens"]
    frontend = batch.get("frontend")
    x = _embed(model, cfg, tokens)
    prefix = cfg.family == "vlm" and frontend is not None and mode != "decode"
    if prefix:
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
    if mode == "prefill" and caches is None:
        caches = zero_caches(cfg, x.shape[0], x.shape[1] if cache_len is None
                             else cache_len, device=x.device)
    elif mode == "decode" and caches is None:
        raise ValueError("decode needs caches (from prefill or zero_caches)")

    for key, group in model.groups.items():
        kind = key.split("_", 1)[1]
        gcache = caches[key] if mode != "train" else None
        for i, layer in enumerate(group):
            lc = (tree_map(lambda t, i=i: t[i], gcache)
                  if gcache is not None else None)
            x, _ = apply_layer(layer, cfg, kind, x, mode=mode,
                               pos_offset=pos_offset, cache=lc,
                               cache_len=cache_len)

    x = L.rms_norm(model.final_norm, x, cfg.norm_eps)
    if prefix:
        x = x[:, frontend.shape[1]:]
    logits = _head(model, cfg, x)
    return logits, (caches if mode in ("prefill", "decode") else None)


def lm_loss(logits, labels, mask=None):
    """Mean token cross-entropy in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return -torch.mean(ll)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
