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
  * ``train``   — full-sequence forward, no caches.
  * ``prefill`` — full-sequence forward; allocates the decode cache once
    (:func:`zero_caches`) and fills it.
  * ``decode``  — one token at a host position against the caches, which
    it updates in place (ring buffers for sliding windows, O(1) recurrent
    states for the SSM blocks, the encoder's output read unchanged).

The cache is the reference's tree: a dict keyed like :func:`cache_specs`
with stacked ``(count, B, …)`` leaves per group — K and V, and the
recurrent states as the reference's tuples — plus whisper's ``enc_out``,
so the two can be compared leaf by leaf.
"""
from __future__ import annotations

import collections
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.multiset import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import dense_init

ATTN_TYPES = ("attn", "attn_local", "attn_global", "moe")
HYBRID_TYPES = ("hybrid_full", "hybrid_sw")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}

#: A leaf of a parameter spec. ``init``: None for the fan-in rule, a float
#: for the truncated normal's scale, ``("full", value)``, or ``"a_log"``
#: (Mamba's log(1 … N) per channel). ``dtype``:
#: None for the model's, else a dtype name the leaf keeps in a narrower
#: model (``a_log`` is fp32 in a bf16 model).
Leaf = collections.namedtuple("Leaf", "shape init dtype",
                              defaults=(None, None))
TensorSpec = collections.namedtuple("TensorSpec", "shape dtype")
ONES, ZEROS = ("full", 1.0), ("full", 0.0)


def leaf_dtype(leaf: Leaf, model_dtype: torch.dtype) -> torch.dtype:
    if leaf.dtype is None:
        return model_dtype
    return torch.promote_types(DTYPES[leaf.dtype], model_dtype)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts and tuples (a namedtuple, as
    :class:`TensorSpec`, is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if type(tree) is tuple:
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


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


def _rmsnorm(d: int) -> dict:
    return {"scale": Leaf((d,), ONES)}


def _layernorm(d: int) -> dict:
    return {"scale": Leaf((d,), ONES), "bias": Leaf((d,), ZEROS)}


def _attn_spec(cfg: ModelConfig, cross: bool = False) -> dict:
    d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = {"wq": Leaf((d, h, hd)), "wk": Leaf((d, hk, hd)),
            "wv": Leaf((d, hk, hd)),
            "wo": Leaf((h, hd, d), 1.0 / math.sqrt(h * hd))}
    if cfg.qk_norm and not cross:
        attn["q_norm"] = _rmsnorm(hd)
        attn["k_norm"] = _rmsnorm(hd)
    return attn


def _mlp_spec(d: int, d_ff: int, gated: bool = True) -> dict:
    p = {"w_up": Leaf((d, d_ff)), "w_down": Leaf((d_ff, d))}
    if gated:
        p["w_gate"] = Leaf((d, d_ff))
    return p


def _mlstm_spec(cfg: ModelConfig) -> dict:
    d, h, bs = cfg.d_model, cfg.num_heads, cfg.ssm_qkv_block
    di = d * cfg.ssm_expand
    blk = Leaf((di // bs, bs, bs))
    return {"w_up": Leaf((d, di)), "w_z": Leaf((d, di)),
            "conv": Leaf((cfg.ssm_conv, di)), "wq": blk, "wk": blk,
            "wv": blk, "w_if": Leaf((di, 2 * h), 0.01),
            "f_bias": Leaf((h,), ("full", 3.0)),
            "norm": Leaf((h, di // h), ONES), "w_down": Leaf((di, d))}


def _slstm_spec(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    dh, dff = d // h, int(d * 4 / 3)
    return {"w_in": Leaf((d, 4 * d)), "r": Leaf((h, dh, 4 * dh), 0.1),
            "f_bias": Leaf((h, dh), ("full", 3.0)),
            "norm": Leaf((h, dh), ONES), "ffn_gate": Leaf((d, dff)),
            "ffn_up": Leaf((d, dff)), "ffn_down": Leaf((dff, d))}


def _mamba_spec(cfg: ModelConfig) -> dict:
    d, N = cfg.d_model, cfg.ssm_state
    di = d * cfg.ssm_expand
    return {"w_in": Leaf((d, 2 * di)), "conv": Leaf((cfg.ssm_conv, di)),
            "w_bcdt": Leaf((di, 2 * N + 1)), "dt_bias": Leaf((di,), ZEROS),
            "a_log": Leaf((di, N), "a_log", "float32"),
            "d_skip": Leaf((di,), ONES), "w_out": Leaf((di, d))}


def _layer_spec(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    if kind in ATTN_TYPES:
        p = {"ln1": _rmsnorm(d), "attn": _attn_spec(cfg), "ln2": _rmsnorm(d)}
        if kind == "moe":
            e, dff = cfg.expert_pad_to, cfg.d_ff
            p["moe"] = {"router": Leaf((d, e)), "w_gate": Leaf((e, d, dff)),
                        "w_up": Leaf((e, d, dff)), "w_down": Leaf((e, dff, d))}
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
                "mix": {"w": Leaf((2,), ("full", 0.5))}, "ln2": _rmsnorm(d),
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
    spec = {"embed": {"w": Leaf((cfg.vocab_size, d), 0.02)},
            "final_norm": (_layernorm(d) if cfg.family == "encdec"
                           else _rmsnorm(d))}
    if not cfg.tie_embeddings:
        spec["head"] = {"w": Leaf((d, cfg.vocab_size))}
    if cfg.family == "encdec":
        spec["dec_pos"] = {"w": Leaf((cfg.max_seq_len, d), 0.02)}
    spec["groups"] = {f"g{i}_{kind}": [_layer_spec(cfg, kind)] * count
                      for i, (kind, count) in enumerate(_group_kinds(cfg))}
    return spec


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
                cache_len: Optional[int], cross_x=None):
    """One layer of the given kind. Returns (x, new_cache); in prefill and
    decode the new cache is ``cache``'s tensors, written in place."""
    eps = cfg.norm_eps
    norm = L.layer_norm if cfg.family == "encdec" else L.rms_norm
    new_cache: dict = {}
    if kind in ATTN_TYPES or kind in ("enc_attn", "dec_attn"):
        h, c_attn = L.attention(
            p["attn"], cfg, norm(p["ln1"], x, eps), mode=mode,
            pos_offset=pos_offset, cache=cache["attn"] if cache else None,
            cache_len=cache_len, **_attn_kind_args(cfg, kind))
        x = x + h
        if c_attn is not None:
            new_cache["attn"] = c_attn
        if kind == "dec_attn":
            h, c_cross = L.attention(
                p["cross"], cfg, norm(p["ln_cross"], x, eps), mode=mode,
                pos_offset=pos_offset, cache=cache["cross"] if cache else None,
                cross_x=cross_x, mask_kind="cross")
            x = x + h
            if c_cross is not None:
                new_cache["cross"] = c_cross
        h2in = norm(p["ln2"], x, eps)
        if kind == "moe":
            h2 = L.moe(p["moe"], cfg, h2in, cfg.act)
        else:
            h2 = L.mlp(p["mlp"], h2in,
                       "gelu" if cfg.family == "encdec" else cfg.act)
        return x + h2, new_cache
    if kind == "mlstm":
        h, c = S.mlstm_block(p["mlstm"], cfg, L.rms_norm(p["ln"], x, eps),
                             mode=mode, cache=cache)
        return x + h, c
    if kind == "slstm":
        h, c = S.slstm_block(p["slstm"], cfg, L.rms_norm(p["ln"], x, eps),
                             mode=mode, cache=cache)
        return x + h, c
    if kind in HYBRID_TYPES:
        xin = L.rms_norm(p["ln1"], x, eps)
        ha, c_attn = L.attention(
            p["attn"], cfg, xin, mode=mode, pos_offset=pos_offset,
            cache=cache["attn"] if cache else None, cache_len=cache_len,
            **_attn_kind_args(cfg, kind))
        hm, c_ssm = S.mamba_block(
            p["mamba"], cfg, xin, mode=mode,
            cache={"ssm": cache["ssm"], "conv": cache["conv"]} if cache
            else None)
        ha = L.rms_norm(p["attn_norm"], ha, eps)
        hm = L.rms_norm(p["mamba_norm"], hm, eps)
        w = p["mix"]["w"].to(ha.dtype)
        x = x + w[0] * ha + w[1] * hm
        x = x + L.mlp(p["mlp"], L.rms_norm(p["ln2"], x, eps), cfg.act)
        if c_attn is not None:
            c_ssm["attn"] = c_attn
        return x, c_ssm
    raise ValueError(kind)


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


def cache_specs(cfg: ModelConfig, B: int, cache_len: int) -> dict:
    """:class:`TensorSpec` tree of the decode cache (stacked per group;
    the encoder's group holds none, whisper's ``enc_out`` is unstacked)."""
    dtype = DTYPES[cfg.dtype]
    out = {}
    if cfg.encoder_layers:
        out["enc_out"] = TensorSpec((B, cfg.frontend_len, cfg.d_model), dtype)
    for i, (kind, count) in enumerate(_group_kinds(cfg)):
        if kind != "enc_attn":
            out[f"g{i}_{kind}"] = tree_map(
                lambda s, count=count: TensorSpec((count,) + s.shape, s.dtype),
                _layer_cache_spec(cfg, kind, B, cache_len, dtype))
    return out


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


def _encode(model: DecoderLM, cfg: ModelConfig, frontend):
    """Whisper's encoder over (B, frontend_len, d) frames: the sinusoid
    added in the frames' dtype, then the layers in the model's."""
    x = frontend + _sinusoidal(frontend.shape[1], cfg.d_model,
                               frontend.device).to(frontend.dtype)[None]
    x = x.to(model.embed["w"].dtype)
    for layer in model.groups["g0_enc_attn"]:
        x, _ = apply_layer(layer, cfg, "enc_attn", x, mode="train",
                           pos_offset=0, cache=None, cache_len=None)
    return x


def forward(model: DecoderLM, batch: dict, *, mode: str = "train",
            caches: Optional[dict] = None, pos_offset: int = 0,
            cache_len: Optional[int] = None):
    """Returns (logits, caches | None).

    ``batch``: ``tokens`` (B, S) int and ``frontend`` (B, frontend_len,
    d_model) — for ``vlm`` a patch-embedding prefix outside decode
    (logits over the text positions only), for ``encdec`` the encoder's
    frames, needed outside decode (decode reads the encoder's output from
    ``caches["enc_out"]``). ``prefill`` fills ``caches`` if given, else
    allocates them (``cache_len``: the buffer length, the whole input's
    if None); ``decode`` updates ``caches`` in place and returns the same
    tree.
    """
    cfg = model.cfg
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
            cross_x = _encode(model, cfg, frontend)

    x = _embed(model, cfg, tokens)
    if cfg.family == "encdec":
        if mode == "decode":
            if not 0 <= pos_offset < cfg.max_seq_len:
                raise IndexError(f"decode position {pos_offset} is past "
                                 f"dec_pos's {cfg.max_seq_len} rows")
            x = x + model.dec_pos["w"][pos_offset:pos_offset + 1][None]
        else:
            x = x + model.dec_pos["w"][None, :x.shape[1]]
    prefix = cfg.family == "vlm" and frontend is not None and mode != "decode"
    if prefix:
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
    if mode == "prefill":
        if caches is None:
            caches = zero_caches(cfg, x.shape[0], x.shape[1] if cache_len
                                 is None else cache_len, device=x.device)
        if cross_x is not None:
            caches["enc_out"].copy_(cross_x)

    for key, group in model.groups.items():
        kind = key.split("_", 1)[1]
        if kind == "enc_attn":
            continue
        gcache = caches[key] if mode != "train" else None
        for i, layer in enumerate(group):
            lc = (tree_map(lambda t, i=i: t[i], gcache)
                  if gcache is not None else None)
            x, _ = apply_layer(layer, cfg, kind, x, mode=mode,
                               pos_offset=pos_offset, cache=lc,
                               cache_len=cache_len, cross_x=cross_x)

    norm = L.layer_norm if cfg.family == "encdec" else L.rms_norm
    x = norm(model.final_norm, x, cfg.norm_eps)
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
