"""Transformer building blocks: norms, RoPE, GQA attention, MLP, MoE.

Pure functions over param mappings (``p["wq"]``, ``"q_norm" in p``): a
:class:`repro_torch.models.model.ParamTree` or a plain dict of tensors.
Weights keep the reference's layouts (``wq`` is ``(d, H, hd)``, ``wo``
``(H, hd, d)``, expert stacks ``(E, d, d_ff)``) and every op keeps its
numerics: fp32 scores and softmax with the probabilities cast back before
the PV product, the ``NEG_INF`` additive mask, RoPE on the two halves with
fp32 angles, tanh GELU, a stable expert sort with capacity drops.

Caches are written in place: prefill fills the buffers it is handed (the
model allocates them once), decode writes the new K/V row at its slot —
the counterpart of the reference's ``dynamic_update_slice``, whose buffer
XLA reuses. Decode positions are host integers, so no step reads the
device back.

On a mesh (``rules``, and ``kv_dim``: the dim of the layer's K/V cache
that is split over the model axis) each rank holds one block of the
cache. Prefill computes the whole K/V and keeps its block. Decode either
runs the flash-decoding path (the buffer split along the sequence,
:func:`_decode_attn_seqshard`: local scores with a running max, one
all-gather, and the rescaled sums folded in shard order) or, with the
heads split, attends with its own heads and gathers the heads' outputs.
Every combine is exact or added in one fixed order, so every rank holds
the same bits.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.distributed import gather_cat, gather_shards
from repro_torch.distributed.parallel import copy_in, sum_out

NEG_INF = -2.0e38

_BLOCK_Q_THRESHOLD = 8192   # above this, score matrices stream in q-blocks
_BLOCK_Q = 1024


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layer_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,). Rotates the two halves
    (not interleaved pairs); angles in fp32, the result cast to x's dtype."""
    half = x.shape[-1] // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs            # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _mask_bias(mode: str, mask_kind: str, q_len: int, kv_len: int,
               q_pos: torch.Tensor, kv_pos: torch.Tensor,
               kv_valid: Optional[torch.Tensor], window: Optional[int]):
    """(q_len, kv_len) additive fp32 bias (or (B, q, kv) if kv_valid is
    batched)."""
    qp = q_pos[:, None]
    kp = kv_pos[None, :]
    if mask_kind == "causal":
        ok = kp <= qp
    elif mask_kind == "sliding":
        ok = (kp <= qp) & (kp > qp - window)
    elif mask_kind in ("bidir", "cross"):
        ok = torch.ones((q_len, kv_len), dtype=torch.bool, device=q_pos.device)
    else:
        raise ValueError(mask_kind)
    bias = _bias(ok)
    if kv_valid is not None:
        bias = bias[None] + _bias(kv_valid)[:, None, :]
    return bias


def _bias(ok: torch.Tensor) -> torch.Tensor:
    """0 where ``ok``, ``NEG_INF`` elsewhere, in fp32."""
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill_(~ok, NEG_INF)


def _repeat_kv(k: torch.Tensor, g: int) -> torch.Tensor:
    """``jnp.repeat(k, g, axis=2)``: kv head j serves q heads j·g … j·g+g−1
    (``repeat_interleave`` order, built from a view so it never syncs)."""
    if g == 1:
        return k
    B, S, Hk, D = k.shape
    return k[:, :, :, None, :].expand(B, S, Hk, g, D).reshape(B, S, Hk * g, D)


def _sdpa(q, k, v, bias, g: int):
    """q: (B,Q,H,D); k,v: (B,K,Hk,D), repeated to H heads (GQA). Scores in
    fp32 (a half q·k product is exact in fp32, so widening the operands is
    the reference's ``preferred_element_type``), the fp32 softmax cast to
    q's dtype before the PV product."""
    hd = q.shape[-1]
    k = _repeat_kv(k, g)
    v = _repeat_kv(v, g)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    if bias.dim() == 2:
        scores = scores + bias[None, None]
    else:
        scores = scores + bias[:, None]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _sdpa_blocked(q, k, v, kv_pos, mask_kind, window, g: int):
    """Query-blocked attention: scores never exceed (B, H, block, K) — full
    softmax rows per block of ``_BLOCK_Q`` queries, as the reference's
    ``lax.map`` over blocks."""
    S = q.shape[1]
    outs = []
    for lo in range(0, S, _BLOCK_Q):
        qp = torch.arange(lo, lo + _BLOCK_Q, dtype=torch.int32, device=q.device)
        bias = _mask_bias("train", mask_kind, _BLOCK_Q, k.shape[1], qp,
                          kv_pos, None, window)
        outs.append(_sdpa(q[:, lo:lo + _BLOCK_Q], k, v, bias, g))
    return torch.cat(outs, dim=1)


def _proj_heads(x, w):
    """``einsum("bsd,dhk->bshk")`` as one matmul."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).view(*x.shape[:-1], h, hd)


def attention(p, cfg, x, *, mask_kind: str = "causal",
              window: Optional[int] = None, theta: Optional[float] = None,
              mode: str = "train", pos_offset: int = 0,
              cache: Optional[dict] = None, cache_len: Optional[int] = None,
              cross_x: Optional[torch.Tensor] = None, rules=None,
              kv_dim: Optional[int] = None, tp=None):
    """Self- or cross-attention. Returns (y, cache | None).

    ``prefill`` writes position p of the prompt at slot ``p % buf`` of
    ``cache`` (``{"k", "v"}``, each (B, buf, Hk, hd)) and zeroes the rest;
    without a cache it allocates one of ``cache_len`` (the prompt's length
    if None; at most the window for a sliding layer). ``decode`` takes
    one token at host position ``pos_offset``, writes its K/V row in place
    at its slot (``pos % buf`` on a sliding layer) and attends to the
    slots written within the window.

    With ``cross_x`` (B, F, d), the encoder's output, K/V come from it:
    ``prefill`` fills an F-slot cache, ``decode`` reads that cache
    unchanged, and neither RoPE nor the k-norm applies.

    ``kv_dim`` (with ``rules`` on a mesh): ``cache`` is this rank's block
    of the whole cache, split over the model axis along dim 1 (the
    buffer: decode runs :func:`_decode_attn_seqshard`) or 2 (the kv heads:
    :func:`_decode_attn_heads`). ``train.step.cache_dims_tree`` makes that
    choice.

    ``tp`` (train mode, ``p`` a placed layer's
    :class:`~repro_torch.models.placed.PlacedTree`): the model axis's
    shards when the heads are split over it — :func:`_attention_tp`.
    """
    if tp is not None and mode == "train":
        return _attention_tp(p, cfg, x, tp, mask_kind=mask_kind,
                             window=window, theta=theta,
                             cross_x=cross_x), None
    B, S, _ = x.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hk
    theta = cfg.rope_theta if theta is None else theta
    is_cross = cross_x is not None
    if mode == "decode" and cache is None:
        raise ValueError("decode needs the layer's cache")

    q = _proj_heads(x, p["wq"])
    if is_cross and mode == "decode":
        k, v = cache["k"], cache["v"]
    else:
        src = cross_x if is_cross else x
        k = _proj_heads(src, p["wk"])
        v = _proj_heads(src, p["wv"])
    if "q_norm" in p:            # per head, before RoPE
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        if not is_cross:
            k = rms_norm(p["k_norm"], k, cfg.norm_eps)

    dev = x.device
    if mode == "decode":
        q_pos = torch.full((S,), pos_offset, dtype=torch.int32, device=dev)
    else:
        q_pos = torch.arange(S, dtype=torch.int32, device=dev)
    if not is_cross:
        q = rope(q, q_pos, theta)
        k = rope(k, q_pos, theta)

    if mode in ("train", "prefill"):
        out = _attend_full(q, k, v, q_pos, mode, mask_kind, window, g,
                           is_cross)
        if mode == "prefill" and kv_dim is not None:
            _prefill_block(k, v, cache, mask_kind, window,
                           rules.shards(("model",)), kv_dim)
        elif mode == "prefill":
            cache = _prefill_cache(k, v, cache,
                                   None if is_cross else cache_len,
                                   mask_kind, window)
        else:
            cache = None
    elif mode == "decode" and kv_dim is not None:
        sh = rules.shards(("model",))
        kind = "cross" if is_cross else mask_kind
        k_new, v_new = (None, None) if is_cross else (k, v)
        if kv_dim == 1:
            out = _decode_attn_seqshard(q, k_new, v_new, cache, pos_offset,
                                        kind, window, rules, g)
        else:
            out = _decode_attn_heads(q, k_new, v_new, cache, pos_offset,
                                     kind, sh, g)
    elif mode == "decode" and is_cross:
        bias = torch.zeros((S, k.shape[1]), dtype=torch.float32, device=dev)
        out = _sdpa(q, k, v, bias, g)
    elif mode == "decode":
        out = _decode_self(q, k, v, cache, pos_offset, mask_kind, g)
    else:
        raise ValueError(mode)

    y = out.reshape(B, S, h * hd) @ p["wo"].reshape(h * hd, -1)
    return y, cache


def _attend_full(q, k, v, q_pos, mode: str, mask_kind: str, window,
                 g: int, is_cross: bool):
    """Every query against the whole K/V (train and prefill)."""
    S, kv_len = q.shape[1], k.shape[1]
    kv_pos = (torch.arange(kv_len, dtype=torch.int32, device=q.device)
              if is_cross else q_pos)
    if S >= _BLOCK_Q_THRESHOLD and S % _BLOCK_Q == 0:
        return _sdpa_blocked(q, k, v, kv_pos, mask_kind, window, g)
    bias = _mask_bias(mode, mask_kind, S, kv_len, q_pos, kv_pos, None,
                      window)
    return _sdpa(q, k, v, bias, g)


def _attention_tp(p, cfg, x, sh, *, mask_kind: str, window, theta,
                  cross_x):
    """Train-mode attention with the heads split over the model axis
    (Megatron's column- and row-split products): this rank projects its
    block of the q heads (``wq``'s model block) and the kv heads they read
    — ``wk``/``wv``'s model block when the kv heads split too, else those
    heads of the leaf gathered whole —, attends with them, and multiplies
    by its rows of ``wo``; the ranks' partial outputs are added over the
    model group in shard order. The input (and ``cross_x``) enters through
    :func:`copy_in`, so its gradient adds the ranks' parts; leaves read
    whole inside the region (the kv projections when they do not split,
    the q/k norms) add their gradients over the model axis."""
    B, S, _ = x.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hk
    h_loc = h // sh.p
    lo = sh.index * h_loc
    klo, khi = lo // g, (lo + h_loc - 1) // g + 1
    pp = p.partitioned()
    is_cross = cross_x is not None
    xi = copy_in(sh, x)
    src = copy_in(sh, cross_x) if is_cross else xi
    q = _proj_heads(xi, p.block("wq"))
    if p.model_dim("wk") == 1:       # the kv heads split as the q heads do
        wk, wv = p.block("wk"), p.block("wv")
    else:
        wk, wv = pp["wk"][:, klo:khi], pp["wv"][:, klo:khi]
    k, v = _proj_heads(src, wk), _proj_heads(src, wv)
    if "q_norm" in p:
        q = rms_norm(pp["q_norm"], q, cfg.norm_eps)
        if not is_cross:
            k = rms_norm(pp["k_norm"], k, cfg.norm_eps)
    q_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    if not is_cross:
        theta = cfg.rope_theta if theta is None else theta
        q = rope(q, q_pos, theta)
        k = rope(k, q_pos, theta)
    # each local q head's kv head (``_repeat_kv``'s grouping)
    idx = (torch.arange(lo, lo + h_loc, device=x.device) // g) - klo
    k, v = k[:, :, idx], v[:, :, idx]
    out = _attend_full(q, k, v, q_pos, "train",
                       "cross" if is_cross else mask_kind, window, 1,
                       is_cross)
    y = out.reshape(B, S, h_loc * hd) @ p.block("wo").reshape(h_loc * hd, -1)
    return sum_out(sh, y)


def _decode_self(q, k, v, cache, pos_offset: int, mask_kind: str, g: int):
    """One decode step of self-attention against a whole cache: the new
    K/V row at its slot (``pos % buf`` on a sliding layer), then the slots
    written within the window."""
    B, S = q.shape[:2]
    kc, vc = cache["k"], cache["v"]
    buf = kc.shape[1]
    sliding = mask_kind == "sliding"
    slot = pos_offset % buf if sliding else pos_offset
    if not 0 <= slot < buf:
        raise IndexError(f"decode position {pos_offset} is past the "
                         f"cache's {buf} slots")
    kc[:, slot:slot + 1].copy_(k)
    vc[:, slot:slot + 1].copy_(v)
    idx = torch.arange(buf, dtype=torch.int32, device=q.device)
    if sliding:   # slot ages: written within the last `window` positions
        ok = torch.remainder(slot - idx, buf) < min(pos_offset + 1, buf)
    else:
        ok = idx <= pos_offset
    bias = _bias(ok)[None, None, :].expand(B, S, buf)
    return _sdpa(q, kc, vc, bias, g)


# ---------------------------------------------------------------------------
# attention on a mesh: the cache split over the model axis
# ---------------------------------------------------------------------------


def _prefill_block(k, v, cache, mask_kind, window, sh, dim: int) -> None:
    """Prefill's cache on a mesh: the whole ring (:func:`_prefill_cache`)
    in a scratch buffer, then this rank's block of it along ``dim``."""
    size = cache["k"].shape[dim]
    shape = list(cache["k"].shape)
    shape[dim] = size * sh.p
    whole = _prefill_cache(k, v, {"k": k.new_empty(shape),
                                  "v": v.new_empty(shape)},
                           None, mask_kind, window)
    for name in ("k", "v"):
        cache[name].copy_(whole[name].narrow(dim, sh.index * size, size))


def _decode_attn_heads(q, k_new, v_new, cache, pos: int, mask_kind: str,
                       sh, g: int):
    """One decode step with the cache split over its kv heads: this rank
    writes and attends with its own kv heads and their q heads
    (``_repeat_kv``'s grouping), then the heads' outputs are gathered in
    shard order — exact, O(B·H·D) per layer."""
    hk_loc = cache["k"].shape[2]
    lo = sh.index * hk_loc
    q_loc = q[:, :, lo * g:(lo + hk_loc) * g]
    if mask_kind == "cross":
        bias = torch.zeros((q.shape[1], cache["k"].shape[1]),
                           dtype=torch.float32, device=q.device)
        out = _sdpa(q_loc, cache["k"], cache["v"], bias, g)
    else:
        out = _decode_self(q_loc, k_new[:, :, lo:lo + hk_loc],
                           v_new[:, :, lo:lo + hk_loc], cache, pos,
                           mask_kind, g)
    return gather_cat(sh, out, 2)


def _decode_attn_seqshard(q, k_new, v_new, cache, pos: int, mask_kind: str,
                          window, rules, g: int):
    """One decode step with a sequence-split cache (flash-decoding), the
    placement of kv heads that do not divide the model axis (gemma3's
    one): splitting the buffer makes the combine an O(B·H·D) exchange per
    layer, where splitting head_dim would exchange the (B, H, buf) scores.

    The rank that owns the new token's slot (``pos % buf`` on a sliding
    ring, ``pos`` otherwise; host integers, so no sync) writes its K/V
    row. Each rank scores its block of slots with a running max ``m``,
    its sum ``denom`` and its PV product ``o``; one all-gather brings every
    rank's (m, denom, o), and each rank takes the max M, rescales each
    part by exp(m − M) and adds the parts in shard order — so every rank
    holds the same bits. Per layer: O(B·H·D) floats on the wire.
    ``mask_kind`` "cross" reads an encoder cache: no write, every slot.

    q: (B,1,H,D); k_new/v_new: (B,1,Hk,D) or None; cache k/v: this rank's
    (B, buf/nm, Hk, D). Returns out (B,1,H,D).
    """
    sh = rules.shards(("model",))
    kl, vl = cache["k"], cache["v"]
    B, S_loc, Hk, D = kl.shape
    buf = S_loc * sh.p
    lo = sh.index * S_loc
    slot = pos % buf if mask_kind == "sliding" else pos
    if mask_kind != "cross":
        if not 0 <= slot < buf:
            raise IndexError(f"decode position {pos} is past the cache's "
                             f"{buf} slots")
        if lo <= slot < lo + S_loc:
            kl[:, slot - lo:slot - lo + 1].copy_(k_new)
            vl[:, slot - lo:slot - lo + 1].copy_(v_new)

    kr, vr = _repeat_kv(kl, g), _repeat_kv(vl, g)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float())
    scores = scores / math.sqrt(D)
    idx = lo + torch.arange(S_loc, dtype=torch.int32, device=q.device)
    if mask_kind == "sliding":
        ok = torch.remainder(slot - idx, buf) < min(pos + 1, buf)
    elif mask_kind == "cross":
        ok = torch.ones(S_loc, dtype=torch.bool, device=q.device)
    else:
        ok = idx <= pos
    scores = scores.masked_fill(~ok, NEG_INF)
    m = torch.clamp(torch.amax(scores, dim=-1), min=-1e30)       # (B,H,1)
    p = torch.exp(scores - m[..., None])
    denom = torch.sum(p, dim=-1)                                 # (B,H,1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(vr.dtype), vr)      # (B,1,H,D)

    H = q.shape[2]
    n = B * H
    parts = gather_shards(sh, torch.cat([m.reshape(n), denom.reshape(n),
                                         o.float().reshape(-1)]))
    ms = parts[:, :n].reshape(sh.p, B, H, 1)
    M = torch.amax(ms, dim=0)                                    # exact
    o_g = d_g = None
    for r in range(sh.p):
        scale = torch.exp(ms[r] - M)                             # (B,H,1)
        o_r = parts[r, 2 * n:].reshape(o.shape).to(o.dtype)
        o_r = o_r * scale.transpose(1, 2)[..., None].to(o.dtype)
        d_r = parts[r, n:2 * n].reshape(B, H, 1) * scale
        o_g = o_r if o_g is None else o_g + o_r
        d_g = d_r if d_g is None else d_g + d_r
    out = o_g / torch.clamp(d_g, min=1e-30).transpose(1, 2)[..., None] \
        .to(o_g.dtype)
    return out.to(q.dtype)


def _prefill_cache(k, v, cache, cache_len, mask_kind, window):
    """Position p of the prompt at slot p % buf (``jnp.roll`` by
    ``kv_len % buf`` when the prompt fills the buffer), rest zero."""
    B, kv_len, hk, hd = k.shape
    if cache is None:
        buf = kv_len if cache_len is None else cache_len
        if mask_kind == "sliding" and window is not None:
            buf = min(buf, window)
        cache = {"k": k.new_empty((B, buf, hk, hd)),
                 "v": v.new_empty((B, buf, hk, hd))}
    buf = cache["k"].shape[1]
    take = min(kv_len, buf)
    for name, t in (("k", k), ("v", v)):
        last = t[:, kv_len - take:]
        if take == buf and kv_len % buf != 0:
            last = torch.roll(last, kv_len % buf, dims=1)
        cache[name][:, :take].copy_(last)
        cache[name][:, take:].zero_()
    return cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    return {"silu": F.silu,
            "gelu": functools.partial(F.gelu, approximate="tanh"),
            "relu": F.relu}[name]


def mlp(p, x, act: str, tp=None):
    """``tp`` (train mode, ``p`` a placed layer's tree): the model axis's
    shards when ``d_ff`` is split over it — ``w_up``/``w_gate`` are
    column-split (this rank's ``d_ff`` block), ``w_down`` row-split, the
    partial outputs added over the model group in shard order."""
    if tp is not None:
        x = copy_in(tp, x)
        up = x @ p.block("w_up")
        gate = x @ p.block("w_gate") if "w_gate" in p else None
        down = p.block("w_down")
    else:
        up = x @ p["w_up"]
        gate = x @ p["w_gate"] if "w_gate" in p else None
        down = p["w_down"]
    h = _act(act)(up) if gate is None else _act(act)(gate) * up
    y = h @ down
    return y if tp is None else sum_out(tp, y)


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based grouped GEMM, capacity drop policy)
# ---------------------------------------------------------------------------


def moe(p, cfg, x, act: str, capacity_factor: float | None = None,
        data=None):
    """x: (B, S, D) → (B, S, D). Tokens routed to their top-K experts,
    sorted (stably) by expert into an (E, C, D) buffer; assignments past
    an expert's capacity C = ⌈T·K/E·capacity⌉ (T: this call's tokens) are
    dropped; padded experts never win. Each token's K contributions are
    summed over K in one fixed order (not scattered with atomics), so the
    result is the same on every run.

    ``data``: the data axes' shards when ``x`` is this rank's block of
    rows of a batch split over them. Capacity is then the whole batch's,
    and an assignment's rank in its expert's queue counts the assignments
    of the shards before this one (one all-gather of the (E,) counts), so
    exactly the reference's global drops happen."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity
    B, S, D = x.shape
    E = cfg.expert_pad_to
    E_real = cfg.num_experts
    K = cfg.experts_per_tok
    T = B * S
    dev = x.device
    xt = x.reshape(T, D)

    logits = xt.float() @ p["router"].float()                  # (T, E) fp32
    if E_real < E:  # padded experts never routed
        pad = torch.arange(E, device=dev) >= E_real
        logits = logits.masked_fill(pad[None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: ties to the lower index — a stable descending sort
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :K], top_i[:, :K]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    flat_e = top_i.reshape(-1)                                  # (T·K,)
    flat_t = torch.arange(T, device=dev)[:, None].expand(T, K).reshape(-1)
    flat_w = top_w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]

    T_all = T if data is None else T * data.p
    C = max(int(math.ceil(T_all * K / E * capacity_factor)), 1)
    # rank of each assignment within its expert group (se is sorted)
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    rank = torch.arange(T * K, device=dev) - starts[se]
    keep = rank < C
    if data is not None:
        ends = torch.searchsorted(se, torch.arange(E, device=dev), right=True)
        before = gather_shards(data, ends - starts)[:data.index].sum(dim=0)
        keep = rank + before[se] < C
    slot = torch.where(keep, se * C + torch.clamp(rank, 0, C - 1), E * C)

    buf = xt.new_zeros((E * C + 1, D))
    buf[slot] = xt[st]                       # drops all land on row E·C
    buf = buf[:-1].view(E, C, D)

    h = _act(act)(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out = torch.bmm(h, p["w_down"]).view(E * C, D)

    contrib = torch.where(keep[:, None], out[torch.clamp(slot, 0, E * C - 1)],
                          0.0)
    contrib = contrib * sw[:, None].to(out.dtype)
    per_k = torch.empty_like(contrib)
    per_k[order] = contrib                   # back to (token, k) order
    return per_k.view(T, K, D).sum(dim=1).view(B, S, D)
