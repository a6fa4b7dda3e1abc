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
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

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
              cross_x: Optional[torch.Tensor] = None):
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
    """
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
        kv_len = k.shape[1]
        kv_pos = (torch.arange(kv_len, dtype=torch.int32, device=dev)
                  if is_cross else q_pos)
        if S >= _BLOCK_Q_THRESHOLD and S % _BLOCK_Q == 0:
            out = _sdpa_blocked(q, k, v, kv_pos, mask_kind, window, g)
        else:
            bias = _mask_bias(mode, mask_kind, S, kv_len, q_pos, kv_pos,
                              None, window)
            out = _sdpa(q, k, v, bias, g)
        if mode == "prefill":
            cache = _prefill_cache(k, v, cache,
                                   None if is_cross else cache_len,
                                   mask_kind, window)
        else:
            cache = None
    elif mode == "decode" and is_cross:
        bias = torch.zeros((S, k.shape[1]), dtype=torch.float32, device=dev)
        out = _sdpa(q, k, v, bias, g)
    elif mode == "decode":
        kc, vc = cache["k"], cache["v"]
        buf = kc.shape[1]
        sliding = mask_kind == "sliding"
        slot = pos_offset % buf if sliding else pos_offset
        if not 0 <= slot < buf:
            raise IndexError(f"decode position {pos_offset} is past the "
                             f"cache's {buf} slots")
        kc[:, slot:slot + 1].copy_(k)
        vc[:, slot:slot + 1].copy_(v)
        idx = torch.arange(buf, dtype=torch.int32, device=dev)
        if sliding:   # slot ages: written within the last `window` positions
            ok = torch.remainder(slot - idx, buf) < min(pos_offset + 1, buf)
        else:
            ok = idx <= pos_offset
        bias = _bias(ok)[None, None, :].expand(B, S, buf)
        out = _sdpa(q, kc, vc, bias, g)
    else:
        raise ValueError(mode)

    y = out.reshape(B, S, h * hd) @ p["wo"].reshape(h * hd, -1)
    return y, cache


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


def mlp(p, x, act: str):
    up = x @ p["w_up"]
    if "w_gate" in p:
        h = _act(act)(x @ p["w_gate"]) * up
    else:
        h = _act(act)(up)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based grouped GEMM, capacity drop policy)
# ---------------------------------------------------------------------------


def moe(p, cfg, x, act: str, capacity_factor: float | None = None):
    """x: (B, S, D) → (B, S, D). Tokens routed to their top-K experts,
    sorted (stably) by expert into an (E, C, D) buffer; assignments past
    an expert's capacity C = ⌈T·K/E·capacity⌉ (T: this call's tokens) are
    dropped; padded experts never win. Each token's K contributions are
    summed over K in one fixed order (not scattered with atomics), so the
    result is the same on every run."""
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

    C = max(int(math.ceil(T * K / E * capacity_factor)), 1)
    # rank of each assignment within its expert group (se is sorted)
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    rank = torch.arange(T * K, device=dev) - starts[se]
    keep = rank < C
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
