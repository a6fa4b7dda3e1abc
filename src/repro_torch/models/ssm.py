"""Recurrent blocks: xLSTM (mLSTM + sLSTM) and the Mamba-style selective SSM.

The port of the JAX package's ``models/ssm.py``, function for function and
op for op:

* mLSTM in its chunkwise-parallel stabilised form (chunks of 64; the
  sequence padded to a multiple of it with zero gates, as the reference
  pads, so a prompt that is not a multiple hands decode the reference's
  running max ``m``). The chunk-end state update is a scale followed by
  one batched product over the chunk: no (B, Q, H, Dh, Dh) tensor.
* sLSTM as a Python loop over the sequence (its recurrence is nonlinear
  in h: no parallel form, as in the paper, arXiv:2405.04517).
* Mamba's diagonal scan in chunks of 128 (padded with a = 1, b = 0),
  each chunk scanned by the odd/even recursion of
  ``lax.associative_scan``, so the products compose in the reference's
  order (log2(128) levels of strided elementwise ops).

Numerics follow the reference's dtypes: where ``jnp.einsum`` promotes a
half operand against an fp32 one, or asks for ``preferred_element_type``,
both operands are widened first (a half product is exact in fp32); the
products the reference keeps in the model dtype (the gates through
``log_sigmoid``, the chunk's ``cumsum``, Mamba's ``b``, the conv's taps
added left to right) stay in it. Recurrent states are fp32
(``state_dtype``: float64 in a float64 model).

Each block takes ``mode`` and ``cache`` and returns ``(y, cache)``.
``train`` returns the final state as fresh tensors; ``prefill`` and
``decode`` write it into the cache tensors they are handed (``_store``), so
every cache leaf keeps its storage across steps.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _act

#: The reference's chunk lengths. They are part of the numerics: the
#: mLSTM's zero-gate padding to a multiple of ``MLSTM_CHUNK`` moves the
#: stabiliser ``m`` that decode reads.
MLSTM_CHUNK = 64
MAMBA_CHUNK = 128
LOG_EPS = -2.0e38


def state_dtype(dtype: torch.dtype) -> torch.dtype:
    """The recurrent states' dtype: fp32, or the model's if wider."""
    return torch.promote_types(torch.float32, dtype)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches
    to x above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_sigmoid(x):
    return -_softplus(-x)


def _store(cache: dict, name: str, new) -> None:
    """Write ``new`` (a tensor or a tuple of them) into ``cache[name]`` in
    place."""
    dst = cache[name]
    for d, s in zip(dst, new) if isinstance(dst, tuple) else ((dst, new),):
        d.copy_(s)


def _finish(cache: Optional[dict], new: dict) -> dict:
    """The block's returned cache: ``new`` itself without a cache, else
    ``cache`` with ``new`` written into it."""
    if cache is None:
        return new
    for name, t in new.items():
        _store(cache, name, t)
    return cache


def _pad_seq(a, pad: int, value: float = 0.0):
    """``a`` (B, S, …) extended by ``pad`` steps of ``value`` along S."""
    return torch.cat([a, a.new_full((a.shape[0], pad, *a.shape[2:]), value)],
                     dim=1)


def _interleave(even, odd):
    """``even`` at positions 0, 2, … and ``odd`` at 1, 3, … of dim 1."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1],
                          *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(fn, elems: tuple) -> tuple:
    """``lax.associative_scan(fn, elems, axis=1)`` over a tuple of tensors:
    its odd/even recursion, so every element composes in the reference's
    order and rounds where it rounds (log2 S levels of strided ops)."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _associative_scan(fn, fn(tuple(e[:, 0:-1:2] for e in elems),
                                   tuple(e[:, 1::2] for e in elems)))
    prev = odd if n % 2 else tuple(o[:, :-1] for o in odd)
    even = fn(prev, tuple(e[:, 2::2] for e in elems))
    return tuple(_interleave(torch.cat([e[:, :1], v], dim=1), o)
                 for e, v, o in zip(elems, even, odd))


def _cumsum(x):
    """``jnp.cumsum(x, axis=1)`` as XLA lowers it off the TPU: an
    associative scan of adds in x's dtype (``torch.cumsum`` of a half
    tensor adds in fp32 and rounds once)."""
    return _associative_scan(lambda a, b: (a[0] + b[0],), (x,))[0]


def _compose(e1, e2):
    """Mamba's (a1, b1) then (a2, b2): h ↦ a2·(a1·h + b1) + b2."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _headwise_rmsnorm(x, scale, eps: float):
    """x: (..., H, Dh) — normalise per head (xLSTM group norm)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x: (B, S, C); w: (K, C); state: (B, K-1, C).
    The K taps are added left to right in x's dtype (Python's ``sum``)."""
    B, S, C = x.shape
    K = w.shape[0]
    pad = x.new_zeros((B, K - 1, C)) if state is None else state
    xp = torch.cat([pad, x], dim=1)                       # (B, S+K-1, C)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out, xp[:, xp.shape[1] - (K - 1):]


# ===========================================================================
# mLSTM
# ===========================================================================


def _mlstm_chunk_scan(q, k, v, lf, li, state, chunk: int):
    """Chunkwise stabilised mLSTM core.

    q, k, v: (B, S, H, Dh), S a multiple of ``chunk``; lf, li: (B, S, H)
    log gates; state: (C (B, H, Dh, Dh), n (B, H, Dh), m (B, H)).
    Returns h (B, S, H, Dh) in q's dtype, and the new state.
    """
    Dh = q.shape[-1]
    k = k / math.sqrt(Dh)
    Smat, n, m = state
    wide = Smat.dtype
    tmask = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=q.device).tril()
    hs = []
    for lo in range(0, q.shape[1], chunk):
        qc, kc, vc, lfc, lic = (t[:, lo:lo + chunk] for t in (q, k, v, lf, li))
        qw, kw, vw = qc.to(wide), kc.to(wide), vc.to(wide)
        cum = _cumsum(lfc)                                # (B,Q,H) inclusive
        # intra-chunk log weights L[t, τ] = cum_t − cum_τ + li_τ (τ ≤ t)
        L = cum[:, :, None, :] - cum[:, None, :, :] + lic[:, None, :, :]
        L = L.masked_fill(~tmask[None, :, :, None], LOG_EPS)
        G = cum + m[:, None, :]                           # (B,Q,H) boundary
        m_t = torch.maximum(L.amax(dim=2), G)             # (B,Q,H)
        w = torch.exp(L - m_t[:, :, None, :])             # (B,t,τ,H)
        inter = torch.exp(G - m_t)                        # (B,Q,H)
        a = w * torch.einsum("bthd,bshd->btsh", qw, kw)
        numer = torch.einsum("btsh,bshd->bthd", a, vw)
        numer = numer + inter[..., None] * torch.einsum(
            "bthd,bhde->bthe", qw, Smat)
        den = torch.sum(a, dim=2)                         # (B,Q,H)
        den = den + inter * torch.einsum("bthd,bhd->bth", qw, n)
        h = numer / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
        hs.append(h.to(q.dtype))
        # chunk-end state update
        cum_last = cum[:, -1:, :]                         # (B,1,H)
        logdecay = cum_last - cum + lic                   # (B,Q,H)
        m_new = torch.maximum(cum_last[:, 0] + m, logdecay.amax(dim=1))
        sdec = torch.exp(cum_last[:, 0] + m - m_new)      # (B,H)
        kd = torch.exp(logdecay - m_new[:, None, :])[..., None] * kw
        Smat = (sdec[..., None, None] * Smat
                + torch.einsum("bshd,bshe->bhde", kd, vw))
        n = sdec[..., None] * n + torch.sum(kd, dim=1)
        m = m_new
    return torch.cat(hs, dim=1), (Smat, n, m)


def mlstm_init_state(B, H, Dh, dtype=torch.float32, device=None):
    return (torch.zeros((B, H, Dh, Dh), dtype=dtype, device=device),
            torch.zeros((B, H, Dh), dtype=dtype, device=device),
            torch.zeros((B, H), dtype=dtype, device=device))


def mlstm_block(p, cfg, x, *, mode: str = "train",
                cache: Optional[dict] = None):
    """Full mLSTM block. Returns (y, cache) — ``{"ssm": (C, n, m),
    "conv"}``."""
    B, S, D = x.shape
    H = cfg.num_heads
    di = D * cfg.ssm_expand
    Dh = di // H
    xi = x @ p["w_up"]
    z = x @ p["w_z"]
    xc, conv_state = _causal_conv(
        xi, p["conv"], cache["conv"] if mode == "decode" else None)
    xc = F.silu(xc)

    bs = cfg.ssm_qkv_block
    nb = di // bs

    def blkproj(src, w):  # block-diagonal projection
        y = torch.einsum("bsnk,nkj->bsnj", src.reshape(B, S, nb, bs), w)
        return y.reshape(B, S, H, Dh)

    q = blkproj(xc, p["wq"])
    k = blkproj(xc, p["wk"])
    v = blkproj(xi, p["wv"])
    gates = xc @ p["w_if"]
    li = gates[..., :H]
    lf = _log_sigmoid(gates[..., H:] + p["f_bias"].to(gates.dtype)[None, None])

    if mode == "decode":
        Smat, n, m = cache["ssm"]
        wide = Smat.dtype
        lf1, li1 = lf[:, 0], li[:, 0]                     # (B,H)
        m_new = torch.maximum(lf1 + m, li1)
        fp = torch.exp(lf1 + m - m_new)
        ip = torch.exp(li1 - m_new)
        k1 = k[:, 0] / math.sqrt(Dh)
        Smat = fp[..., None, None] * Smat + ip[..., None, None] * (
            k1[..., :, None] * v[:, 0][..., None, :])
        n = fp[..., None] * n + ip[..., None] * k1
        q1 = q[:, 0].to(wide)
        num = torch.einsum("bhd,bhde->bhe", q1, Smat)
        den = torch.einsum("bhd,bhd->bh", q1, n)
        h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
        h = h[:, None].to(x.dtype)                        # (B,1,H,Dh)
        new_state = (Smat, n, m_new)
    else:
        state = mlstm_init_state(B, H, Dh, state_dtype(x.dtype), x.device)
        pad = (-S) % MLSTM_CHUNK
        if pad:   # zero gates, as the reference pads: they move m
            q, k, v, lf, li = (_pad_seq(t, pad) for t in (q, k, v, lf, li))
        h, new_state = _mlstm_chunk_scan(q, k, v, lf, li, state, MLSTM_CHUNK)
        h = h[:, :S]

    h = _headwise_rmsnorm(h, p["norm"], cfg.norm_eps)
    h = h.reshape(B, S, di) * F.silu(z)
    y = h @ p["w_down"]
    return y, _finish(None if mode == "train" else cache,
                      {"ssm": new_state, "conv": conv_state})


# ===========================================================================
# sLSTM
# ===========================================================================


def slstm_init_state(B, H, Dh, dtype=torch.float32, device=None):
    """(c, n, h, m), each (B, H, Dh)."""
    return tuple(torch.zeros((B, H, Dh), dtype=dtype, device=device)
                 for _ in range(4))


def _slstm_step(p, cfg, xg, state):
    """xg: (B, H, Dh, 4) pre-activations from the input; state: (c, n, h,
    m). The recurrence's weights are widened to the state's dtype."""
    c, n, h_prev, m = state
    wide = h_prev.dtype
    rec = torch.einsum("bhd,hdk->bhk", h_prev, p["r"].to(wide))
    rec = rec.reshape(*h_prev.shape, 4)
    pre = xg.to(wide) + rec
    i_t, f_t, z_t, o_t = pre.unbind(-1)
    f_t = f_t + p["f_bias"].to(wide)[None]
    m_new = torch.maximum(f_t + m, i_t)                   # exp gating
    ip = torch.exp(i_t - m_new)
    fp = torch.exp(f_t + m - m_new)
    c_new = fp * c + ip * torch.tanh(z_t)
    n_new = fp * n + ip
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new)


def slstm_block(p, cfg, x, *, mode: str = "train",
                cache: Optional[dict] = None):
    """Full sLSTM block (GeGLU FFN on the core). Returns (y, cache) —
    ``{"ssm": (c, n, h, m)}``."""
    B, S, D = x.shape
    H = cfg.num_heads
    Dh = D // H
    xg = (x @ p["w_in"]).reshape(B, S, H, Dh, 4)

    if mode == "decode":
        state = _slstm_step(p, cfg, xg[:, 0], cache["ssm"])
        h = state[2][:, None]                             # (B,1,H,Dh)
    else:
        state = slstm_init_state(B, H, Dh, state_dtype(x.dtype), x.device)
        hs = []
        for t in range(S):
            state = _slstm_step(p, cfg, xg[:, t], state)
            hs.append(state[2])
        h = torch.stack(hs, dim=1)                        # (B,S,H,Dh)

    h = _headwise_rmsnorm(h.to(x.dtype), p["norm"], cfg.norm_eps)
    core = h.reshape(B, S, D)
    gate = core @ p["ffn_gate"]
    up = core @ p["ffn_up"]
    ffn = (_act("gelu")(gate) * up) @ p["ffn_down"]
    return core + ffn, _finish(None if mode == "train" else cache,
                               {"ssm": state})


# ===========================================================================
# Mamba-style selective SSM (hymba's parallel-head partner)
# ===========================================================================


def mamba_init_state(B, di, N, dtype=torch.float32, device=None):
    return torch.zeros((B, di, N), dtype=dtype, device=device)


def _selective_scan_chunked(a, b, h0, chunk: int):
    """h_t = a_t·h_{t−1} + b_t, diagonal. a, b: (B, S, Di, N), S a
    multiple of ``chunk``; h0: (B, Di, N). Returns (hs, h_last)."""
    hs, h = [], h0
    for lo in range(0, a.shape[1], chunk):
        A, Bc = _associative_scan(
            _compose, (a[:, lo:lo + chunk], b[:, lo:lo + chunk]))
        hq = A * h[:, None] + Bc                          # (B, Q, Di, N)
        h = hq[:, -1]
        hs.append(hq)
    return torch.cat(hs, dim=1), h


def mamba_block(p, cfg, x, *, mode: str = "train",
                cache: Optional[dict] = None):
    """Mamba block. Returns (y, cache) — ``{"ssm": h, "conv"}``."""
    B, S, D = x.shape
    di = D * cfg.ssm_expand
    N = cfg.ssm_state
    wide = state_dtype(x.dtype)
    xz = x @ p["w_in"]
    xi, z = xz[..., :di], xz[..., di:]
    xc, conv_state = _causal_conv(
        xi, p["conv"], cache["conv"] if mode == "decode" else None)
    xc = F.silu(xc)

    bcdt = xc @ p["w_bcdt"]
    Bmat = bcdt[..., :N]                                  # (B,S,N)
    Cmat = bcdt[..., N:2 * N].to(wide)
    # dt: (B,S,Di) — rank-1 Δ projection broadcast + per-channel bias
    dt = _softplus(bcdt[..., -1:] + p["dt_bias"].to(bcdt.dtype)[None, None])
    A = -torch.exp(p["a_log"])                            # (Di,N)
    a = torch.exp(dt[..., None].to(wide) * A[None, None])
    b = ((dt * xc)[..., None] * Bmat[:, :, None, :]).to(wide)

    if mode == "decode":
        h = a[:, 0] * cache["ssm"] + b[:, 0]              # (B,Di,N)
        y = torch.einsum("bdn,bn->bd", h, Cmat[:, 0])[:, None]
        h_last = h
    else:
        h0 = mamba_init_state(B, di, N, wide, x.device)
        pad = (-S) % MAMBA_CHUNK
        if pad:
            a, b = _pad_seq(a, pad, 1.0), _pad_seq(b, pad)
        hs, h_last = _selective_scan_chunked(a, b, h0, MAMBA_CHUNK)
        y = torch.einsum("bsdn,bsn->bsd", hs[:, :S], Cmat)

    y = y + xc * p["d_skip"].to(y.dtype)[None, None]
    y = y * F.silu(z)
    out = y.to(x.dtype) @ p["w_out"]
    return out, _finish(None if mode == "train" else cache,
                        {"ssm": h_last, "conv": conv_state})
