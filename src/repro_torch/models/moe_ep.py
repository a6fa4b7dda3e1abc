"""Expert-parallel MoE over ``all_to_all_single`` on the model axis.

The port of the JAX package's ``models/moe_ep.py``. The dense
:func:`repro_torch.models.layers.moe` sorts every token of the call into
one (E, C, D) buffer and runs every expert. Here the experts are split
over the model axis, E/|model| contiguous experts per rank:

  * each model rank routes an exclusive 1/|model| slice of its rows'
    sequence (token-parallel routing). The router product itself runs
    over all of the rows' tokens and the rank keeps its slice: that (T, E)
    product is small beside the experts', and it gives the rank the dense
    path's routing bits, where a product over the slice alone rounds
    otherwise in the last bit — enough, in bf16 over 32 layers, for flipped
    top-K choices to cascade;
  * assignments are binned per destination rank with a per-expert,
    per-source capacity ``cap = ⌈Ts·K/E·cf⌉`` (Ts: the slice's tokens);
  * one ``all_to_all_single`` moves the (|model|, e_loc·cap, D) send
    buffer, a grouped product runs the rank's ``e_loc`` experts, and a
    second ``all_to_all_single`` brings the outputs back;
  * each token's K contributions are added in one fixed order (as the
    dense path does), and one all-gather in shard order rebuilds the
    rows' whole sequence on every model rank.

Collectives per layer: two ``all_to_all_single`` and one ``all_gather``
over the model group. Serving holds the weights whole on every rank, and
a rank multiplies by its own experts' views. Training holds a placed
model (:mod:`repro_torch.models.placed`): the expert stacks are split
over the model axis (``("expert", "fsdp", None)``), so each rank keeps
its experts and gathers their ``d_model`` over the data axes, and the
router is gathered whole. In train mode gradients flow through every
exchange (:mod:`repro_torch.distributed.parallel`): each
``all_to_all_single``'s backward is the reverse exchange, the closing
all-gather's is this rank's slice, and the input's gradient — each rank
routed its own slice — adds over the model group, as does the router's.
With a capacity that drops nothing the output equals the dense path's,
bit for bit where the expert products round alike (on the H100 they do:
``chip_smoke.py`` phase 3h holds one layer to it).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.parallel import (all_to_all, copy_in,
                                             gather_cat_grad)
from repro_torch.distributed.sharding import on_mesh
from repro_torch.models.layers import NEG_INF, _act


def ep_applicable(cfg, rules, B: int, S: int) -> bool:
    """The reference's three conditions: the padded experts, the
    sequence (split over the model axis) and the whole batch ``B`` (split
    over the data axes) all divide."""
    if not on_mesh(rules) or "model" not in rules.shape:
        return False
    n_model = rules.shape["model"]
    dp = math.prod(rules.shape[a] for a in rules.data_axes)
    return (cfg.expert_pad_to % n_model == 0
            and S % n_model == 0           # seq is split over the model axis
            and B % dp == 0)


def moe_ep(p, cfg, x, act: str, rules, capacity_factor: float | None = None):
    """x: (B_loc, S, D), this rank's rows (the same on every rank of its
    model group) → (B_loc, S, D). ``p``: the MoE block's weights, whole
    (serving) or a placed layer's tree (training)."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity
    sh = rules.shards(("model",))
    if sh.order != tuple(range(sh.p)):
        raise ValueError(f"the model group's ranks {sh.order} are not in "
                         f"the mesh's order")
    n_model, mi = sh.p, sh.index
    E, E_real, K = cfg.expert_pad_to, cfg.num_experts, cfg.experts_per_tok
    e_loc = E // n_model
    B_loc, S, D = x.shape
    S_loc = S // n_model
    dev = x.device
    Ts = B_loc * S_loc
    cap = max(int(math.ceil(Ts * K / E * capacity_factor)), 1)
    lo = mi * e_loc
    if hasattr(p, "block"):             # a placed layer: its own experts
        router = p.partitioned()["router"]
        wg, wu, wd = p.block("w_gate"), p.block("w_up"), p.block("w_down")
    else:
        router = p["router"]
        wg, wu, wd = (p[k][lo:lo + e_loc] for k in ("w_gate", "w_up",
                                                     "w_down"))
    x = copy_in(sh, x)
    xs = x[:, mi * S_loc:(mi + 1) * S_loc].reshape(Ts, D)

    # -- route this rank's token slice (the product over all the rows) --
    logits = (x.reshape(B_loc * S, D).float() @ router.float()) \
        .view(B_loc, S, E)[:, mi * S_loc:(mi + 1) * S_loc].reshape(Ts, E)
    if E_real < E:  # padded experts never routed
        pad = torch.arange(E, device=dev) >= E_real
        logits = logits.masked_fill(pad[None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :K], top_i[:, :K]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    # -- bin (token, k) assignments into the per-expert send queues --
    flat_e = top_i.reshape(-1)
    flat_t = torch.arange(Ts, device=dev)[:, None].expand(Ts, K).reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], top_w.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    rank = torch.arange(Ts * K, device=dev) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + torch.clamp(rank, 0, cap - 1),
                       E * cap)
    send = xs.new_zeros((E * cap + 1, D))
    send[slot] = xs[st]                      # drops all land on row E·cap
    # experts are contiguous per destination rank → rank-major layout
    send = send[:-1]                                          # (E·cap, D)

    # -- dispatch / compute / return --
    recv = all_to_all(send, sh.group)
    buf = recv.view(n_model, e_loc, cap, D).transpose(0, 1) \
        .reshape(e_loc, n_model * cap, D)
    h = _act(act)(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out = torch.bmm(h, wd)
    out = out.view(e_loc, n_model, cap, D).transpose(0, 1) \
        .reshape(E * cap, D)
    back = all_to_all(out, sh.group)

    # -- undo the binning, apply the combine weights in (token, k) order --
    contrib = torch.where(keep[:, None],
                          back[torch.clamp(slot, 0, E * cap - 1)], 0.0)
    contrib = contrib * sw[:, None].to(back.dtype)
    per_k = torch.empty_like(contrib)
    per_k[order] = contrib
    y = per_k.view(Ts, K, D).sum(dim=1).view(B_loc, S_loc, D).to(x.dtype)
    return gather_cat_grad(sh, y, 1)
