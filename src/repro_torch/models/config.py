"""Unified model configuration covering all 10 assigned architectures.

The port's own copy of the JAX package's `ModelConfig` (plain Python, field
for field): the configs and the models read it, and nothing here imports
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None  # gemma3 global layers
    sliding_window: Optional[int] = None
    local_global_period: Optional[int] = None  # gemma3: every Nth layer global
    full_attn_layers: Optional[tuple[int, ...]] = None  # hymba explicit fulls

    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    expert_pad_to: Optional[int] = None  # EP divisibility padding (granite)
    moe_capacity: float = 1.25  # capacity factor (tokens over C are dropped)

    # SSM / xLSTM / hymba
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_qkv_block: int = 4  # xlstm mLSTM: block-diagonal q/k/v block size
    slstm_period: int = 0  # xlstm: every Nth layer is sLSTM (7:1 → 8)

    # enc-dec / multimodal frontends (stubs feed precomputed embeddings)
    encoder_layers: int = 0
    frontend: Optional[str] = None  # audio_stub | vision_stub
    frontend_len: int = 0

    # misc
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None
    dtype: str = "bfloat16"
    max_seq_len: int = 131_072
    # attention flavor applicable for long-context shapes
    subquadratic: bool = False  # True → long_500k cell runs

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: heads {self.num_heads} not a "
                             f"multiple of kv heads {self.num_kv_heads}")
        if self.num_experts and self.expert_pad_to is None:
            object.__setattr__(self, "expert_pad_to", self.num_experts)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def layer_types(self) -> list[str]:
        """Per-layer block type, in order — drives the scan grouping."""
        out = []
        for i in range(self.num_layers):
            if self.family == "ssm":  # xlstm
                if self.slstm_period and i % self.slstm_period == self.slstm_period - 1:
                    out.append("slstm")
                else:
                    out.append("mlstm")
            elif self.family == "hybrid":
                full = self.full_attn_layers or ()
                out.append("hybrid_full" if i in full else "hybrid_sw")
            elif self.local_global_period:
                if (i + 1) % self.local_global_period == 0:
                    out.append("attn_global")
                else:
                    out.append("attn_local")
            elif self.family == "moe":
                out.append("moe")
            else:
                out.append("attn")
        return out

    def groups(self) -> list[tuple[str, int]]:
        """Compress consecutive identical layer types into scan groups."""
        types = self.layer_types()
        groups: list[tuple[str, int]] = []
        for t in types:
            if groups and groups[-1][0] == t:
                groups[-1] = (t, groups[-1][1] + 1)
            else:
                groups.append((t, 1))
        return groups

    # -- analytic parameter counts (validated in tests) ---------------------

    def attn_params(self) -> int:
        hd = self.head_dim
        return (self.d_model * self.num_heads * hd            # q
                + 2 * self.d_model * self.num_kv_heads * hd   # k, v
                + self.num_heads * hd * self.d_model)         # o

    def mlp_params(self) -> int:
        return 3 * self.d_model * self.d_ff  # SwiGLU: gate, up, down

    def moe_params(self) -> int:
        e = self.expert_pad_to  # allocated (EP-padded) expert count
        return (self.d_model * e                                # router
                + e * 3 * self.d_model * self.d_ff)

    def approx_params(self) -> int:
        """Analytic total parameter count (embeddings + blocks + norms)."""
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        total = emb + head + self.d_model  # final norm
        for t in self.layer_types():
            if t in ("attn", "attn_local", "attn_global"):
                total += self.attn_params() + self.mlp_params() + 2 * self.d_model
                if self.qk_norm:
                    total += 2 * self.head_dim
            elif t == "moe":
                total += self.attn_params() + self.moe_params() + 2 * self.d_model
                if self.qk_norm:
                    total += 2 * self.head_dim
            elif t == "mlstm":
                d = self.d_model
                di = d * self.ssm_expand
                h = self.num_heads
                total += (2 * d * di                   # up, z-gate
                          + self.ssm_conv * di         # causal conv
                          + 3 * di * self.ssm_qkv_block  # block-diag q/k/v
                          + di * 2 * h + h             # i/f gates + f bias
                          + di                         # head norm
                          + di * d                     # down
                          + d)                         # pre-LN
            elif t == "slstm":
                d = self.d_model
                h = self.num_heads
                dh = d // h
                dff = int(d * 4 / 3)
                total += (4 * d * d                    # input gates (i,f,z,o)
                          + h * dh * 4 * dh            # per-head recurrence
                          + 2 * d                      # f bias + head norm
                          + 3 * d * dff                # GeGLU ffn
                          + d)                         # pre-LN
            elif t in ("hybrid_full", "hybrid_sw"):
                d_in = self.d_model * self.ssm_expand
                total += self.attn_params() + 2 * self.d_model
                total += (2 * self.d_model * d_in          # ssm in-proj (x, z)
                          + d_in * self.ssm_conv           # conv
                          + d_in * (2 * self.ssm_state + 1)  # B, C, dt proj
                          + d_in                           # A (per-channel)
                          + d_in * self.d_model)           # out proj
                total += self.mlp_params()
        if self.encoder_layers:
            # whisper: encoder self-attn + mlp, decoder adds cross-attn
            enc = self.encoder_layers * (
                self.attn_params() + self.mlp_params() + 2 * self.d_model)
            cross = self.num_layers * (self.attn_params() + self.d_model)
            total += enc + cross
        return total
