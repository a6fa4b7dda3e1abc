"""granite-moe-3b-a800m — 40 experts top-8 [hf:ibm-granite; hf].

32L, d_model=1536, 24H GQA kv=8, per-expert d_ff=512, vocab=49155.
40 experts padded to 48 for 16-way EP divisibility (17% expert padding,
zero-routed; DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    num_experts=40, experts_per_tok=8, expert_pad_to=48,
    max_seq_len=131_072,
)

REDUCED = ModelConfig(
    name="granite-moe-3b-a800m-reduced", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=32, vocab_size=256, head_dim=16,
    num_experts=5, experts_per_tok=2, expert_pad_to=6, moe_capacity=8.0,
    max_seq_len=512, dtype="float32",
)
