"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

48L, d_model=2048, 32H GQA kv=4, per-expert d_ff=768, vocab=151936,
head_dim=128 (explicit per HF config), qk_norm.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    num_experts=128, experts_per_tok=8,
    qk_norm=True, rope_theta=1_000_000.0, max_seq_len=131_072,
)

REDUCED = ModelConfig(
    name="qwen3-moe-30b-a3b-reduced", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=32, vocab_size=256, head_dim=16,
    num_experts=8, experts_per_tok=2, moe_capacity=8.0,
    qk_norm=True, max_seq_len=512, dtype="float32",
)
