"""qwen3-32b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

64L, d_model=5120, 64H GQA kv=8, d_ff=25600, vocab=151936, head_dim=128.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    d_ff=25600, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0, max_seq_len=131_072,
)

REDUCED = ModelConfig(
    name="qwen3-32b-reduced", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=256, head_dim=16,
    qk_norm=True, max_seq_len=512, dtype="float32",
)
