"""qwen3-0.6b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

28L, d_model=1024, 16H GQA kv=8, d_ff=3072, vocab=151936, head_dim=128
(explicit), tied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=3072, vocab_size=151936, head_dim=128,
    qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0,
    max_seq_len=131_072,
)

REDUCED = ModelConfig(
    name="qwen3-0.6b-reduced", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    qk_norm=True, tie_embeddings=True,
    max_seq_len=512, dtype="float32",
)
