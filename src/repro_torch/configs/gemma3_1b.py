"""gemma3-1b — 5:1 local:global, 128k context [hf:google/gemma-3-1b-pt].

26L, d_model=1152, 4H GQA kv=1, d_ff=6912, vocab=262144, head_dim=256,
sliding_window=512, every 6th layer global (rope theta 1M), qk_norm, tied
embeddings. Long-context decode runs (5/6 of layers are O(window); global
layers decode O(L) per token) — long_500k included per DESIGN.md §4.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
    d_ff=6912, vocab_size=262144, head_dim=256,
    sliding_window=512, local_global_period=6,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    qk_norm=True, tie_embeddings=True,
    subquadratic=True, max_seq_len=524_288, act="gelu",
)

REDUCED = ModelConfig(
    name="gemma3-1b-reduced", family="dense",
    num_layers=4, d_model=64, num_heads=2, num_kv_heads=1,
    d_ff=128, vocab_size=256, head_dim=32,
    sliding_window=16, local_global_period=2,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    qk_norm=True, tie_embeddings=True,
    subquadratic=True, max_seq_len=512, act="gelu", dtype="float32",
)
