"""pixtral-12b — pixtral-ViT + mistral-nemo backbone [hf:mistralai/Pixtral].

40L, d_model=5120, 32H GQA kv=8, d_ff=14336, vocab=131072, head_dim=128.
ViT frontend is a STUB: input_specs() provides precomputed patch embeddings
(B, 1024, 5120) consumed as a prefix. Full attention → long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128,
    frontend="vision_stub", frontend_len=1024,
    rope_theta=1_000_000.0, max_seq_len=131_072,
)

REDUCED = ModelConfig(
    name="pixtral-12b-reduced", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    frontend="vision_stub", frontend_len=8,
    max_seq_len=512, dtype="float32",
)
