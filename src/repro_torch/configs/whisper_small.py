"""whisper-small — enc-dec, conv frontend STUB [arXiv:2212.04356; unverified].

12 encoder + 12 decoder layers, d_model=768, 12 heads (MHA), d_ff=3072,
vocab=51865. input_specs() feeds precomputed (B, 1500, 768) frame embeddings
(the conv frontend is a stub per the task spec). Full-attention decoder →
long_500k skipped (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    num_layers=12, encoder_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=51865,
    frontend="audio_stub", frontend_len=1500,
    act="gelu", max_seq_len=32_768,
)

REDUCED = ModelConfig(
    name="whisper-small-reduced", family="encdec",
    num_layers=2, encoder_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
    frontend="audio_stub", frontend_len=16,
    act="gelu", max_seq_len=512, dtype="float32",
)
