"""hymba-1.5b — parallel attn+mamba heads [arXiv:2411.13676; hf].

32L, d_model=1600, 25H GQA kv=5, d_ff=5504, ssm_state=16, vocab=32001,
head_dim=64. Full attention at layers {0, 15, 31}, sliding window 1024
elsewhere (per the paper); meta-tokens stubbed off (DESIGN.md §4).
Sub-quadratic in the long regime → long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm_state=16, ssm_expand=2, ssm_conv=4,
    sliding_window=1024, full_attn_layers=(0, 15, 31),
    subquadratic=True, max_seq_len=524_288,
)

REDUCED = ModelConfig(
    name="hymba-1.5b-reduced", family="hybrid",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    ssm_state=8, ssm_expand=2, ssm_conv=4,
    sliding_window=16, full_attn_layers=(0, 2),
    subquadratic=True, max_seq_len=512, dtype="float32",
)
