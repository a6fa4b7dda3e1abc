"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L, d_model=2048, 4 heads, no separate FFN (d_ff=0: mLSTM carries a 2x
up-projection, sLSTM a 4/3 GeGLU — see DESIGN.md §4). 7:1 mLSTM:sLSTM
(sLSTM every 8th layer). Sub-quadratic: long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    head_dim=512,
    slstm_period=8, ssm_expand=2, ssm_conv=4,
    subquadratic=True, max_seq_len=524_288,
)

REDUCED = ModelConfig(
    name="xlstm-1.3b-reduced", family="ssm",
    num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
    d_ff=0, vocab_size=256, head_dim=32,
    slstm_period=2, ssm_expand=2, ssm_conv=4,
    subquadratic=True, max_seq_len=512, dtype="float32",
)
