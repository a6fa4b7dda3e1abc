"""stablelm-12b [hf:stabilityai/stablelm-2-1_6b; hf].

40L, d_model=5120, 32H GQA kv=8, d_ff=13824, vocab=100352, head_dim=160
(d_model/heads; not 128-aligned — MXU pad waste noted in the roofline).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=13824, vocab_size=100352, head_dim=160,
    max_seq_len=131_072,
)

REDUCED = ModelConfig(
    name="stablelm-12b-reduced", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=20,
    max_seq_len=512, dtype="float32",
)
