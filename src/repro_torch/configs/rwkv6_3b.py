"""rwkv6-3b — Finch: attention-free RNN with data-dependent decay
[arXiv:2404.05892].  head size 64 -> 40 heads; wkv state is (heads, 64, 64).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,       # d_model / head_size(64)
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    ssm_state=64,       # per-head square wkv state
    num_exits=4,
    source="arXiv:2404.05892; hf",
)
