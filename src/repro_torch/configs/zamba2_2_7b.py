"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention block
[arXiv:2411.15242].

54 Mamba2 (SSD) blocks; one weight-shared GQA attention + FFN block is applied
every 6 mamba blocks (9 applications, single weight copy) — the zamba2
shared-block pattern.  ssm_state=64.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm_state=64,
    hybrid_attn_period=6,
    num_exits=4,
    source="arXiv:2411.15242; hf",
)
