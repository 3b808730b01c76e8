"""llama4-scout-17b-a16e — MoE 16 experts, top-1, MoE every layer
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    num_experts=16,
    experts_per_tok=1,
    moe_period=1,
    rope_theta=500000.0,
    num_exits=4,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
