"""llama4-maverick-400b-a17b — MoE 128 experts, top-1
[hf:meta-llama/Llama-4 family].

MoE FFN on every 2nd layer (interleaved dense), matching the 400B-total /
17B-active budget implied by the name: 24 MoE layers x 128 experts x
3*5120*8192 ~= 386B expert params + attention + embeddings ~= 400B total;
top-1 routing keeps ~17B active per token.  (48 all-MoE layers would be
~780B total, inconsistent with the name — interleave recorded per DESIGN.md.)
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    num_experts=128,
    experts_per_tok=1,
    moe_period=2,
    rope_theta=500000.0,
    num_exits=4,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
