"""llava-next-mistral-7b — VLM: mistral-7b text backbone + anyres vision stub
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The anyres tiling frontend is a STUB: ``input_specs`` provides 2880
precomputed patch embeddings (576 base + 4x576 tiles) prepended to the text
tokens, exactly the activation-size heterogeneity the paper's partition
planner exploits (a big image prefix inflates the Input/B transfer term).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    frontend="vision",
    num_prefix_tokens=2880,
    rope_theta=1000000.0,
    num_exits=4,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
