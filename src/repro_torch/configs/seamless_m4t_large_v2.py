"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone
[arXiv:2308.11596].

The speech/text frontend is a STUB per the assignment: ``input_specs`` feeds
precomputed frame embeddings straight into the 24-layer encoder; the 24-layer
text decoder (self + cross attention) produces vocab logits.  For the assigned
LM shapes the encoder consumes ``seq_len`` frames and the decoder ``seq_len``
target positions; decode shapes drive the decoder with a ``seq_len`` KV cache
plus cross-attention over the encoder memory.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,           # decoder layers
    num_encoder_layers=24,
    is_encdec=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    frontend="audio",
    num_exits=4,             # decoder-side exits only (see DESIGN.md §4)
    source="arXiv:2308.11596; hf",
)
