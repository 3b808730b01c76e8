"""granite-3-2b — dense GQA transformer [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    head_dim=64,
    num_exits=4,
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)
