"""Configuration dataclasses for models, input shapes, meshes and hardware.

Every assigned architecture is described by a :class:`ModelConfig`; the four
assigned input shapes by :class:`ShapeConfig`.  ``reduced()`` derives the
CPU-runnable smoke-test variant of any full config (same structural family —
MoE interleave, hybrid period, enc-dec split — just small).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ----------------------------------------------------------------------------
# Hardware model (NVIDIA H100 SXM, per card; NVIDIA's data sheet, dense rates
# at the full 700 W limit) — used by roofline + analytic latency.
# ----------------------------------------------------------------------------
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12    # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12          # bytes/s, HBM3
NVLINK_BW = 450e9         # bytes/s each way, per card
SMEM_BYTES = 227 * 1024   # shared memory one block can use
HBM_BYTES = 80 * 10**9


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  All sizes are in units of elements."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_tok: int = 1
    moe_period: int = 1            # MoE FFN every `moe_period`-th layer (1 = every layer)
    capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm_state: int = 0             # Mamba2 state size N (zamba2) / rwkv head size
    hybrid_attn_period: int = 0    # zamba2: shared attention block every k mamba blocks

    # --- encoder-decoder (seamless) ---
    is_encdec: bool = False
    num_encoder_layers: int = 0

    # --- modality frontend stubs ---
    frontend: str = "none"         # none | audio | vision
    num_prefix_tokens: int = 0     # precomputed frame/patch embeddings prepended

    # --- early exit (the paper's right-sizing knob) ---
    num_exits: int = 0             # exit heads evenly spaced in depth (final head excluded)
    tie_exit_heads: bool = True

    # --- numerics ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 524_288

    # metadata
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 128 so the vocab dim shards
        over the 16-way ``model`` axis (MaxText-style; padded logits are
        random-init and harmless — see DESIGN.md)."""
        return (self.vocab_size + 127) // 128 * 128

    @property
    def padded_heads(self) -> int:
        """Query heads padded per kv-group so whole heads shard over the
        16-way model axis (llama4: 40 -> 48 = 8 kv-groups x 6).  Padded heads
        are masked dead (zero output, zero gradient) — see layers.attention.
        No padding for head counts below the axis size (smoke configs)."""
        H, KV = self.num_heads, self.num_kv_heads
        M = MODEL_AXIS_SIZE
        if H % M == 0 or H < M:
            return H
        G = H // KV
        Gp = G
        while (KV * Gp) % M:
            Gp += 1
        return KV * Gp

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True when 500k-context decode is admissible (O(1)-state archs)."""
        return self.family in ("ssm", "hybrid")

    # ------------------------------------------------------------------
    # Parameter counting (drives MODEL_FLOPS = 6*N*D roofline term).
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        return q + kv + o

    def _dense_ffn_params(self) -> int:
        return 3 * self.d_model * self.d_ff  # SwiGLU: gate, up, down

    def _moe_ffn_params(self) -> int:
        return self.num_experts * 3 * self.d_model * self.d_ff + self.d_model * self.num_experts

    def _rwkv_layer_params(self) -> int:
        d = self.d_model
        # time-mix: r,k,v,g,o projections + decay/bonus params + small loras
        tm = 5 * d * d + 2 * d + 6 * (d * 64 + 64 * d)
        cm = d * self.d_ff + self.d_ff * d  # channel mix: key d->ff, value ff->d
        return tm + cm

    def _mamba2_layer_params(self) -> int:
        d, n = self.d_model, self.ssm_state
        d_inner = 2 * d
        # in_proj (z,x,B,C,dt), conv, out_proj, norm
        return d * (2 * d_inner + 2 * n + d_inner // 64) + d_inner * d + 4 * d_inner

    def param_count(self, active_only: bool = False) -> int:
        """Total (or active) parameter count, embeddings included once."""
        emb = self.vocab_size * self.d_model  # lm head tied to embedding
        n = 0
        if self.family == "ssm":
            n = self.num_layers * self._rwkv_layer_params()
        elif self.family == "hybrid":
            n = self.num_layers * self._mamba2_layer_params()
            if self.hybrid_attn_period:
                n += self._attn_params() + self._dense_ffn_params()  # one shared block
        else:
            layers = self.num_layers + (self.num_encoder_layers if self.is_encdec else 0)
            attn = layers * self._attn_params()
            if self.is_encdec:
                attn += self.num_layers * self._attn_params()  # cross attention
            ffn = 0
            for i in range(self.num_layers):
                is_moe = self.num_experts > 0 and (i % self.moe_period == self.moe_period - 1)
                if is_moe:
                    if active_only:
                        ffn += self.experts_per_tok * 3 * self.d_model * self.d_ff
                    else:
                        ffn += self._moe_ffn_params()
                else:
                    ffn += self._dense_ffn_params()
            if self.is_encdec:
                ffn += self.num_encoder_layers * self._dense_ffn_params()
            n = attn + ffn
        norms = (2 * self.num_layers + 2) * self.d_model
        return emb + n + norms

    def exit_layer_indices(self) -> Tuple[int, ...]:
        """Layer indices (1-based, exclusive of final layer) after which an
        exit head sits; evenly spaced in depth, BranchyNet-style."""
        if self.num_exits <= 0:
            return ()
        L = self.num_layers
        return tuple(max(1, round(L * (i + 1) / (self.num_exits + 1))) for i in range(self.num_exits))


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


MODEL_AXIS_SIZE = 16  # production model-parallel degree (16x16 pod)

SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


def reduced(cfg: ModelConfig, *, seq_len: int = 64, batch: int = 2) -> ModelConfig:
    """Smoke-test variant: same family/topology, tiny sizes."""
    L = min(cfg.num_layers, 4)
    if cfg.family == "hybrid" and cfg.hybrid_attn_period:
        L = 2 * min(cfg.hybrid_attn_period, 2)
        period = min(cfg.hybrid_attn_period, 2)
    else:
        period = cfg.hybrid_attn_period
    if cfg.num_experts and cfg.moe_period > 1:
        L = 4  # two (dense, moe) pairs
    kv = max(1, min(cfg.num_kv_heads, 2))
    heads = 4
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=L,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv if cfg.num_kv_heads < cfg.num_heads else heads,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 4),
        moe_period=cfg.moe_period,
        hybrid_attn_period=period,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        num_prefix_tokens=min(cfg.num_prefix_tokens, 8),
        num_exits=min(cfg.num_exits, 2),
        max_seq_len=4096,
    )


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable dry-run cell, with reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k-context decode skipped (see DESIGN.md §4)"
    return True, ""
