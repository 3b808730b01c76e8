"""The yardstick's counts against shapes worked by hand."""
import pytest

from portbench.harness import flops as F
from portbench.harness import peaks
from portbench.harness.spec import HERE
import json


def test_causal_pairs():
    assert F.causal_pairs(4, 4) == 1 + 2 + 3 + 4
    assert F.causal_pairs(2, 5) == 4 + 5          # bottom-right: query 0 sees keys 0..3


def test_flash_attention_call():
    # B2 S3 T3 H4 KV2 hd8 causal, bf16: 6 pairs a head
    f, b = F.flash_attention(2, 3, 3, 4, 2, 8, True, 2)
    assert f == 4 * 2 * 4 * 8 * 6
    assert b == 2 * (2 * 2 * 3 * 4 * 8 + 2 * 2 * 3 * 2 * 8)


def test_decode_attention_call():
    # B2 H4 KV2 hd8, lengths 5 and 7
    f, b = F.decode_attention(2, 4, 2, 8, [5, 7], 2)
    assert f == 4 * 4 * 8 * 12
    assert b == 2 * (2 * 2 * 4 * 8 + 2 * 2 * 8 * 12) + 4 * 2


def test_ssm_scan_call():
    # B1 S10 H2 dk4 dv3, inputs 100 distinct bytes, bf16 output
    f, b = F.ssm_scan(1, 10, 2, 4, 3, 100.0, 2, bonus=False)
    assert f == 5 * 10 * 2 * 4 * 3
    assert b == 100 + 2 * 4 * 2 * 4 * 3 + 2 * 10 * 2 * 3
    assert F.ssm_scan(1, 10, 2, 4, 3, 0.0, 2, bonus=True)[0] == 7 * 10 * 2 * 4 * 3


def test_distinct_bytes_counts_a_broadcast_once():
    # [B2, S5, H80 broadcast, N64] bf16
    assert F.distinct_bytes((2, 5, 80, 64), (640, 64, 0, 1), 2) == 2 * 5 * 64 * 2


def test_exit_head_call():
    f, b = F.exit_head(8, 4096, 49280, 2)
    assert f == 2 * 8 * 4096 * 49280
    assert b == 2 * (49280 * 4096 + 8 * 4096) + 12 * 8


def test_least_seconds_takes_the_binding_bound():
    assert peaks.least_seconds(989e12, 1.0) == pytest.approx(1.0)
    assert peaks.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)


#: the hybrid family's sizes (the port's zamba2-2.7b), beside the cells' configurations
HYBRID = {"family": "hybrid", "num_layers": 54, "d_model": 2560, "num_heads": 32,
          "num_kv_heads": 32, "head_dim": 80, "d_ff": 10240, "vocab_size": 32000,
          "ssm_state": 64, "ssm_head_dim": 64, "conv_width": 4, "hybrid_attn_period": 6}


@pytest.mark.parametrize("cell", ["granite-3-8b", "zamba2-2.7b"])
def test_request_flops_is_the_sum_over_tokens(cell):
    cfg = HYBRID if cell == "zamba2-2.7b" else json.loads((HERE / "configs" / f"{cell}.json").read_text())
    L, layers = 37, [12, 12, cfg["num_layers"]]
    want = 0.0
    for i in range(L):
        a, b = F.token_flops_linear(cfg, cfg["num_layers"])
        want += a + b * (i + 1)
    want += F.head_flops(cfg)
    for k, lay in enumerate(layers):
        a, b = F.token_flops_linear(cfg, lay)
        want += a + b * (L + k + 1) + F.head_flops(cfg)
    assert F.request_flops(cfg, L, layers) == pytest.approx(want)


def test_dense_token_flops_by_hand():
    cfg = {"family": "dense", "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
           "head_dim": 4, "d_ff": 16}
    a, b = F.token_flops_linear(cfg, 3)
    attn = 8 * 2 * 4 + 2 * 8 * 1 * 4 + 2 * 4 * 8
    assert a == 3 * 2 * (attn + 3 * 8 * 16)
    assert b == 3 * 4 * 2 * 4
