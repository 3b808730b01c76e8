"""The kernel wrappers' host side, which runs before any launch: argument
checks, the no-fallback rule and the build's cache key.  No JAX here, and no
CUDA kernel runs: those are held against their plain versions on the card by
chip_smoke.py."""
import pytest
import torch

from repro_torch.kernels import build, launch_counts
from repro_torch.kernels.exit_head import ops as eh_ops
from repro_torch.kernels.flash_attention import ops as fa_ops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_require_aligned_takes_cache_views(dtype):
    cache = torch.zeros((3, 2, 40, 8, 64), dtype=dtype)
    build.require_aligned("k", cache[1])                 # a unit of the segment cache
    build.require_aligned("k", cache[1].transpose(1, 2).transpose(1, 2))
    with pytest.raises(ValueError, match="16-byte"):
        build.require_aligned("k", cache[1][..., 1:])    # row starts mid-vector
    with pytest.raises(ValueError, match="16-byte"):
        build.require_aligned("k", cache[1].transpose(-1, -2))   # hd not unit-strided
    with pytest.raises(ValueError, match="16-byte"):
        build.require_aligned("k", cache.view(-1)[1:1 + 2 * 40 * 8 * 64].view(2, 40, 8, 64))


def test_dtype_codes():
    assert build.dtype_code(torch.zeros(1)) == 0
    assert build.dtype_code(torch.zeros(1, dtype=torch.bfloat16)) == 1
    with pytest.raises(TypeError):
        build.dtype_code(torch.zeros(1, dtype=torch.float16))


def test_a_tensor_off_the_cpu_never_takes_the_plain_version():
    """Only a CPU tensor goes to the plain version; any other device must
    reach the kernel or raise (a meta tensor is neither CPU nor CUDA)."""
    before = launch_counts()
    q = torch.empty((1, 8, 4, 64), device="meta")
    k = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.decode_attention(q[:, :1], k, k, torch.ones(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        eh_ops.exit_confidence(torch.empty((1, 1, 64), device="meta"),
                               torch.empty((100, 64), device="meta"))
    assert launch_counts() == before


def test_decode_attention_is_single_query_on_every_device():
    q = torch.zeros((1, 2, 4, 64))
    k = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="single-query"):
        fa_ops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))


def test_build_key_follows_sources_and_flags(monkeypatch):
    key = build._digest()
    assert key == build._digest() and len(key) == 16
    assert sorted(p.name for p in build._sources()[0]) == [
        "common.cu", "decode_attention.cu", "exit_head.cu", "flash_attention.cu"]
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build._digest() != key
