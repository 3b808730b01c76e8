"""The kernel wrappers' host side, which runs before any launch: argument
checks, the no-fallback rule and the build's cache key.  No JAX here, and no
CUDA kernel runs: those are held against their plain versions on the card by
chip_smoke.py."""
import pytest
import torch

from repro_torch.kernels import build, launch_counts
from repro_torch.kernels.exit_head import ops as eh_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssm_scan import ops as ss_ops


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
    x = torch.empty((1, 3, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ss_ops.ssm_scan(x, x, x, x, torch.empty((1, 2, 64, 64), device="meta"))
    assert launch_counts() == before


def test_decode_attention_is_single_query_on_every_device():
    q = torch.zeros((1, 2, 4, 64))
    k = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="single-query"):
        fa_ops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))


def test_every_entry_point_has_a_signature():
    """Each ``extern "C"`` entry point of ``csrc/`` is bound by ctypes with
    its argument types, and each bound name exists in a source."""
    import re
    names = set()
    for src in build._sources()[0]:
        names |= set(re.findall(r'extern "C" int (\w+)\(', src.read_text()))
    assert names == set(build._SIGNATURES)


def test_build_key_follows_sources_and_flags(monkeypatch):
    key = build._digest()
    assert key == build._digest() and len(key) == 16
    assert sorted(p.name for p in build._sources()[0]) == [
        "common.cu", "decode_attention.cu", "exit_head.cu", "flash_attention.cu",
        "ssm_scan.cu"]
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build._digest() != key


class _FakeLibrary:
    """Records the arguments of ``exit_head_fwd`` instead of launching."""

    def __init__(self):
        self.calls = []

    def exit_head_fwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("B,S,V", [(4, 1, 128256), (2, 1, 32000), (1, 65, 49155), (1, 1, 17)])
def test_exit_head_launch_follows_the_plan(monkeypatch, B, S, V):
    """The wrapper's one launch, off the card: the C prototype's argument
    count, the plan's chunk count for the device's SMs, the scratch and
    ticket sizes, the outputs as [B, S] views, one launch counted."""
    D = 64
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "require_cuda", lambda *ts: None)
    monkeypatch.setattr(build, "stream", lambda t: 7)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(eh_ops, "_SMS", {None: 132})
    monkeypatch.setattr(eh_ops, "_TICKETS", {})
    monkeypatch.setitem(eh_ops.LAUNCHES, "exit_confidence", 0)
    h = torch.empty((B, S, D), dtype=torch.bfloat16, device="meta")
    emb = torch.empty((V, D), dtype=torch.bfloat16, device="meta")
    out = eh_ops.exit_confidence(h, emb)
    (args,) = lib.calls
    assert len(args) == len(build._SIGNATURES["exit_head_fwd"])
    rows, n_chunks = B * S, eh_ops.exit_head_plan(V, 132)[1]
    assert args[2:6] == (rows, D, V, n_chunks) and args[-2:] == (1, 7)
    (tickets,) = eh_ops._TICKETS.values()
    assert tickets.numel() >= -(-rows // 4) and tickets.dtype == torch.int32
    assert args[9] - args[6] == 4 * (4 * rows * n_chunks + rows)   # partials, then tok, conf
    assert out["token"].shape == out["conf"].shape == out["entropy"].shape == (B, S)
    assert out["token"].dtype == torch.int32 and out["conf"].dtype == torch.float32
    assert eh_ops.LAUNCHES["exit_confidence"] == 1


def test_exit_head_refuses_rows_tma_cannot_stride(monkeypatch):
    monkeypatch.setattr(build, "require_cuda", lambda *ts: None)
    with pytest.raises(ValueError, match="multiple of 8"):
        eh_ops.exit_confidence(torch.empty((1, 1, 60), device="meta"),
                               torch.empty((100, 60), device="meta"))
