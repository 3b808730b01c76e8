"""Build, load and call the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` at first
use: one ``nvcc -c`` per source, all started together, then one link into a
shared library with a plain C interface under ``build/`` at the repository
root (``.gitignore`` lists it).  The library is loaded with :mod:`ctypes`;
the file name carries a digest of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.  The link names the CUDA
runtime alone: the one driver-API function the kernels use,
``cuTensorMapEncodeTiled`` (the TMA tensor maps of the bf16 flash and
chunked scan kernels), is looked up at run time with
``cudaGetDriverEntryPoint``, and its absence is an error the wrapper raises.

Nothing here runs at import: the CPU tests import every module of the port,
and a machine without ``nvcc`` never reaches :func:`library`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build in this process took (None: loaded a cached build)
build_seconds: Optional[float] = None
#: ptxas register / shared-memory report of the last build
build_log: str = ""

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    "decode_attention_fwd": [_P] * 7 + [_I] * 6 + [_LL] * 6 + [_I, _P],
    "exit_head_fwd": [_P, _P] + [_I] * 4 + [_P] * 7 + [_I, _P],
    "ssm_scan_fwd": [_P] * 8 + [_I] * 5 + [_LL] * 16 + [_I, _P],
    "ssm_scan_chunked_fwd": [_P] * 8 + [_I] * 5 + [_LL] * 16 + [_I, _P],
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    srcs, hdrs = _sources()
    for p in srcs + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link them into one library;
    returns its path (reused when a build of the same sources exists)."""
    global build_seconds, build_log
    tag = _digest()
    so = BUILD_DIR / f"librepro_kernels-{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    srcs, _ = _sources()
    jobs = []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}-{tag}.o"
        cmd = [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for src, _obj, proc in jobs:
        out, err = proc.communicate()
        logs.append(f"== {src.name}\n{out}{err}")
        if proc.returncode:
            failed.append(f"nvcc failed on {src.name}:\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
    link = subprocess.run([exe, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                           *[str(o) for _, o, _ in jobs]],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise if an entry point reported a refused launch or a bad argument."""
    if code != 0:
        msg = library().repro_error_string(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} (code {code})")


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return code


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_aligned(name: str, t: torch.Tensor) -> None:
    """The kernels read rows with 16-byte loads: ``t`` must start on a
    16-byte boundary and step by whole 16 bytes along every axis but the
    last (which must be unit-strided)."""
    vec = 16 // t.element_size()
    require(t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(st % vec == 0 for st in t.stride()[:-1]),
            f"{name} must be 16-byte aligned with unit last stride, got strides "
            f"{t.stride()}")


def require_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        require(t.is_cuda and t.device == dev,
                f"kernel inputs must share one CUDA device, got {t.device}")
