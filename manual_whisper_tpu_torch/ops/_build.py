"""Build the CUDA kernels in ``csrc/`` with nvcc and bind them with ctypes.

Each source under ``csrc/`` compiles to its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  Libraries go to
``manual_whisper_tpu_torch/_kernels/`` (listed in ``.gitignore``).  The
first call to any kernel builds every missing library, all nvcc processes
started together.  Each C entry point launches on the stream it is given
and returns ``cudaGetLastError()``; ``check()`` raises when that is not 0.
The wrappers count their launches through ``spans.count``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signature of each entry point: (library, symbol) -> argtypes
SIGNATURES: Dict[str, Dict[str, list]] = {
    "mel": {
        # audio, cos_packed, sin_packed, bands, weights, out, batch,
        # n_samples, n_frames, n_mels, widest band's bins, stream
        "mwx_log_mel": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # tile (int[2]: frequencies a thread, threads along them)
        "mwx_log_mel_tile": [_P],
    },
    "flash_attention": {
        # q, k, v, out, batch*heads, t_q, t_k, head_dim, stream (bf16;
        # the _f32 entry the same in float32)
        "mwx_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "mwx_flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "decode_attention": {
        # q, k, v, out, len_ptr, len_offset, batch*heads, t_max, head_dim,
        # stream (bf16; the _f32 entries the same in float32)
        "mwx_decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "mwx_decode_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # float32 (0 or 1), batch*heads, int[3] out: K3's launch shape
        # (blocks per (batch, head), keys per lane group, threads)
        "mwx_decode_self_shape": [_I, _I, _P],
        # q, k, v, out, len_ptr, batch*heads, t_max, head_dim, stream
        "mwx_decode_cross_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
        "mwx_decode_cross_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I,
                                           _P],
        # q, k_q, k_s, v_q, v_s, out, len_ptr, batch*heads, t_max,
        # head_dim, scale_bf16, stream
        "mwx_decode_attention_int8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _P],
        # batch*heads, scale_bf16, int[6] out: K5's launch shape at dh 64
        # (blocks per (batch, head), stages, keys a stage, threads, ring
        # bytes, blocks resident per SM)
        "mwx_decode_int8_shape": [_I, _I, _P],
    },
    "int8_matmul": {
        # x, q, s, out, m, k, n, stream
        "mwx_int8_matmul": [_P, _P, _P, _P, _I, _I, _I, _P],
    },
    "add_layer_norm": {
        # h, delta (or null), bias (or null), gamma, beta, h_out, y, rows,
        # d, stream (bf16; the _f32 entry the same in float32)
        "mwx_add_layer_norm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
        "mwx_add_layer_norm_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)"
                       ": the CUDA kernels are built from csrc/ on first use")


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    common = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + common
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> Dict[str, Path]:
    """Build every missing library, one nvcc per source, all in parallel.

    Returns {name: library path}.  Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SIGNATURES}
    todo = {name: t for name, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    procs: List[tuple] = []
    try:
        for name, target in todo.items():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            procs.append((name, target, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for name, target, tmp, proc in procs:
            out, _ = proc.communicate()
            build_logs[name] = out.decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                              + build_logs[name])
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded, typed library ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            for symbol, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


# element types of the attention kernels K2-K4: a build each, with its own
# entry point (symbol suffix) and kernel name (name suffix)
ATTENTION_DTYPES = {torch.bfloat16: "", torch.float32: "_f32"}


def attention_dtype(what: str, *tensors: torch.Tensor) -> str:
    """The suffix of the K2-K4 build for ``tensors``: all bf16 (``""``) or
    all float32 (``"_f32"``).  Raises on any other dtype or a mix."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"{what}: q, k and v must share one dtype, got "
                         f"{sorted(str(d) for d in dtypes)}")
    (dtype,) = dtypes
    if dtype not in ATTENTION_DTYPES:
        raise ValueError(f"{what}: the kernel takes bfloat16 or float32 "
                         f"(compute_type bfloat16/float16/int8 or float32), "
                         f"got dtype {dtype}")
    return ATTENTION_DTYPES[dtype]


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple, device: torch.device) -> None:
    """Check what a kernel takes: device, dtype, shape, contiguity and
    16-byte alignment (the kernels use 16-byte vector loads)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
