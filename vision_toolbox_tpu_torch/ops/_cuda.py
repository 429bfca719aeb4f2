"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``vision_toolbox_tpu_torch/csrc/*.cu`` have a plain C
interface. At first use they are compiled with ``nvcc`` for ``sm_90a`` into
one shared library under ``csrc/_build/<hash of sources and flags>/`` (a
directory git ignores) and loaded with ``ctypes``; later calls and later
processes reuse the library as long as the sources are unchanged. Nothing
here runs at import: the CPU tests import every module on machines that
have neither ``nvcc`` nor a card.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it, so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
LIB_NAME = "libvtt_kernels.so"

LAUNCHES: dict[str, int] = {
    "block_mlp": 0, "block_attention": 0, "block_mlp_bwd": 0, "block_attention_bwd": 0,
    "warp_shear3": 0,
}

_lib: ctypes.CDLL | None = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "vtt_error_string": ((_I,), ctypes.c_char_p),
    "vtt_attn_smem_bytes": ((_I, _I), ctypes.c_longlong),
    "vtt_block_mlp_fwd": (
        (_P, _P, _P, _P, _I,  # x, res, out, g, x_bf16
         _P, _I, _P, _I,  # ln scale, ln bias
         _P, _P, _I, _P, _P, _I,  # w1, b1, w2, b2
         _P, _I, _P,  # ls, dp
         _P, _P, _P, _P,  # saves (null for inference): xhat, rstd, h, mlpout
         _I, _I, _I, _I, _F, _P),  # M, T, D, Dh, eps, stream
        _I,
    ),
    "vtt_block_mlp_bwd": (
        (_P, _I, _P, _P, _P, _P,  # dout, x_bf16, xhat, rstd, h, mlpout
         _P, _P, _P, _I, _P, _I, _P,  # w1, w2, ln scale, ls, dp
         _P, _P, _P, _P,  # dx, dh, douts (scratch), dy2 (scratch)
         _P, _P, _P, _P, _P,  # db1, db2, dln scale, dln bias, dls
         _I, _I, _I, _I, _I, _P),  # has_res, M, T, D, Dh, stream
        _I,
    ),
    "vtt_block_attention_fwd": (
        (_P, _P, _P, _P, _P, _P, _I,  # x, out, q, k, v, o, x_bf16
         _P, _I, _P, _I,  # ln scale, ln bias
         _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I,  # wq bq wk bk wv bv wo bo
         _P, _I, _P,  # ls, dp
         _P, _P, _P, _P,  # saves (null for inference): xhat, rstd, p, proj
         _I, _I, _I, _I, _F, _F, _P),  # B, T, D, H, scale, eps, stream
        _I,
    ),
    "vtt_block_attention_bwd": (
        (_P, _I, _P, _P,  # dout, x_bf16, xhat, rstd
         _P, _P, _P, _P, _P,  # q, k, v, p, proj
         _P, _P, _P, _I, _P, _I, _P,  # wo, wqkv, ln scale, ls, dp
         _P, _P, _P, _P, _P, _P,  # dx, dqkv, douts, do, ds, dy (the last four scratch)
         _P, _P, _P, _P, _P,  # dbqkv, dbo, dln scale, dln bias, dls
         _I, _I, _I, _I, _F, _P),  # B, T, D, H, scale, stream
        _I,
    ),
    "vtt_warp_shear3": (
        (_P, _P, _P, _P,  # x, out, flags, coef
         _I, _I, _I, _I, _I, _I, _P),  # B, H, W, C, S, P, stream
        _I,
    ),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        candidates.append(Path(shutil.which("nvcc")))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the kernels")


def library_path() -> Path:
    """Path of the built library, compiling it first if it is missing."""
    out = BUILD_ROOT / _digest() / LIB_NAME
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr[-6000:]}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(library_path()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        _lib = handle
    return _lib


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of a contiguous, 16-byte-aligned CUDA tensor (None → null)."""
    if t is None:
        return None
    if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("kernel operands must be contiguous, 16-byte-aligned CUDA tensors")
    return t.data_ptr()


def vec(t: torch.Tensor | None) -> tuple[int | None, int]:
    """(pointer, is_bf16) of a per-channel parameter vector; f32 or bf16 only."""
    if t is None:
        return None, 0
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"parameter vectors must be float32 or bfloat16, got {t.dtype}")
    if not t.is_cuda or not t.is_contiguous():
        raise ValueError("parameter vectors must be contiguous CUDA tensors")
    return t.data_ptr(), int(t.dtype == torch.bfloat16)


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib().vtt_error_string(err).decode()})")
