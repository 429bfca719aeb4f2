"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``vision_toolbox_tpu_torch/csrc/*.cu`` have a plain C
interface. At first use they are compiled with ``nvcc`` for ``sm_90a``, one
process per source, all at once (each one's seconds go to the build log),
linked into one shared library under ``csrc/_build/<hash of sources and
flags>/`` (a directory git ignores) and loaded with ``ctypes``; later calls and later
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
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
LIB_NAME = "libvtt_kernels.so"

LAUNCHES: dict[str, int] = {
    "block_mlp": 0, "block_attention": 0, "block_mlp_bwd": 0, "block_attention_bwd": 0,
    "warp_shear3": 0, "talking_head": 0, "talking_head_bwd": 0, "flash_attention": 0,
    "flash_attention_bwd": 0, "depthwise_conv": 0, "depthwise_conv_bwd": 0,
    "swin_attention": 0, "swin_attention_bwd": 0, "swin_partition": 0, "swin_unpartition": 0,
    "short_attention": 0, "short_attention_bwd": 0,
}

_lib: ctypes.CDLL | None = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "vtt_error_string": ((_I,), ctypes.c_char_p),
    "vtt_block_mlp_bwd_partial_floats": ((_I, _I, _I), ctypes.c_longlong),  # M, D, Dh
    "vtt_block_attention_bwd_partial_floats": ((_I, _I, _I), ctypes.c_longlong),  # B, T, D
    "vtt_block_mlp_fwd": (
        (_P, _P, _P, _P, _I,  # x, res, out, g, x_bf16
         _P, _I, _P, _I,  # ln scale, ln bias
         _P, _P, _I, _P, _P, _I,  # w1, b1, w2, b2
         _P, _I, _P,  # ls, dp
         _P, _P, _P, _P,  # saves (null for inference): xhat, rstd, h, mlpout
         _P,  # y = LN(x)·γ + β (scratch)
         _I, _I, _I, _I, _F, _P),  # M, T, D, Dh, eps, stream
        _I,
    ),
    "vtt_block_mlp_bwd": (
        (_P, _I, _P, _P, _P, _P,  # dout, x_bf16, xhat, rstd, h, mlpout
         _P, _P, _P, _I, _P, _I, _P,  # w1, w2, ln scale, ls, dp
         _P, _P, _P, _P,  # dx, dh, douts (scratch), dy2 (scratch)
         _P, _P, _P, _P, _P,  # db1, db2, dln scale, dln bias, dls
         _P, ctypes.c_longlong,  # column-sum partial rows (scratch), its floats
         _I, _I, _I, _I, _I, _P),  # has_res, M, T, D, Dh, stream
        _I,
    ),
    "vtt_block_attention_fwd": (
        (_P, _P, _P, _P, _P, _P, _I,  # x, out, q, k, v, o, x_bf16
         _P, _I, _P, _I,  # ln scale, ln bias
         _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I,  # wq bq wk bk wv bv wo bo
         _P, _I, _P,  # ls, dp
         _P, _P, _P, _P,  # saves (null for inference): xhat, rstd, p, proj
         _P,  # y = LN(x)·γ + β (scratch)
         _I, _I, _I, _I, _F, _F, _P),  # B, T, D, H, scale, eps, stream
        _I,
    ),
    "vtt_block_attention_bwd": (
        (_P, _I, _P, _P,  # dout, x_bf16, xhat, rstd
         _P, _P, _P, _P, _P,  # q, k, v, p, proj
         _P, _P, _P, _I, _P, _I, _P,  # wo, wqkv, ln scale, ls, dp
         _P, _P, _P, _P, _P, _P,  # dx, dqkv, douts, do, ds, dy (the last four scratch)
         _P, _P, _P, _P, _P,  # dbqkv, dbo, dln scale, dln bias, dls
         _P, ctypes.c_longlong,  # column-sum partial rows (scratch), its floats
         _I, _I, _I, _I, _F, _P),  # B, T, D, H, scale, stream
        _I,
    ),
    "vtt_warp_shear3": (
        (_P, _P, _P, _P,  # x, out, flags, coef
         _I, _I, _I, _I, _I, _I, _P),  # B, H, W, C, S, P, stream
        _I,
    ),
    "vtt_talking_head_fwd_geometry": ((_I, _I, _I, _I, _I, _LL), _I),  # B, T, H, hd, is_bf16,
    # out[6]
    "vtt_talking_head_bwd_geometry": ((_I, _I, _I, _I, _I, _I, _I, _LL), _I),  # B, T, S, H,
    # hd, is_bf16, which (0 rows pass, 1 keys pass), out[5]
    "vtt_talking_head_bwd_floats": ((_I, _I, _I, _I, _I, _I), ctypes.c_longlong),  # B, T, S,
    # H, hd, is_bf16
    "vtt_talking_head_fwd": (
        (_P, _P, _P, _I, _P, _P,  # q, k, v, is_bf16, mix, out
         _I, _I, _I, _I, _I, _F, _P),  # B, T, S, H, hd, scale, stream
        _I,
    ),
    "vtt_talking_head_bwd": (
        (_P, _P, _P, _P, _I, _P,  # q, k, v, dout, is_bf16, mix
         _P, _P, _P, _P, _P,  # dq, dk, dv, the rows' statistics and partial sums (scratch), dmix
         _I, _I, _I, _I, _I, _F, _P),  # B, T, S, H, hd, scale, stream
        _I,
    ),
    "vtt_flash_fwd": (
        (_P, _P, _P, _P, _I, _I,  # q, k, v, bias (or null), bias_bf16, is_bf16
         _P, _P, _LL,  # out, lse (or null), strides of q, k, v, out
         _I, _I, _I, _I, _I, _F, _P),  # B, N, T, S, H, scale, stream
        _I,
    ),
    "vtt_dw_fwd": (
        (_P, _P, _P, _I, _I,  # x, w, y, x_bf16, w_bf16
         _I, _I, _I, _I, _I, _P),  # B, H, W, C, k, stream
        _I,
    ),
    "vtt_dw_partial_floats": ((_I, _I, _I, _I, _I, _I), ctypes.c_longlong),  # B, H, W, C, k,
    # x_bf16
    "vtt_dw_route": ((_P, _P, _I, _I), _I),  # x, g (or null), x_bf16, C
    "vtt_dw_geometry": ((_I, _I, _I, _I, _I, _I, _I, _I, _LL), _I),  # B, H, W, C, k, x_bf16,
    # w_bf16, bwd, out[8]
    "vtt_dw_bwd": (
        (_P, _P, _P, _P, _P, _P, _I, _I,  # x, g, w, dx, dw, partials (scratch), x_bf16, w_bf16
         _I, _I, _I, _I, _I, _P),  # B, H, W, C, k, stream
        _I,
    ),
    "vtt_swin_partition": ((_P, _P, _I, _I, _I, _I, _I, _I, _I, _P), _I),  # x, out, B, H, W,
    "vtt_swin_unpartition": ((_P, _P, _I, _I, _I, _I, _I, _I, _I, _P), _I),  # C, bytes, w, s
    "vtt_swin_attention_route": ((_I, _I, _I, _I, _I, _I, _I), _I),  # T, hd, is_bf16, pe_bf16,
    # masked, mask_bf16, bwd
    "vtt_swin_attention_fwd": (
        (_P, _P, _P, _P, _I, _P, _I, _I, _P,  # q, k, v, pe, pe_bf16, mask, mask_bf16, is_bf16, out
         _I, _I, _I, _I, _I, _I, _F, _P),  # B, nW, T, N, hd, windows per block, scale, stream
        _I,
    ),
    "vtt_swin_attention_bwd": (
        (_P, _P, _P, _P, _P, _I, _P, _I, _I,  # q, k, v, g, pe, pe_bf16, mask, mask_bf16, is_bf16
         _P, _P, _P, _P, _P,  # dq, dk, dv, partials (scratch), dpe
         _I, _I, _I, _I, _I, _I, _F, _P),  # B, nW, T, N, hd, windows per block, scale, stream
        _I,
    ),
    "vtt_short_attention_fwd": (
        (_P, _P, _P, _I, _P,  # q, k, v, is_bf16, out
         _I, _I, _I, _I, _I, _F, _P),  # B, N, T, S, H, scale, stream
        _I,
    ),
    "vtt_short_attention_bwd": (
        (_P, _P, _P, _P, _I,  # q, k, v, g, is_bf16
         _P, _P, _P, _P, _P,  # dq, dk, dv, lse and delta (scratch)
         _I, _I, _I, _I, _I, _F, _P),  # B, N, T, S, H, scale, stream
        _I,
    ),
    "vtt_flash_bwd": (
        (_P, _P, _P, _P, _P, _P, _P, _I,  # q, k, v, out, g, lse, delta (scratch), is_bf16
         _P, _P, _P, _LL,  # dq, dk, dv, strides of q, k, v, out, g, dq, dk, dv
         _I, _I, _I, _I, _I, _F, _P),  # B, N, T, S, H, scale, stream
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
    nvcc, tag = _nvcc(), os.getpid()
    tmp = out.with_name(f"{LIB_NAME}.{tag}.tmp")
    # one nvcc per source, all started together, each timed; then one link
    compiles, t0 = [], time.perf_counter()
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.parent / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        output = obj.with_suffix(".log").open("w+")  # a file: a full pipe would stall nvcc
        compiles.append([cmd, obj, output, subprocess.Popen(cmd, stdout=output,
                                                             stderr=subprocess.STDOUT), None])
    while any(c[4] is None for c in compiles):
        for c in compiles:
            if c[4] is None and c[3].poll() is not None:
                c[4] = time.perf_counter() - t0
        time.sleep(0.05)
    log, errors = [], []
    for cmd, obj, output, proc, seconds in compiles:
        output.seek(0)
        text = output.read()
        output.close()
        obj.with_suffix(".log").unlink()
        log.append(f"{' '.join(cmd)}\n[{Path(cmd[-1]).name}: {seconds:.1f} s]\n{text}")
        if proc.returncode != 0:
            errors.append(f"{cmd[-1]}: exit code {proc.returncode}\n{text[-6000:]}")
    if not errors:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(c[1]) for c in compiles)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            errors.append(f"link: exit code {proc.returncode}\n{proc.stderr[-6000:]}")
    for c in compiles:
        c[1].unlink(missing_ok=True)
    (out.parent / "build.log").write_text("".join(log))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
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


def ptr(t: torch.Tensor | None, align: int = 16) -> int | None:
    """Device pointer of a contiguous CUDA tensor aligned to ``align`` bytes
    (None → null)."""
    if t is None:
        return None
    if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"kernel operands must be contiguous, {align}-byte-aligned CUDA tensors")
    return t.data_ptr()


def strides(*tensors: torch.Tensor):
    """(batch, row, head) element strides of (B, L, N, H) or flat (B·N, L, H)
    CUDA tensors whose last dimension has unit stride (the flat layout as
    N = 1), as the C array a kernel reads them from."""
    out = []
    for t in tensors:
        if not t.is_cuda or (t.shape[-1] > 1 and t.stride(-1) != 1):
            raise ValueError("kernel operands must be CUDA tensors with a unit last stride")
        out += [t.stride(0), t.stride(1), t.stride(2) if t.ndim == 4 else 0]
    return (ctypes.c_longlong * len(out))(*out)


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
