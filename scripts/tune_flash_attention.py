"""Tile-shape variants of the flash-attention kernels (K6), timed side by side on one NVIDIA card.

    python3 scripts/tune_flash_attention.py

Each variant is a copy of this checkout's ``csrc/attention_mma.cuh``,
``flash_attention.cu`` and ``flash_attention_bwd.cu`` with a few constants
replaced (``VARIANTS``), compiled with nvcc into its own library in a
temporary directory (all variants at once) and loaded beside the others,
so every variant runs in one process on one card. Prints each variant's
registers and spills for the bf16 head-64 kernels, then its forward and
backward times in three rounds of turns (CUDA events, 20 launches a
timing) at SigLIP vit_b_16's shape (batch 32, T = S = 1024, 12 heads of
64) and at head 256 (batch 8, 4 heads), bf16, on the packed (B, T, N, H)
layout; each variant's output and gradients are checked against the first
variant's. Writes ``chiprun_out/tune_flash_attention.json``. Needs a CUDA
card.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "vision_toolbox_tpu_torch" / "csrc"
FWD, BWD = "flash_attention.cu", "flash_attention_bwd.cu"
# name → (file, text, replacement) edits of this checkout's sources
VARIANTS = {
    "this checkout": [],
    "forward: 8 warps of 16 rows at head 64 (two blocks an SM)": [
        (FWD, "HD == 64 && !BIAS ? 2 : 1", "HD == 64 && !BIAS ? 1 : 1")],
    "forward: 8 warps of 16 rows, one block an SM": [
        (FWD, "HD == 64 && !BIAS ? 2 : 1", "HD == 64 && !BIAS ? 1 : 1"),
        (FWD, "std::is_same<T, bf16>::value && HD == 64 ? 2 : 1", "1")],
    "forward: three-stage ring": [
        (FWD, "BQ = 128, BK = 64, STAGES = 2", "BQ = 128, BK = 64, STAGES = 3")],
    "backward: one block an SM": [(BWD, "HD == 64 ? 2 : 1;", "HD == 64 ? 1 : 1;")],
    "backward: dQ steps of 32 keys": [(BWD, "KSTEP = 64", "KSTEP = 32")],
}
CASES = ((32, 12, 1024, 64), (8, 4, 1024, 256))
ROUNDS, ITERS = 3, 20


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def build(nvcc: str, flags: tuple[str, ...], tmp: Path) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Every variant's library and its nvcc output, compiled all at once."""
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = tmp / f"v{i}"
        d.mkdir()
        for f in ("attention_mma.cuh", FWD, BWD):
            (d / f).write_text((CSRC / f).read_text())
        for f, old, new in edits:
            text = (d / f).read_text()
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in {f}")
            (d / f).write_text(text.replace(old, new))
        cmd = [nvcc, *flags, "-shared", "-o", str(d / "lib.so"), str(d / FWD), str(d / BWD)]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    LL = ctypes.POINTER(ctypes.c_longlong)
    libs = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.vtt_flash_fwd.argtypes = [P, P, P, P, I, I, P, P, LL, I, I, I, I, I, F, P]
        lib.vtt_flash_bwd.argtypes = [P, P, P, P, P, P, P, I, P, P, P, LL, I, I, I, I, I, F, P]
        lib.vtt_flash_fwd.restype = lib.vtt_flash_bwd.restype = I
        libs[name] = (lib, log)
    return libs


def registers(log: str) -> list[str]:
    """ptxas's registers and spills of the bf16 head-64 kernels."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and "bfloat16Li64E" in entry and ("registers" in line or "spill" in line):
            kernel = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I13__nv_bfloat16Li64E"
                               r"(Lb[01])?", entry)
            out.append(f"{kernel.group(1)}{'<bias>' if kernel.group(2) == 'Lb1' else ''}: "
                       f"{line.split('ptxas info', 1)[-1].strip(' :')}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_flash_attention: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from vision_toolbox_tpu_torch.ops import _cuda

    name_power = card()
    print(f"[card] {name_power}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    libs = build(_cuda._nvcc(), _cuda.NVCC_FLAGS, Path(tempfile.mkdtemp(prefix="k6_tune_")))
    report = {"card": name_power, "variants": {}}
    for name, (_, log) in libs.items():
        regs = registers(log)
        report["variants"][name] = {"ptxas": regs}
        print(f"[ptxas] {name}: {'; '.join(regs)}", flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for B, N, T, H in CASES:
        g = torch.Generator().manual_seed(H)
        q, k, v, dout = (torch.randn(B, T, N, H, generator=g).to("cuda", torch.bfloat16)
                         for _ in range(4))
        out, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        lse, delta = (torch.empty(B * N, T, device="cuda") for _ in range(2))
        fwd_strides = _cuda.strides(q, k, v, out)
        bwd_strides = _cuda.strides(q, k, v, out, dout, dq, dk, dv)

        def fwd(lib):
            err = lib.vtt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, 0, 1,
                                    out.data_ptr(), lse.data_ptr(), fwd_strides, B, N, T, T, H,
                                    H**-0.5, stream())
            assert err == 0, err

        def bwd(lib):
            err = lib.vtt_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), 1,
                                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bwd_strides, B,
                                    N, T, T, H, H**-0.5, stream())
            assert err == 0, err

        times = {name: {"forward": [], "backward": []} for name in libs}
        first = None
        for _ in range(ROUNDS):
            for name, (lib, _) in libs.items():
                fwd(lib)
                bwd(lib)
                torch.cuda.synchronize()
                now = [t.float() for t in (out, dq, dk, dv)]
                if first is None:
                    first = now
                bad = [(a - b).abs().max().item() > 2e-2 * b.abs().max().item()
                       for a, b in zip(now, first)]
                if any(bad):
                    raise AssertionError(f"variant {name!r} disagrees with the first")
                times[name]["forward"].append(time_ms(lambda: fwd(lib)))
                times[name]["backward"].append(time_ms(lambda: bwd(lib)))
        key = f"B={B} N={N} T=S={T} H={H}"
        for name, row in times.items():
            report["variants"][name][key] = row
            print(f"[tune] {key} {name:58s} forward {min(row['forward']):.4f} ms, backward "
                  f"{min(row['backward']):.4f} ms (best of {ROUNDS}; "
                  f"{['%.4f' % t for t in row['forward']]} / "
                  f"{['%.4f' % t for t in row['backward']]})  [{name_power}]", flush=True)
        del q, k, v, dout, out, dq, dk, dv
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "tune_flash_attention.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
