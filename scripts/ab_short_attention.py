"""A/B of the short-attention kernels (K2) against other builds of them, on one NVIDIA card.

    python3 scripts/ab_short_attention.py --parent DIR [--variant NAME=DIR ...]

``DIR`` holds another revision's ``short_attention.cu`` and
``short_attention_bwd.cu`` with the headers they include (for an earlier
revision: ``git show <rev>:vision_toolbox_tpu_torch/csrc/<file>`` for those
two, ``short_attention.cuh`` and ``wmma_planes.cuh``); a ``--variant`` is a
copy of this checkout's sources with a tile edited. Each build keeps the C
interface ``vtt_short_attention_fwd(q, k, v, is_bf16, out, B, N, T, S, H,
scale, stream)`` and ``vtt_short_attention_bwd(q, k, v, g, is_bf16, dq, dk,
dv, lse, delta, B, N, T, S, H, scale, stream)`` on packed (B, T, N, H)
operands. Each is compiled with nvcc into a temporary directory and loaded
beside this checkout's kernels, so all run in one process on one card; the
registers and spills ptxas reports for each build's K2 kernels are printed.

At vit_b_16's shape (batch 128, T = S = 197, 12 heads of 64, bf16): the
forward and the forward + backward of each other build and of this
checkout's, in turns (other, this, this, other; CUDA events, mean of each
pair), on the same tensors; the builds' outputs against each other and
against the plain versions; this checkout's second backward bit-equal to
its first; and ``scaled_dot_product_attention`` on the same memory seen as
(B, N, T, H) (the library yardstick; the port never calls it). Prints one
line per timing and one JSON line; writes ``chiprun_out/ab_short_attention.json``.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
B, T, N, H = 128, 197, 12, 64  # vit_b_16 at batch 128: 1536 pairs
ITERS = 20


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ptxas(log: str) -> list[str]:
    """ptxas's registers and spills of the K2 kernels in a build log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(short_(?:fwd|bwd_rows|bwd_keys)_kernel)"
                          r"(?:I(13__nv_bfloat16|f)Li(\d+)E)?", m.group(1))
            entry = None if k is None else k.group(1) + (  # the earlier build: no head class
                f"<{'float' if k.group(2) == 'f' else 'bf16'}, {k.group(3)}>" if k.group(2) else "")
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.split('ptxas info', 1)[-1].strip(' :')}")
    return out


def build(name: str, src: Path) -> tuple[ctypes.CDLL, list[str]]:
    """Another build of the K2 kernels as its own shared library, outside the checkout."""
    from vision_toolbox_tpu_torch.ops import _cuda

    out = Path(tempfile.mkdtemp(prefix=f"k2_{name}_")) / "libk2.so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src / "short_attention.cu"), str(src / "short_attention_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(out))
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vtt_short_attention_fwd.argtypes = [P, P, P, I, P, I, I, I, I, I, Fl, P]
    lib.vtt_short_attention_bwd.argtypes = [P, P, P, P, I, P, P, P, P, P, I, I, I, I, I, Fl, P]
    lib.vtt_short_attention_fwd.restype = lib.vtt_short_attention_bwd.restype = I
    return lib, ptxas(proc.stdout + proc.stderr)


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_short_attention: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.ops import short_attention as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    name_power = card()
    print(f"[card] {name_power}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    this_ptxas = ptxas((_cuda.library_path().parent / "build.log").read_text())
    _cuda.lib()
    report = {"card": name_power, "shape": dict(B=B, T=T, S=T, N=N, H=H, dtype="bfloat16"),
              "this": {"ptxas": this_ptxas}, "others": {}}
    print(f"[ptxas] this: {'; '.join(this_ptxas)}", flush=True)
    others = ([("parent", args.parent)] if args.parent else []) + \
        [tuple(v.split("=", 1)) for v in args.variant]

    g = torch.Generator().manual_seed(10)
    q, k, v, dout = (torch.randn(B, T, N, H, generator=g).to("cuda", torch.bfloat16)
                     for _ in range(4))
    stream = lambda: torch.cuda.current_stream().cuda_stream
    ptrs = lambda *ts: [t.data_ptr() for t in ts]
    want = (sa.short_attention_plain(q, k, v), *sa.short_attention_bwd_plain(q, k, v, dout))

    def this_fb():
        out = sa.short_attention_cuda(q, k, v)
        return (out, *sa.short_attention_bwd_cuda(q, k, v, dout))

    def rel_err(got):
        return {n: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                for n, a, b in zip(("out", "dq", "dk", "dv"), got, want)}

    new = this_fb()
    again = sa.short_attention_bwd_cuda(q, k, v, dout)
    torch.cuda.synchronize()
    report["this"]["error_over_max_plain"] = rel_err(new)
    report["this"]["second_backward_bit_equal"] = all(torch.equal(a, b)
                                                      for a, b in zip(new[1:], again))
    print(f"[ab] this: error / max|plain| {report['this']['error_over_max_plain']}, second "
          f"backward bit-equal {report['this']['second_backward_bit_equal']}", flush=True)

    for name, src in others:
        lib, regs = build(name, Path(src))
        print(f"[ptxas] {name}: {'; '.join(regs)}", flush=True)
        o_out = torch.empty_like(q)
        o_grads = [torch.empty_like(q) for _ in range(3)]
        lse, delta = (torch.empty(B * N * T, device="cuda") for _ in range(2))

        def other_fwd():
            err = lib.vtt_short_attention_fwd(*ptrs(q, k, v), 1, o_out.data_ptr(), B, N, T, T,
                                              H, H**-0.5, stream())
            assert err == 0, err

        def other_fb():
            other_fwd()
            err = lib.vtt_short_attention_bwd(*ptrs(q, k, v, dout), 1, *ptrs(*o_grads, lse, delta),
                                              B, N, T, T, H, H**-0.5, stream())
            assert err == 0, err

        other_fb()
        torch.cuda.synchronize()
        row = {"ptxas": regs, "error_over_max_plain": rel_err((o_out, *o_grads)),
               "max_abs_vs_this": {n: (a.float() - b.float()).abs().max().item()
                                   for n, a, b in zip(("out", "dq", "dk", "dv"),
                                                      (o_out, *o_grads), new)}}
        print(f"[ab] {name}: error / max|plain| {row['error_over_max_plain']}; max abs against "
              f"this {row['max_abs_vs_this']}", flush=True)
        for what, old_fn, new_fn in (
            ("forward", other_fwd, lambda: sa.short_attention_cuda(q, k, v)),
            ("forward+backward", other_fb, this_fb),
        ):
            e1, n1, n2, e2 = time_ms(old_fn), time_ms(new_fn), time_ms(new_fn), time_ms(old_fn)
            row[what] = dict(other_ms=(e1 + e2) / 2, this_ms=(n1 + n2) / 2, runs=[e1, n1, n2, e2])
            print(f"[ab] {name} {what:16s}: {name} {e1:.4f} / {e2:.4f} ms, this {n1:.4f} / "
                  f"{n2:.4f} ms  [{name_power}]", flush=True)
        report["others"][name] = row

    heads = lambda t: t.transpose(1, 2)  # (B, N, T, H), a view of the same memory
    leaves = [heads(t).detach().requires_grad_() for t in (q, k, v)]

    def sdpa_fb():
        torch.autograd.grad(F.scaled_dot_product_attention(*leaves), leaves, heads(dout))

    for what, new_fn, lib_fn in (
        ("forward", lambda: sa.short_attention_cuda(q, k, v),
         lambda: F.scaled_dot_product_attention(*map(heads, (q, k, v)))),
        ("forward+backward", this_fb, sdpa_fb),
    ):
        ms, lib_ms = time_ms(new_fn), time_ms(lib_fn)
        report["this"][what] = dict(ms=ms, library_ms=lib_ms)
        print(f"[ab] this {what:16s}: {ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms  "
              f"[{name_power}]", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_short_attention.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
