"""A/B of the flash-attention kernels (K6) against an earlier build of them, on one NVIDIA card.

    python3 scripts/ab_flash_attention.py [--parent DIR]

``DIR`` holds an earlier revision's ``flash_attention.cu``,
``flash_attention_bwd.cu`` and ``flash_attention.cuh`` (for example
``git show <rev>:vision_toolbox_tpu_torch/csrc/flash_attention.cu``), whose C
interface takes contiguous (B·N, T, H) operands:
``vtt_flash_fwd(q, k, v, bias, bias_bf16, is_bf16, out, lse, BN, T, S, H,
scale, stream)`` and ``vtt_flash_bwd(q, k, v, out, g, lse, delta, is_bf16,
dq, dk, dv, BN, T, S, H, scale, stream)``. They are compiled with nvcc into
a temporary directory and loaded beside this checkout's kernels, so both
run in one process on one card.

At SigLIP vit_b_16's shape (T = S = 1024, 12 heads of 64, batch 32) and at
head 256 (batch 8, 4 heads), bf16: the forward and the forward + backward
of the earlier kernels and of this checkout's, in turns (earlier, this,
this, earlier; CUDA events, mean of each pair), on the same flat
(B·N, T, H) tensors; then this checkout's kernels on the packed (B, T, N, H)
layout, read in place, beside ``scaled_dot_product_attention`` on the same
memory as a strided (B, N, T, H) view (the library yardstick; the port never
calls it). Also: the two builds' outputs against each other, and a second
backward bit-equal to the first. Prints one line per timing and one JSON
line; writes ``chiprun_out/ab_flash_attention.json``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
CASES = {"siglip_b32_head64": (32, 12, 1024, 64), "head256_b8": (8, 4, 1024, 256)}
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


def build_parent(src: Path) -> ctypes.CDLL:
    """The earlier kernels as their own shared library, built outside the checkout."""
    from vision_toolbox_tpu_torch.ops import _cuda

    out = Path(tempfile.mkdtemp(prefix="k6_parent_")) / "libk6_parent.so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src / "flash_attention.cu"), str(src / "flash_attention_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the earlier kernels:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(out))
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vtt_flash_fwd.argtypes = [P, P, P, P, I, I, P, P, I, I, I, I, Fl, P]
    lib.vtt_flash_bwd.argtypes = [P, P, P, P, P, P, P, I, P, P, P, I, I, I, I, Fl, P]
    lib.vtt_flash_fwd.restype = lib.vtt_flash_bwd.restype = I
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_flash_attention: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    name_power = card()
    print(f"[card] {name_power}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _cuda.lib()
    parent = build_parent(args.parent) if args.parent else None
    stream = lambda: torch.cuda.current_stream().cuda_stream
    report = {"card": name_power, "cases": {}}
    for key, (B, N, T, H) in CASES.items():
        BN, scale = B * N, H**-0.5
        g = torch.Generator().manual_seed(9)
        q, k, v, dout = (torch.randn(BN, T, H, generator=g).to("cuda", torch.bfloat16)
                         for _ in range(4))
        row = {}

        def new_fwd():
            return fa.flash_attention_cuda(q, k, v)

        def new_fb():
            out, lse = fa.flash_attention_cuda(q, k, v)
            return fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)

        if parent is not None:
            p_out, p_lse = torch.empty_like(q), torch.empty(BN, T, 1, device="cuda")
            p_grads = [torch.empty_like(q) for _ in range(3)]
            delta = torch.empty(BN, T, device="cuda")

            def parent_fwd():
                err = parent.vtt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, 0, 1,
                                           p_out.data_ptr(), p_lse.data_ptr(), BN, T, T, H,
                                           scale, stream())
                assert err == 0, err

            def parent_fb():
                parent_fwd()
                err = parent.vtt_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           p_out.data_ptr(), dout.data_ptr(), p_lse.data_ptr(),
                                           delta.data_ptr(), 1, *(t.data_ptr() for t in p_grads),
                                           BN, T, T, H, scale, stream())
                assert err == 0, err

            parent_fb()
            (out, lse), grads = new_fwd(), new_fb()
            torch.cuda.synchronize()
            row["new_vs_earlier_max_abs"] = {
                n: (a.float() - b.float()).abs().max().item()
                for n, a, b in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads),
                                   (p_out, p_lse, *p_grads))}
            for what, old, new in (("forward", parent_fwd, new_fwd),
                                   ("forward+backward", parent_fb, new_fb)):
                e1, n1, n2, e2 = time_ms(old), time_ms(new), time_ms(new), time_ms(old)
                row[what] = dict(earlier_ms=(e1 + e2) / 2, new_ms=(n1 + n2) / 2,
                                 runs=[e1, n1, n2, e2])
                print(f"[ab] {key} {what:16s}: earlier {e1:.4f} / {e2:.4f} ms, this "
                      f"{n1:.4f} / {n2:.4f} ms  [{name_power}]", flush=True)

        # the packed layout in place, and SDPA on the same memory
        qp, kp, vp, gp = (t.view(B, N, T, H).transpose(1, 2).contiguous() for t in (q, k, v, dout))
        as_bnth = lambda t: t.transpose(1, 2)  # (B, T, N, H) memory as a strided (B, N, T, H)
        leaves = [as_bnth(t).detach().requires_grad_() for t in (qp, kp, vp)]

        def packed_fb():
            out, lse = fa.flash_attention_cuda(qp, kp, vp)
            return fa.flash_attention_bwd_cuda(qp, kp, vp, out, lse, gp)

        def sdpa_fb():
            torch.autograd.grad(F.scaled_dot_product_attention(*leaves), leaves, as_bnth(gp))

        first, second = packed_fb(), packed_fb()
        torch.cuda.synchronize()
        row["second_backward_bit_equal"] = all(torch.equal(a, b) for a, b in zip(first, second))
        flat_out = fa.flash_attention_cuda(q, k, v)[0]
        packed_out = fa.flash_attention_cuda(qp, kp, vp)[0]
        row["packed_equals_flat"] = torch.equal(packed_out,
                                                flat_out.view(B, N, T, H).transpose(1, 2))
        for what, new, lib in (
            ("packed forward", lambda: fa.flash_attention_cuda(qp, kp, vp, with_lse=False),
             lambda: F.scaled_dot_product_attention(*(as_bnth(t) for t in (qp, kp, vp)))),
            ("packed forward+backward", packed_fb, sdpa_fb),
        ):
            ms, lib_ms = time_ms(new), time_ms(lib)
            row[what] = dict(ms=ms, library_ms=lib_ms)
            print(f"[ab] {key} {what:23s}: this {ms:.4f} ms, scaled_dot_product_attention "
                  f"{lib_ms:.4f} ms  [{name_power}]", flush=True)
        print(f"[ab] {key}: second backward bit-equal {row['second_backward_bit_equal']}, packed "
              f"output equals flat {row['packed_equals_flat']}", flush=True)
        report["cases"][key] = row
        del q, k, v, dout, qp, kp, vp, gp, leaves
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_flash_attention.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
