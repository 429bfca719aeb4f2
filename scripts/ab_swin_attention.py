"""A/B of the window-attention kernels (K7) against other builds of them, on one NVIDIA card.

    python3 scripts/ab_swin_attention.py --parent DIR [--variant NAME=DIR ...]

``DIR`` holds another build's ``swin_attention.cu`` and
``swin_attention_bwd.cu`` with the headers they include. ``--parent`` is the
revision before the register-tile redesign (``git show <rev>:vision_toolbox_
tpu_torch/csrc/<file>`` for those two, ``swin_attention.cuh`` and
``wmma_planes.cuh``), whose blocks take a run of the flattened B·nW windows of
one head (its ``windows_per_block`` is copied below); a ``--variant`` is a copy
of this checkout's sources (with ``attention_mma.cuh``) with a tile edited,
on this checkout's block mapping. Every build keeps the C interface
``vtt_swin_attention_fwd(q, k, v, pe, pe_bf16, mask, mask_bf16, is_bf16, out,
B, nW, T, N, hd, per_block, scale, stream)`` and ``vtt_swin_attention_bwd(q,
k, v, g, pe, pe_bf16, mask, mask_bf16, is_bf16, dq, dk, dv, partials, dpe, B,
nW, T, N, hd, per_block, scale, stream)``. Each is compiled with nvcc into a
temporary directory and loaded beside this checkout's kernels, so all run in
one process on one card; the registers and spills ptxas reports for each
build's K7 kernels are printed.

Four cases: swin_t stage 1 at batch 128 ((B, nW, T, N, hd) = (128, 64, 49,
3, 32), the shift mask) and window 14 (swin_s3_t stage 3 at batch 128: (128,
1, 196, 12, 32), no mask), each in bf16 (the register tiles) and in f32 (the
CUDA-core kernels). For each: the forward and the forward +
backward of each other build and of this checkout's, in turns (other, this,
this, other; CUDA events, mean of each pair), on the same tensors; the
builds' outputs against each other and against the plain versions; this
checkout's second backward bit-equal to its first; and
``scaled_dot_product_attention`` on (B, nW·N, T, hd) with pe + mask summed
once, outside the timing, into one bf16 ``attn_mask`` (the library
yardstick; the port never calls it). Prints one line per timing and one JSON
line; writes ``chiprun_out/ab_swin_attention.json``. Needs a CUDA card.
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
CASES = {f"{name}{suffix}": (*shape, dtype)
         for name, shape in (("swin_t_stage1", (128, 64, 49, 3, 32, True)),
                             ("window14", (128, 1, 196, 12, 32, False)))
         for suffix, dtype in (("", torch.bfloat16), ("_f32", torch.float32))}
ITERS = 10


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


def parent_windows_per_block(n_windows: int, n_heads: int) -> int:
    """The parent's block mapping (its ops/swin_attention.py): windows of the
    flattened B·nW axis a block of one head takes, 132 × 8 blocks in all."""
    blocks = max(1, min(n_windows, -(-(132 * 8) // n_heads)))
    return -(-n_windows // blocks)


def ptxas(log: str) -> list[str]:
    """ptxas's registers and spills of the K7 kernels in a build log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(swin_(?:fwd|bwd)\w*_kernel)(I\w+?E)?(?:v|P)", m.group(1))
            entry = None if k is None else k.group(1) + (k.group(2) or "")
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.split('ptxas info', 1)[-1].strip(' :')}")
    return out


def build(name: str, src: Path) -> tuple[ctypes.CDLL, list[str]]:
    """Another build of the K7 kernels as its own shared library, outside the checkout."""
    from vision_toolbox_tpu_torch.ops import _cuda

    out = Path(tempfile.mkdtemp(prefix=f"k7_{name}_")) / "libk7.so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src / "swin_attention.cu"), str(src / "swin_attention_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(out))
    fwd_args, bwd_args = _cuda._SIGNATURES["vtt_swin_attention_fwd"][0], \
        _cuda._SIGNATURES["vtt_swin_attention_bwd"][0]
    lib.vtt_swin_attention_fwd.argtypes = list(fwd_args)
    lib.vtt_swin_attention_bwd.argtypes = list(bwd_args)
    lib.vtt_swin_attention_fwd.restype = lib.vtt_swin_attention_bwd.restype = ctypes.c_int
    return lib, ptxas(proc.stdout + proc.stderr)


def run_case(label, case, others, report, name_power):
    from vision_toolbox_tpu_torch.ops import swin_attention as sa

    B, nW, T, N, hd, masked, dtype = case
    g = torch.Generator().manual_seed(11)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to("cuda", dtype)
    q, k, v, dout = (r(B, nW, T, N * hd) for _ in range(4))
    pe = r(1, N, T, T, scale=0.5)
    mask = None
    if masked:
        mask = ((torch.rand(nW, T, T, generator=g) < 0.3).float() * -100.0).to("cuda", dtype)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    want = (sa.swin_attention_plain(q, k, v, pe, mask, N),
            *sa.swin_attention_bwd_plain(q, k, v, pe, mask, N, dout))
    names = ("out", "dq", "dk", "dv", "dpe")

    def this_fb():
        return (sa.swin_attention_cuda(q, k, v, pe, mask, N),
                *sa.swin_attention_bwd_cuda(q, k, v, pe, mask, N, dout))

    def rel_err(got):
        return {n: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                for n, a, b in zip(names, got, want)}

    new = this_fb()
    again = sa.swin_attention_bwd_cuda(q, k, v, pe, mask, N, dout)
    torch.cuda.synchronize()
    row = {"shape": dict(B=B, nW=nW, T=T, N=N, hd=hd, masked=masked,
                         dtype=str(dtype).split(".")[-1]),
           "this": {"error_over_max_plain": rel_err(new),
                    "second_backward_bit_equal": all(torch.equal(a, b)
                                                     for a, b in zip(new[1:], again))},
           "others": {}}
    print(f"[ab] {label} this: error / max|plain| {row['this']['error_over_max_plain']}, second "
          f"backward bit-equal {row['this']['second_backward_bit_equal']}", flush=True)

    bf16 = int(dtype == torch.bfloat16)
    for name, lib, per_fwd, per_bwd, blocks in others(q, pe, mask, N):
        o_out = torch.empty_like(q)
        o_grads = [torch.empty_like(q) for _ in range(3)]
        partials = torch.empty(blocks, N, T, T, device="cuda")
        o_dpe = torch.empty(1, N, T, T, device="cuda")
        bias_args = (ptr(pe), bf16, ptr(mask), bf16 * int(mask is not None), bf16)

        def other_fwd():
            err = lib.vtt_swin_attention_fwd(ptr(q), ptr(k), ptr(v), *bias_args, ptr(o_out),
                                             B, nW, T, N, hd, per_fwd, hd**-0.5, stream())
            assert err == 0, err

        def other_fb():
            other_fwd()
            err = lib.vtt_swin_attention_bwd(ptr(q), ptr(k), ptr(v), ptr(dout), *bias_args,
                                             *map(ptr, o_grads), ptr(partials), ptr(o_dpe),
                                             B, nW, T, N, hd, per_bwd, hd**-0.5, stream())
            assert err == 0, err

        other_fb()
        torch.cuda.synchronize()
        got = (o_out, *o_grads, o_dpe)
        orow = {"per_block": [per_fwd, per_bwd], "error_over_max_plain": rel_err(got),
                "max_abs_vs_this": {n: (a.float() - b.float()).abs().max().item()
                                    for n, a, b in zip(names, got, new)}}
        print(f"[ab] {label} {name}: error / max|plain| {orow['error_over_max_plain']}; max abs "
              f"against this {orow['max_abs_vs_this']}", flush=True)
        for what, old_fn, new_fn in (
            ("forward", other_fwd, lambda: sa.swin_attention_cuda(q, k, v, pe, mask, N)),
            ("forward+backward", other_fb, this_fb),
        ):
            e1, n1, n2, e2 = time_ms(old_fn), time_ms(new_fn), time_ms(new_fn), time_ms(old_fn)
            orow[what] = dict(other_ms=(e1 + e2) / 2, this_ms=(n1 + n2) / 2, runs=[e1, n1, n2, e2])
            print(f"[ab] {label} {name} {what:16s}: {name} {e1:.4f} / {e2:.4f} ms, this "
                  f"{n1:.4f} / {n2:.4f} ms  [{name_power}]", flush=True)
        row["others"][name] = orow
        del partials

    heads = lambda t: t.view(B, nW, T, N, hd).transpose(2, 3).reshape(B, nW * N, T, hd)
    sq, sk, sv, sg = map(heads, (q, k, v, dout))
    bias = pe.float()[None] + (0.0 if mask is None else mask.float()[None, :, None])
    bias = bias.expand(1, nW, N, T, T).to(dtype).reshape(1, nW * N, T, T)
    leaves = [t.detach().requires_grad_() for t in (sq, sk, sv)]

    def sdpa_fb():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
        torch.autograd.grad(out, leaves, sg)

    for what, new_fn, lib_fn in (
        ("forward", lambda: sa.swin_attention_cuda(q, k, v, pe, mask, N),
         lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=bias)),
        ("forward+backward", this_fb, sdpa_fb),
    ):
        ms, lib_ms = time_ms(new_fn), time_ms(lib_fn)
        row["this"][what] = dict(ms=ms, library_ms=lib_ms)
        print(f"[ab] {label} this {what:16s}: {ms:.4f} ms, scaled_dot_product_attention "
              f"{lib_ms:.4f} ms  [{name_power}]", flush=True)
    report["cases"][label] = row


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_swin_attention: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.ops import swin_attention as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    name_power = card()
    print(f"[card] {name_power}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    this_ptxas = ptxas((_cuda.library_path().parent / "build.log").read_text())
    _cuda.lib()
    report = {"card": name_power, "this": {"ptxas": this_ptxas}, "others": {}, "cases": {}}
    print(f"[ptxas] this: {'; '.join(this_ptxas)}", flush=True)
    builds = []
    for name, src, parent in ([("parent", args.parent, True)] if args.parent else []) + \
            [(*v.split("=", 1), False) for v in args.variant]:
        lib, regs = build(name, Path(src))
        report["others"][name] = {"ptxas": regs}
        print(f"[ptxas] {name}: {'; '.join(regs)}", flush=True)
        builds.append((name, lib, parent))

    def others(q, pe, mask, N):
        """Each build with its images (the parent: windows) a block, forward
        and backward, and its backward's blocks of one head; a variant on this
        checkout's launch rule."""
        B, nW = q.shape[:2]
        for name, lib, parent in builds:
            if parent:
                per = parent_windows_per_block(B * nW, N)
                yield name, lib, per, per, -(-(B * nW) // per)
            else:
                fwd, bwd = (sa.windows_per_block(B, nW, N, sa.kernel_route(q, pe, mask, N, b))
                            for b in (False, True))
                yield name, lib, fwd, bwd, nW * -(-B // bwd)

    for label, case in CASES.items():
        run_case(label, case, others, report, name_power)
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_swin_attention.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
