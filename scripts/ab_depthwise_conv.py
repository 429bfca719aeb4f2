"""A/B of the depthwise-conv kernels (K9) against other builds of them, on one NVIDIA card.

    python3 scripts/ab_depthwise_conv.py [--parent DIR] [--variant NAME=DIR ...] [--case NAME ...]

``DIR`` holds another build's ``depthwise_conv.cu``, ``depthwise_conv_bwd.cu``
and ``depthwise_conv.cuh``. ``--parent`` is the first design (``git show
<rev>:vision_toolbox_tpu_torch/csrc/<file>`` of those three at a revision
before the redesign), whose C interface sizes the dw scratch from the shape
alone (``vtt_dw_partial_floats(B, H, W, C, k)``); a ``--variant`` is a copy of
this checkout's three sources with a tile or a rule edited (e.g. ``sed`` on a
constant of ``depthwise_conv.cuh`` such as ``MIN_BLOCKS``), on this checkout's interface
(``vtt_dw_partial_floats(B, H, W, C, k, x_bf16)``). Both keep
``vtt_dw_fwd(x, w, y, x_bf16, w_bf16, B, H, W, C, k, stream)`` and
``vtt_dw_bwd(x, g, w, dx, dw, partials, x_bf16, w_bf16, B, H, W, C, k,
stream)``. Each is compiled with nvcc into a temporary directory (all
builds at once) and loaded beside this checkout's kernels, so all run in one
process on one card; the registers and spills ptxas reports for each build's
K9 kernels are printed.

Cases (all, or those named by ``--case``): convnext_t's four stage shapes
at batch 128 in bf16 ((H = W, C) = (56, 96), (28, 192), (14, 384), (7,
768), k = 7), stage 1 in f32, and patchconvnet_s's trunk (14 × 14 × 384,
k = 3, batch 128, bf16). For each: the forward and the forward + backward of each other build and of this
checkout's, in turns (other, this, this, other; CUDA events, mean of each
pair), on the same tensors; the backward's kernels apart (torch.profiler,
device time per call of each kernel by name: the dx pass, the dw partials,
their sum); every build's out and dx against the plain versions (the count of
differing elements; 0 in bf16, where both round the same f32 sum once) and
its dw by rel L2; each build's second backward bit-equal to its first; and
cuDNN's grouped conv on the same memory (``F.conv2d(groups=C)`` on the
channels_last view; its backward = forward + backward less the forward), the
library yardstick that the port never calls, each timed with CUDA events and,
apart from the host's launch cost, as device time per call (torch.profiler,
every kernel the call runs). Prints one line per timing and
one JSON line; writes ``chiprun_out/ab_depthwise_conv.json``. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import collections
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
BATCH = 128
CASES = {f"stage{i + 1}": (BATCH, h, h, c, 7, torch.bfloat16)
         for i, (h, c) in enumerate(((56, 96), (28, 192), (14, 384), (7, 768)))}
CASES["stage1_f32"] = (BATCH, 56, 56, 96, 7, torch.float32)
CASES["patchconvnet_s"] = (BATCH, 14, 14, 384, 3, torch.bfloat16)
ITERS = 20
PROFILED = 10


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


def kernel_parts(fn, calls: int = PROFILED) -> dict[str, float]:
    """Device ms per call of each K9 kernel that ``fn`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts: dict[str, float] = collections.defaultdict(float)
    for e in prof.events():
        m = re.search(r"(dw_\w+?_kernel)", e.name)
        if m and e.device_type == torch.autograd.DeviceType.CUDA:
            parts[m.group(1)] += e.time_range.elapsed_us() / 1e3 / calls
    return dict(parts)


def device_ms(fn, calls: int = PROFILED) -> float:
    """Device ms per call of all the kernels ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3 / calls


def ptxas(log: str) -> list[str]:
    """ptxas's registers and spills of the K9 kernels in a build log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(dw_\w+?_kernel)(I\w+?E)?", m.group(1))
            entry = None if k is None else k.group(1) + (k.group(2) or "")
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.split('ptxas info', 1)[-1].strip(' :')}")
    return out


def start_build(name: str, src: Path) -> tuple[Path, subprocess.Popen]:
    """Start nvcc on another build of the K9 kernels, a shared library outside the checkout."""
    from vision_toolbox_tpu_torch.ops import _cuda

    out = Path(tempfile.mkdtemp(prefix=f"k9_{name}_")) / "libk9.so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src / "depthwise_conv.cu"), str(src / "depthwise_conv_bwd.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load_build(name: str, out: Path, proc: subprocess.Popen) -> tuple[ctypes.CDLL, list[str]]:
    """Wait for a build started by start_build; load it and read its ptxas lines."""
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vtt_dw_fwd.argtypes = [P, P, P, I, I, I, I, I, I, I, P]
    lib.vtt_dw_bwd.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, P]
    lib.vtt_dw_fwd.restype = lib.vtt_dw_bwd.restype = I
    lib.vtt_dw_partial_floats.restype = ctypes.c_longlong
    return lib, ptxas(log)


def other_calls(lib, parent: bool, x, w, g):
    """(forward, backward, outputs) of another build on x, w, g: its
    launches through its own C interface, into buffers made here."""
    B, H, W, C = x.shape
    k = w.shape[0]
    xb, wb = int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16)
    shape = (B, H, W, C, k) if parent else (B, H, W, C, k, xb)
    lib.vtt_dw_partial_floats.argtypes = [ctypes.c_int] * len(shape)
    partials = torch.empty(lib.vtt_dw_partial_floats(*shape), dtype=torch.float32, device="cuda")
    y, dx, dw = torch.empty_like(x), torch.empty_like(x), torch.empty_like(w)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def fwd():
        err = lib.vtt_dw_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), xb, wb, B, H, W, C, k,
                             stream())
        assert err == 0, err

    def bwd():
        err = lib.vtt_dw_bwd(x.data_ptr(), g.data_ptr(), w.data_ptr(), dx.data_ptr(),
                             dw.data_ptr(), partials.data_ptr(), xb, wb, B, H, W, C, k, stream())
        assert err == 0, err

    return fwd, bwd, (y, dx, dw)


def run_case(label, case, builds, report, name_power):
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    B, H, W, C, k, dtype = case
    g = torch.Generator().manual_seed(12)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to("cuda", dtype)
    x, w, dout = r(B, H, W, C), r(k, k, 1, C, scale=0.2), r(B, H, W, C)
    want = (dc.depthwise_conv2d_plain(x, w), *dc.depthwise_conv2d_bwd_plain(x, w, dout))
    torch.cuda.synchronize()

    def check(got, again):
        """out and dx against the plain versions (differing elements, max
        abs error over max|plain|), dw by rel L2, and a second backward."""
        res = {}
        for n, a, b in zip(("out", "dx"), got[:2], want[:2]):
            res[n] = dict(differing=int((a != b).sum().item()),
                          error_over_max_plain=((a.float() - b.float()).abs().max()
                                                / b.float().abs().max()).item())
        res["dw_rel_l2"] = ((got[2].float() - want[2].float()).norm()
                            / want[2].float().norm()).item()
        res["second_backward_bit_equal"] = all(torch.equal(a, b)
                                               for a, b in zip(got[1:], again))
        return res

    this_fwd = lambda: dc.depthwise_conv2d_cuda(x, w)
    this_bwd = lambda: dc.depthwise_conv2d_bwd_cuda(x, w, dout)

    def this_fb():
        this_fwd()
        this_bwd()

    got = (this_fwd(), *this_bwd())
    again = this_bwd()
    torch.cuda.synchronize()
    row = {"shape": dict(B=B, H=H, W=W, C=C, k=k, dtype=str(dtype).split(".")[-1]),
           "this": check(got, again), "others": {}}
    row["this"]["route"] = dc.kernel_route(x, dout)
    row["this"]["backward_parts_ms"] = kernel_parts(this_bwd)
    print(f"[ab] {label} this: {row['this']}  [{name_power}]", flush=True)

    for name, lib, parent in builds:
        fwd, bwd, outs = other_calls(lib, parent, x, w, dout)
        fwd()
        bwd()
        first = tuple(t.clone() for t in outs)
        bwd()
        torch.cuda.synchronize()
        orow = check(first, outs[1:])
        orow["max_abs_vs_this"] = {n: (a.float() - b.float()).abs().max().item()
                                   for n, a, b in zip(("out", "dx", "dw"), first, got)}
        orow["backward_parts_ms"] = kernel_parts(bwd)

        def other_fb():
            fwd()
            bwd()

        for what, old_fn, new_fn in (("forward", fwd, this_fwd),
                                     ("forward+backward", other_fb, this_fb)):
            e1, n1, n2, e2 = time_ms(old_fn), time_ms(new_fn), time_ms(new_fn), time_ms(old_fn)
            orow[what] = dict(other_ms=(e1 + e2) / 2, this_ms=(n1 + n2) / 2, runs=[e1, n1, n2, e2])
            print(f"[ab] {label} {name} {what:16s}: {name} {e1:.4f} / {e2:.4f} ms, this "
                  f"{n1:.4f} / {n2:.4f} ms  [{name_power}]", flush=True)
        print(f"[ab] {label} {name}: {orow}", flush=True)
        row["others"][name] = orow

    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)  # (C, 1, k, k)
    conv = lambda t, wt: F.conv2d(t.permute(0, 3, 1, 2), wt, padding=k // 2, groups=C)
    xl, wl = x.detach().clone().requires_grad_(), wc.detach().clone().requires_grad_()

    def library_fb():
        with torch.enable_grad():
            out = conv(xl, wl)
            torch.autograd.grad(out, (xl, wl), dout.permute(0, 3, 1, 2))

    calls = {"forward": (this_fwd, lambda: conv(x, wc)), "forward+backward": (this_fb, library_fb)}
    for what, (kernel, library) in calls.items():
        r = dict(ms=time_ms(kernel), library_ms=time_ms(library), device_ms=device_ms(kernel),
                 library_device_ms=device_ms(library))
        row["this"][what] = r
        print(f"[ab] {label} this {what:16s}: {r['ms']:.4f} ms, cuDNN grouped conv "
              f"{r['library_ms']:.4f} ms (CUDA events); device time {r['device_ms']:.4f} ms, "
              f"cuDNN {r['library_device_ms']:.4f} ms (torch.profiler)  [{name_power}]",
              flush=True)
    report["cases"][label] = row


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_depthwise_conv: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    parser.add_argument("--case", action="append", default=[], choices=sorted(CASES))
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from vision_toolbox_tpu_torch.ops import _cuda

    torch.backends.cudnn.allow_tf32 = False
    name_power = card()
    print(f"[card] {name_power}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _cuda.lib()
    this_ptxas = ptxas((_cuda.library_path().parent / "build.log").read_text())
    report = {"card": name_power, "this": {"ptxas": this_ptxas}, "others": {}, "cases": {}}
    print(f"[ptxas] this: {'; '.join(this_ptxas)}", flush=True)
    started = [(name, parent, *start_build(name, Path(src)))
               for name, src, parent in ([("parent", args.parent, True)] if args.parent else [])
               + [(*v.split("=", 1), False) for v in args.variant]]
    builds = []
    for name, parent, out, proc in started:
        lib, regs = load_build(name, out, proc)
        report["others"][name] = {"ptxas": regs}
        print(f"[ptxas] {name}: {'; '.join(regs)}", flush=True)
        builds.append((name, lib, parent))
    for label in args.case or CASES:
        run_case(label, CASES[label], builds, report, name_power)
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_depthwise_conv.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
