"""A/B of the fused half-block kernels (K3, K4) against other builds of them, on one card.

    python3 scripts/ab_block_kernels.py [--parent DIR] [--variant NAME=DIR ...] [--quick | --core]

``DIR`` holds another build's ``gemm.cuh``, ``wgmma.cuh``, ``block_bwd.cuh``,
``attention_mma.cuh``, any other header they include and the four
``block_{mlp,attention}{,_bwd}.cu`` sources. ``--parent`` is an earlier
revision (``git show <rev>:vision_toolbox_tpu_torch/csrc/<file>``) whose K4
saves p, and uses its ds scratch, as (B, H, T, T) with rows of T elements:
its K4 is called through its own C interface with buffers made here (the
partial-row scratch sized by its own ``vtt_block_attention_bwd_partial_floats``),
its K3 through this checkout's wrappers with the library swapped. A
``--variant`` is a copy of this checkout's sources with a tile, stage or
loader choice edited (e.g. ``sed`` on a constant), run through this
checkout's wrappers with the library swapped. Every build is compiled with
nvcc into a temporary directory (all at once), its namespaces renamed
(``-Dvtt=... -Dvtt_mma=...``: in two loaded libraries, symbols of one
mangled name can resolve to one definition) and loaded beside this
checkout's kernels, so all run in one process on one card; ptxas's
registers and spills of each build's K3/K4 kernels are printed, the
attention core's (``attn_*``) apart.

Cases, bf16 unless named: vit_b_16 (T = 197, D = 768, 12 heads, Dh = 3072)
at batch 8 and 128 and at batch 8 in f32; convnext_t's four stages at batch
128 (T = 56², 28², 14², 7²; D = 96, 192, 384, 768; Dh = 4·D; MLP half only,
with γ_ls, drop path and a separate residual, as ConvNeXt calls it);
cait_s_24's MLP half (T = 196, D = 384, Dh = 1536, γ_ls and drop path) at
batch 128; and, attention half only, vit_l_16 (D = 1024, 16 heads, T = 197)
at batch 32 and vit_b_16's widths at T = 512, batch 8. For each: K3's and
K4's inference forward, backward-save forward and backward, each other
build and this checkout's in turns (other, this, this, other; CUDA events,
mean of each pair), on the same tensors; each launch apart (torch.profiler,
device ms per call by kernel name) and the template's TFLOP/s (the
products' operations over the GEMM launches' time); for K4 its attention
core apart (the served and the save forward's core, the backward's rows
and keys passes), its bound, and torch's scaled_dot_product_attention on
the same q, k, v (forward, and backward as forward + backward less the
forward; device ms), the yardstick, used nowhere in the port; outputs
against the plain versions (max abs over max|plain|; reduced gradients,
and for K4 out, p, dx, dq, dk, dv, by rel L2) and against the other
builds; xhat and rstd bit-equal to the parent's; a second backward
bit-equal to the first. At ``CHAIN_CASES`` the same half-block through the
port's module chain (``chip_smoke.time_chains``'s functions), the
yardstick; the port never calls it. ``--quick`` runs vit_b_16 at batch 128
and convnext_t stage 1 only; ``--core`` K4 alone at the four core shapes
(``CORE``). Prints one line per timing and one JSON line; writes
``chiprun_out/ab_block_kernels.json``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("block_mlp.cu", "block_mlp_bwd.cu", "block_attention.cu", "block_attention_bwd.cu")
# label → (B, T, D, Dh, heads or None for the MLP half only, dtype, ConvNeXt/CaiT extras)
CASES = {
    "vit_b_16_b8": (8, 197, 768, 3072, 12, torch.bfloat16, ""),
    "vit_b_16_b128": (128, 197, 768, 3072, 12, torch.bfloat16, ""),
    "vit_b_16_b8_f32": (8, 197, 768, 3072, 12, torch.float32, ""),
    **{f"convnext_t_stage{i + 1}_b128": (128, h * h, d, 4 * d, None, torch.bfloat16,
                                         "ls+dp+residual")
       for i, (h, d) in enumerate(((56, 96), (28, 192), (14, 384), (7, 768)))},
    "cait_s_24_b128": (128, 196, 384, 1536, None, torch.bfloat16, "ls+dp"),
    # the attention half alone (Dh None): vit_l_16 and vit_b_16's widths at T = 512
    "vit_l_16_b32": (32, 197, 1024, None, 16, torch.bfloat16, ""),
    "vit_b_16_t512_b8": (8, 512, 768, None, 12, torch.bfloat16, ""),
}
QUICK = ("vit_b_16_b128", "convnext_t_stage1_b128")
CORE = ("vit_b_16_b128", "vit_b_16_b8", "vit_l_16_b32", "vit_b_16_t512_b8")
PROFILED = 5


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
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
    """Device ms per call of each kernel that ``fn`` launches, by name (the
    template arguments kept, so two GEMM launches of one entry stay apart)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts: dict[str, float] = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = re.sub(r"\(anonymous namespace\)::|vtt\w*::", "", e.name)
        name = re.sub(r"^void |\(.*$", "", name)
        if re.search(r"kernel", name):
            parts[name] += e.time_range.elapsed_us() / 1e3 / calls
    return dict(parts)


def template_tflops(parts: dict[str, float], flops: float) -> float | None:
    gemm_ms = sum(ms for n, ms in parts.items() if "gemm" in n)
    return flops / gemm_ms / 1e9 if gemm_ms else None


def ptxas(log: str) -> list[str]:
    """ptxas's registers and spills of the K3/K4 kernels in a build log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if re.search(r"gemm|ln_|douts|colsum|attn", m.group(1)) else None
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.split('ptxas info', 1)[-1].strip(' :')}")
    return out


def start_build(name: str, src: Path) -> tuple[Path, subprocess.Popen]:
    from vision_toolbox_tpu_torch.ops import _cuda

    work = Path(tempfile.mkdtemp(prefix=f"k34_{name}_"))
    for f in src.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, work / f.name)
    out = work / "libk34.so"
    # a namespace of its own: kernels of one name in two loaded libraries
    # would otherwise resolve to one definition
    tag = re.sub(r"\W", "_", name)
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-Dvtt=vtt_{tag}", f"-Dvtt_mma=vtt_mma_{tag}",
           "-shared", "-o", str(out), *(str(work / s) for s in SOURCES)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load_build(name: str, out: Path, proc: subprocess.Popen):
    from vision_toolbox_tpu_torch.ops import _cuda

    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in _cuda._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
    return lib, ptxas(log)


def ptr(t):
    return None if t is None else t.data_ptr()


def vec(t):
    return (None, 0) if t is None else (t.data_ptr(), int(t.dtype == torch.bfloat16))


def stream():
    return torch.cuda.current_stream().cuda_stream


def parent_attention_calls(lib, a: dict, dout: torch.Tensor):
    """(inference, save-forward, backward, results) of an earlier K4 whose p
    and ds scratch are (B, H, T, T) with rows of T elements, through its C
    interface on the operands ``a``, buffers made here; ``results()``
    returns the last outputs: out, the saves, the backward's tensors."""
    x = a["x"]
    B, T, D = x.shape
    H = a["n_heads"]
    dev, bf = x.device, lambda *s: torch.empty(*s, dtype=torch.bfloat16, device=x.device)
    xb = int(x.dtype == torch.bfloat16)
    ws = [a[f"w{n}"].to(torch.bfloat16).contiguous() for n in "qkvo"]
    wqkv = torch.cat(ws[:3])
    dp = None if a.get("dp_scale") is None else a["dp_scale"].float().contiguous()
    out, y, qkvo = torch.empty_like(x), bf(B, T, D), bf(4, B, T, D)
    xhat, rstd, p = bf(B, T, D), torch.empty(B, T, 1, device=dev), bf(B, H, T, T)
    proj = None if a.get("ls_gamma") is None else bf(B, T, D)
    dx, dqkv = torch.empty_like(x), bf(B, T, 3 * D)
    douts, do, ds, dy = bf(B, T, D), bf(B, T, D), bf(B, H, T, T), \
        torch.empty(B, T, D, device=dev)
    f32 = lambda n: torch.empty(n, device=dev)
    sums = [f32(3 * D), f32(D), f32(D), f32(D), None if proj is None else f32(D)]
    partials = f32(lib.vtt_block_attention_bwd_partial_floats(B, T, D))
    scale = float((D // H) ** -0.5)

    def fwd(save):
        s = (xhat, rstd, p, proj) if save else (None,) * 4
        err = lib.vtt_block_attention_fwd(
            ptr(x), ptr(out), *map(ptr, qkvo), xb, *vec(a["ln_scale"]), *vec(a["ln_bias"]),
            ptr(ws[0]), *vec(a["bq"]), ptr(ws[1]), *vec(a["bk"]), ptr(ws[2]), *vec(a["bv"]),
            ptr(ws[3]), *vec(a["bo"]), *vec(a.get("ls_gamma")), ptr(dp), *map(ptr, s), ptr(y),
            B, T, D, H, scale, 1e-6, stream())
        assert err == 0, err

    def bwd():
        err = lib.vtt_block_attention_bwd(
            ptr(dout), xb, ptr(xhat), ptr(rstd), *map(ptr, qkvo[:3]), ptr(p), ptr(proj),
            ptr(ws[3]), ptr(wqkv), *vec(a["ln_scale"]), *vec(a.get("ls_gamma")), ptr(dp),
            ptr(dx), ptr(dqkv), ptr(douts), ptr(do), ptr(ds), ptr(dy), *map(ptr, sums),
            ptr(partials), partials.numel(), B, T, D, H, scale, stream())
        assert err == 0, err

    def results():
        dq, dk, dv = dqkv.split(D, dim=-1)
        dbq, dbk, dbv = sums[0].split(D)
        return dict(out=out, xhat=xhat, rstd=rstd, q=qkvo[0], k=qkvo[1], v=qkvo[2],
                    o=qkvo[3], p=p, proj=proj, dx=dx, dq=dq, dk=dk, dv=dv, dbq=dbq, dbk=dbk,
                    dbv=dbv, dbo=sums[1], dln_scale=sums[2], dln_bias=sums[3], dls=sums[4])
    return (lambda: fwd(False)), (lambda: fwd(True)), bwd, results


def this_calls(kind: str, a: dict, dout: torch.Tensor):
    """The same four callables through this checkout's wrappers (the library
    they reach is whatever ``_cuda._lib`` holds when they run)."""
    from vision_toolbox_tpu_torch.ops import block_attention as ba
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    state: dict = {}
    if kind == "mlp":
        ops = [a[k] for k in ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2")]
        fargs = (a["x"], *ops, a.get("ls_gamma"), a.get("dp_scale"), a.get("residual"))

        def inference():
            state["out"] = bm.fused_mlp_block_cuda(*fargs, 1e-6)

        def save():
            state["out"], state["saves"] = bm.fused_mlp_save_cuda(*fargs)

        def bwd():
            state["grads"] = bm.fused_mlp_bwd_cuda(
                dout, state["saves"], a["w1"], a["w2"], a["ln_scale"], a.get("ls_gamma"),
                a.get("dp_scale"), a.get("residual") is not None)
    else:
        wb = [a[k] for n in "qkvo" for k in (f"w{n}", f"b{n}")]
        fargs = (a["x"], a["ln_scale"], a["ln_bias"], *wb, a["n_heads"], a.get("ls_gamma"),
                 a.get("dp_scale"))

        def inference():
            state["out"] = ba.fused_attention_block_cuda(*fargs, 1e-6)

        def save():
            state["out"], state["saves"] = ba.fused_attention_save_cuda(*fargs)

        def bwd():
            state["grads"] = ba.fused_attention_bwd_cuda(
                dout, state["saves"], a["wq"], a["wk"], a["wv"], a["wo"], a["ln_scale"],
                a.get("ls_gamma"), a.get("dp_scale"), a["n_heads"])

    def results():
        return dict(out=state["out"], **state["saves"]._asdict(), **state["grads"]._asdict())

    return inference, save, bwd, results


def plain_results(kind: str, a: dict, dout: torch.Tensor, saves) -> dict:
    """The plain versions on the same operands; the backward from ``saves``."""
    from vision_toolbox_tpu_torch.ops import block_attention as ba
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    if kind == "mlp":
        ops = [a[k] for k in ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2")]
        out, sv = bm.fused_mlp_save_plain(a["x"], *ops, a.get("ls_gamma"), a.get("dp_scale"),
                                          a.get("residual"))
        gr = bm.fused_mlp_bwd_plain(dout, saves, a["w1"], a["w2"], a["ln_scale"],
                                    a.get("ls_gamma"), a.get("dp_scale"),
                                    a.get("residual") is not None)
    else:
        wb = [a[k] for n in "qkvo" for k in (f"w{n}", f"b{n}")]
        out, sv = ba.fused_attention_save_plain(a["x"], a["ln_scale"], a["ln_bias"], *wb,
                                                a["n_heads"], a.get("ls_gamma"),
                                                a.get("dp_scale"))
        gr = ba.fused_attention_bwd_plain(dout, saves, a["wq"], a["wk"], a["wv"], a["wo"],
                                          a["ln_scale"], a.get("ls_gamma"), a.get("dp_scale"),
                                          a["n_heads"])
    return dict(out=out, **sv._asdict(), **gr._asdict())


REDUCED = ("db1", "db2", "dbq", "dbk", "dbv", "dbo", "dln_scale", "dln_bias", "dls")


def compare(got: dict, want: dict) -> dict:
    """Elementwise tensors by max abs over max|want|, reduced ones by rel L2."""
    res = {}
    for n, w in want.items():
        if w is None or got.get(n) is None or n in ("g",):
            continue
        a, b = got[n].float(), w.float()
        if n in REDUCED:
            d = (a - b).norm().item()
            res[n] = 0.0 if d == 0 else d / max(b.norm().item(), 1e-30)
        else:
            res[n] = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
    return res


def flops(kind: str, B: int, T: int, D: int, Dh: int) -> float:
    """The products' operations of one call (forward or backward; the
    attention core's q·kᵀ and p·v are not the template's)."""
    M = B * T
    return 4 * M * D * Dh if kind == "mlp" else 8 * M * D * D


def clocks() -> str:
    """The card's SM and memory clocks, temperature and power draw now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
                          "power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def second_run(backward, results) -> tuple[dict, dict]:
    """(first, second): the outputs of two backward calls on one set of saves."""
    backward()
    first = {k: v.clone() for k, v in results().items() if v is not None}
    backward()
    torch.cuda.synchronize()
    return first, results()


BIT_EQUAL = ("dx", "dh", "dq", "dk", "dv", *REDUCED)


CORE_PARTS = {"forward": ("attn_kernel",), "rows": ("attn_bwd_dq", "attn_bwd_rows"),
              "keys": ("attn_bwd_dkv", "attn_bwd_keys")}
CORE_RELS = ("out", "p", "dx", "dq", "dk", "dv")


def core_ms(parts: dict[str, float]) -> dict[str, float]:
    """K4's attention-core launches among ``parts``: device ms of each part."""
    return {k: sum(ms for n, ms in parts.items() if n.startswith(pre))
            for k, pre in CORE_PARTS.items() if any(n.startswith(pre) for n in parts)}


def core_bound(B: int, T: int, D: int, H: int) -> dict[str, float]:
    """The core's least ms (bytes over 3.35 TB/s; its products over 989
    TFLOP/s are below them at every shape here): the served forward reads
    q, k, v and writes o; the save forward also writes p; the backward reads
    do, q, k, v and p and writes dq, dk and dv (the ds round trip, which the
    split into two passes adds, not counted)."""
    qkv, p = B * T * D * 2, B * H * T * T * 2
    return {"forward": 4 * qkv / 3.35e9, "save_forward": (4 * qkv + p) / 3.35e9,
            "backward": (7 * qkv + p) / 3.35e9}


def device_ms(fn, calls: int = PROFILED) -> float:
    """Device ms per call of every kernel ``fn`` launches."""
    return sum(kernel_parts(fn, calls).values())


def sdpa_ms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, H: int) -> dict[str, float]:
    """torch's scaled_dot_product_attention on the (B, T, D) q, k, v as
    (B, H, T, D / H) views: the forward's and the backward's device ms (the
    backward as forward + backward less the forward), the yardstick."""
    import torch.nn.functional as F

    B, T, D = q.shape
    heads = lambda t: t.view(B, T, H, D // H).transpose(1, 2)
    q, k, v = map(heads, (q, k, v))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    go = torch.randn_like(q)
    fwd = lambda: F.scaled_dot_product_attention(q, k, v)
    both = lambda: torch.autograd.grad(F.scaled_dot_product_attention(*leaves), leaves, go)
    f_ms = device_ms(fwd)
    return {"forward": f_ms, "backward": device_ms(both) - f_ms}


def rel_l2s(got: dict, want: dict, names=CORE_RELS) -> dict[str, float]:
    """rel L2 to the plain versions of K4's elementwise outputs."""
    out = {}
    for n in names:
        if got.get(n) is None or want.get(n) is None:
            continue
        a, b = got[n].float(), want[n].float()
        out[n] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    return out


def run_case(label, case, builds, report, name_power, chain, kinds_wanted):
    """One shape: the timings in turns first (other, this, this, other), then
    each launch apart, then the outputs against each other and the plain
    versions."""
    import chip_smoke
    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.ops import block_attention as ba
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    B, T, D, Dh, H, dtype, extras = case
    g = torch.Generator().manual_seed(13)
    kinds = [k for k in (["mlp"] if Dh else []) + (["attention"] if H else [])
             if k in kinds_wanted]
    iters = 5 if B * T > 100_000 else 10 if B >= 32 else 20
    row = {"shape": dict(B=B, T=T, D=D, Dh=Dh, heads=H, dtype=str(dtype).split(".")[-1],
                         extras=extras), "kinds": {}}
    main_lib = _cuda.lib()
    for kind in kinds:
        if kind == "mlp":
            a = chip_smoke.mlp_args(g, B, T, D, Dh, dtype, bool(extras),
                                    extras.endswith("residual"))
        else:
            a = chip_smoke.attn_args(g, B, T, D, H, dtype, bool(extras))
        dout = torch.randn(a["x"].shape, generator=g).to("cuda", dtype)
        name = f"block_{kind}"
        this_fns = this_calls(kind, a, dout)
        others = {}
        for bname, lib, parent in builds:
            if parent and kind == "attention":
                others[bname] = parent_attention_calls(lib, a, dout)
                continue

            def on(fn, lib=lib):  # this checkout's wrappers, the other build's library
                def call():
                    _cuda._lib = lib
                    try:
                        fn()
                    finally:
                        _cuda._lib = main_lib
                return call

            inf, save, bwd, res = this_calls(kind, a, dout)
            others[bname] = (on(inf), on(save), on(bwd), res)
        for fns in (this_fns, *others.values()):
            fns[1]()  # the saves the backward reads
        krow = {"this": {}, "others": {n: {} for n in others}, "clocks": clocks()}
        for bname, ofns in others.items():
            for k, what in enumerate(("forward", "save_forward", "backward")):
                ofn, tfn = ofns[k], this_fns[k]
                e1, n1, n2, e2 = (time_ms(ofn, iters), time_ms(tfn, iters), time_ms(tfn, iters),
                                  time_ms(ofn, iters))
                krow["others"][bname][what] = dict(other_ms=(e1 + e2) / 2, this_ms=(n1 + n2) / 2,
                                                   runs=[e1, n1, n2, e2])
                print(f"[ab] {label} {name} {bname} {what:12s}: {bname} {e1:.4f} / {e2:.4f} ms, "
                      f"this {n1:.4f} / {n2:.4f} ms  [{name_power}]", flush=True)
        if not others:
            for k, what in enumerate(("forward", "save_forward", "backward")):
                krow["this"][what] = dict(ms=time_ms(this_fns[k], iters))
                print(f"[ab] {label} {name} this {what:12s}: {krow['this'][what]['ms']:.4f} ms  "
                      f"[{name_power}]", flush=True)
        krow["clocks_after"] = clocks()
        print(f"[clocks] {label} {name}: before {krow['clocks']}; after {krow['clocks_after']}",
              flush=True)
        fl = flops(kind, B, T, D, Dh)
        for who, fns in (("this", this_fns), *others.items()):
            dest = krow["this"] if who == "this" else krow["others"][who]
            core = {}
            for k, what in enumerate(("forward", "save_forward", "backward")):
                parts = kernel_parts(fns[k])
                dest[f"{what}_parts_ms"] = parts
                dest[f"{what}_template_tflops"] = template_tflops(parts, fl)
                if kind == "attention":
                    core |= {("save_forward" if what == "save_forward" and p == "forward" else p):
                             ms for p, ms in core_ms(parts).items()}
            if kind == "attention":
                dest["core_ms"] = core
                print(f"[core] {label} {who}: served forward {core.get('forward', 0):.4f} ms, "
                      f"save forward {core.get('save_forward', 0):.4f}, rows pass "
                      f"{core.get('rows', 0):.4f}, keys pass {core.get('keys', 0):.4f}  "
                      f"[{name_power}]", flush=True)
        first, second = second_run(this_fns[2], this_fns[3])
        this = krow["this"]
        this["second_backward_bit_equal"] = {
            n: bool(torch.equal(first[n], second[n])) for n in BIT_EQUAL if n in first}
        if kind == "attention":
            krow["core_bound_ms"] = core_bound(B, T, D, H)
            krow["sdpa_ms"] = sdpa_ms(first["q"], first["k"], first["v"], H)
            print(f"[core] {label} bound {krow['core_bound_ms']}, SDPA on the same q, k, v "
                  f"{krow['sdpa_ms']}  [{name_power}]", flush=True)
        saves_t = bm.MLPSaves if kind == "mlp" else ba.AttnSaves
        want = plain_results(kind, a, dout, saves_t(*(first.get(f) for f in saves_t._fields)))
        this["vs_plain"] = compare(first, want)
        if kind == "attention":
            this["rel_l2_vs_plain"] = rel_l2s(first, want)
            print(f"[rel-l2] {label} this: {this['rel_l2_vs_plain']}", flush=True)
        for bname, ofns in others.items():
            ofirst, osecond = second_run(ofns[2], ofns[3])
            orow = krow["others"][bname]
            orow["second_backward_bit_equal"] = all(
                torch.equal(ofirst[n], osecond[n]) for n in ofirst if n in BIT_EQUAL)
            if kind == "attention":  # the plain backward from this build's saves, p its own
                owant = plain_results(kind, a, dout,
                                      saves_t(*(ofirst.get(f) for f in saves_t._fields)))
                orow["vs_plain"] = compare(ofirst, owant)
                orow["rel_l2_vs_plain"] = rel_l2s(ofirst, owant)
                print(f"[rel-l2] {label} {bname}: {orow['rel_l2_vs_plain']}", flush=True)
                del owant
            else:
                orow["vs_plain"] = compare(ofirst, want)
            orow["this_vs_other"] = compare(first, ofirst)
            orow["xhat_rstd_bit_equal"] = bool(torch.equal(first["xhat"], ofirst["xhat"])
                                               and torch.equal(first["rstd"], ofirst["rstd"]))
            del ofirst, osecond
        for who, r in (("this", this), *krow["others"].items()):
            print(f"[ab] {label} {name} {who}: {r}", flush=True)
        krow["chain"] = chain.get((name if D != 96 or kind != "mlp" else "block_mlp_convnext",
                                   B, T, D))
        row["kinds"][name] = krow
        del a, dout, first, second, want, this_fns, others
        torch.cuda.empty_cache()
    report["cases"][label] = row


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_block_kernels: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--quick", action="store_true")
    mode.add_argument("--core", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from vision_toolbox_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    name_power = card()
    print(f"[card] {name_power}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    started = [(name, parent, *start_build(name, Path(src)))
               for name, src, parent in ([("parent", args.parent, True)] if args.parent else [])
               + [(*v.split("=", 1), False) for v in args.variant]]
    _cuda.lib()
    this_ptxas = ptxas((_cuda.library_path().parent / "build.log").read_text())
    report = {"card": name_power, "this": {"ptxas": this_ptxas}, "others": {}, "cases": {}}
    print(f"[ptxas] this: {'; '.join(this_ptxas)}", flush=True)
    print(f"[ptxas-core] this: {'; '.join(r for r in this_ptxas if 'attn' in r)}",
          flush=True)
    builds = []
    for name, parent, out, proc in started:
        try:
            lib, regs = load_build(name, out, proc)
        except RuntimeError as e:  # a variant that does not build is reported, not timed
            if parent:
                raise
            print(f"[build] {name} failed, left out: {str(e)[-2000:]}", flush=True)
            report["others"][name] = {"build_failed": str(e)[-2000:]}
            continue
        report["others"][name] = {"ptxas": regs}
        print(f"[ptxas] {name}: {'; '.join(regs)}", flush=True)
        print(f"[ptxas-core] {name}: {'; '.join(r for r in regs if 'attn' in r)}", flush=True)
        builds.append((name, lib, parent))
    chain_report: dict = {}
    chip_smoke.time_chains(chain_report, name_power)
    chain = {(r["half"], r["B"], r["T"], r["D"]): r for r in chain_report["chain_times"]}
    report["chain"] = chain_report["chain_times"]
    kinds = ("attention",) if args.core else ("mlp", "attention")
    for label, case in CASES.items():
        if args.quick and label not in QUICK or args.core and label not in CORE:
            continue
        if not args.core and case[3] is None:  # the attention-only core shapes
            continue
        run_case(label, case, builds, report, name_power, chain, kinds)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_block_kernels.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
