"""A/B of the talking-head attention kernels (K5) against other builds of them, on one card.

    python3 scripts/ab_talking_head.py [--parent DIR] [--variant NAME=DIR ...] [--quick]

``DIR`` holds another build's ``talking_head.cu``, ``talking_head_bwd.cu``
and the headers they include. ``--parent`` is the first design
(``git show <rev>:vision_toolbox_tpu_torch/csrc/<file>`` of
``talking_head{.cu,_bwd.cu,.cuh}`` at a revision before the tensor-core
redesign), called through its own C interface: the backward's (B, H, T, S)
f32 scratch for pw and draw and its partial sums are allocated here, as
its wrapper did. A ``--variant`` is a copy of this checkout's sources (or,
to time a phase apart, of whatever build the checkout holds) with a
constant or a call edited by ``sed``, run through this checkout's wrappers
with the library swapped. Every build is compiled with nvcc into a
temporary directory (all at once), its namespaces renamed (``-Dvtt_th=...
-Dvtt_mma=...``: in two loaded libraries, symbols of one mangled name can
resolve to one definition) and loaded beside this checkout's kernels, so
all run in one process on one card; ptxas's registers and spills of each
build's K5 kernels are printed.

Cases (B, T, S, heads, head width), bf16 unless named: cait_s_24 (8 heads
of 48, T = S = 196) at batch 8 and 128, cait_xxs_24 (4 heads) at 128,
cait_m_36 (16 heads) at 32, cait_s_24 at batch 8 in f32, and the JAX rule's
corner (64, 512, 16, 48) at batch 8. For each: the forward and the backward
of each other build and this checkout's in turns (other, this, this, other;
CUDA events, mean of each pair), on the same tensors, every build timed
before any plain version runs; each launch apart (torch.profiler, device ms
per call by kernel name); outputs against the plain versions (max abs over
max|plain| and rel L2; the mix gradients by rel L2, the pre-softmax bias's
against ‖dml‖) and against the other builds; this checkout's second
backward bit-equal to its first. ``--quick`` runs cait_s_24 at batch 128
and cait_m_36 only. Prints one line per timing and one JSON line; writes
``chiprun_out/ab_talking_head.json``. Needs a CUDA card.
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
SOURCES = ("talking_head.cu", "talking_head_bwd.cu")
# label → (B, T, S, heads, head width, dtype)
CASES = {
    "cait_s_24_b8": (8, 196, 196, 8, 48, torch.bfloat16),
    "cait_s_24_b128": (128, 196, 196, 8, 48, torch.bfloat16),
    "cait_xxs_24_b128": (128, 196, 196, 4, 48, torch.bfloat16),
    "cait_m_36_b32": (32, 196, 196, 16, 48, torch.bfloat16),
    "cait_s_24_b8_f32": (8, 196, 196, 8, 48, torch.float32),
    "corner_64x512_b8": (8, 64, 512, 16, 48, torch.bfloat16),
}
QUICK = ("cait_s_24_b128", "cait_m_36_b32")
PROFILED = 5


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def clocks() -> str:
    """The card's SM and memory clocks, temperature and power draw now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
                          "power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


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
    template arguments kept)."""
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
        parts[name] += e.time_range.elapsed_us() / 1e3 / calls
    return dict(parts)


def ptxas(log: str) -> list[str]:
    """ptxas's registers and spills of the K5 kernels in a build log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if re.search(r"th_", m.group(1)) else None
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.split('ptxas info', 1)[-1].strip(' :')}")
    return out


def start_build(name: str, src: Path) -> tuple[Path, subprocess.Popen]:
    from vision_toolbox_tpu_torch.ops import _cuda

    work = Path(tempfile.mkdtemp(prefix=f"k5_{name}_"))
    for f in src.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, work / f.name)
    out = work / "libk5.so"
    tag = re.sub(r"\W", "_", name)
    # namespaces of its own: kernels of one name in two loaded libraries
    # would otherwise resolve to one definition
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-Dvtt_th=vtt_th_{tag}", f"-Dvtt_mma=vtt_mma_{tag}",
           "-shared", "-o", str(out), *(str(work / s) for s in SOURCES)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the first design's C interface: the backward takes pw and draw, (B, H, T,
# S) f32 each, and the partial sums of its row blocks as scratch
PARENT_SIGNATURES = {
    "vtt_talking_head_rows": ((I, I, I, I), I),
    "vtt_talking_head_fwd": ((P, P, P, I, P, P, I, I, I, I, I, F, P), I),
    "vtt_talking_head_bwd": ((P, P, P, P, I, P, P, P, P, P, P, P, P, I, I, I, I, I, F, P), I),
}


def load_build(name: str, out: Path, proc: subprocess.Popen, parent: bool):
    from vision_toolbox_tpu_torch.ops import _cuda

    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
    lib = ctypes.CDLL(str(out))
    sigs = PARENT_SIGNATURES if parent else {
        k: v for k, v in _cuda._SIGNATURES.items() if hasattr(lib, k)}
    for fn, (argtypes, restype) in sigs.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = restype
    return lib, ptxas(log)


def make_args(g, B, T, S, H, hd, dtype):
    """q, k, v (cait's packed layout), f32 mixes near the identity with
    small biases, and a cotangent; chip_smoke's draws."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    a, dout = chip_smoke.talking_head_args(g, B, T, S, H, hd, dtype)
    return tuple(a.values()), dout


def parent_calls(lib, args, dout):
    """(forward, backward, results) of the first design on ``args``: its C
    interface, its scratch made here. ``results()`` returns the last
    outputs."""
    from vision_toolbox_tpu_torch.ops import cait_attention as ca

    q, k, v, ml, mlb, mw, mwb = args
    n = ml.shape[0]
    B, T, D = q.shape
    S, hd = k.shape[1], D // n
    hdp = ca.padded_head(hd)
    qp, kp, vp, dp = (ca._pad_heads(t, n) for t in (q, k, v, dout))
    mix = ca._mix_buffer(ml, mlb, mw, mwb)
    bf = int(q.dtype == torch.bfloat16)
    out = torch.empty_like(qp)
    dq, dk, dv = torch.empty_like(qp), torch.empty_like(kp), torch.empty_like(vp)
    rows = lib.vtt_talking_head_rows(S, n, hdp, 1)
    pw = torch.empty(B, n, T, S, device=q.device)
    draw = torch.empty_like(pw)
    partials = torch.empty(B * -(-T // rows), 2 * n * n + 2 * n, device=q.device)
    dmix = torch.empty(2 * n * n + 2 * n, device=q.device)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    scale = float(hd**-0.5)

    def fwd():
        err = lib.vtt_talking_head_fwd(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), bf,
                                       mix.data_ptr(), out.data_ptr(), B, T, S, n, hdp, scale,
                                       stream())
        assert err == 0, err

    def bwd():
        err = lib.vtt_talking_head_bwd(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dp.data_ptr(), bf, mix.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), pw.data_ptr(), draw.data_ptr(),
            partials.data_ptr(), dmix.data_ptr(), B, T, S, n, hdp, scale, stream())
        assert err == 0, err

    def results():
        dml, dmlb, dmw, dmwb = dmix.split((n * n, n, n * n, n))
        un = lambda t: ca._unpad_heads(t, n, hd)
        return dict(out=un(out), dq=un(dq), dk=un(dk), dv=un(dv), dml=dml.reshape(n, n),
                    dmlb=dmlb, dmw=dmw.reshape(n, n), dmwb=dmwb)

    return fwd, bwd, results


def this_calls(args, dout):
    """The same three callables through this checkout's wrappers (the
    library they reach is whatever ``_cuda._lib`` holds when they run)."""
    from vision_toolbox_tpu_torch.ops import cait_attention as ca

    state: dict = {}

    def fwd():
        state["out"] = ca.talking_head_cuda(*args)

    def bwd():
        state["grads"] = ca.talking_head_bwd_cuda(*args, dout)

    def results():
        dq, dk, dv, g = state["grads"]
        return dict(out=state["out"], dq=dq, dk=dk, dv=dv, dml=g.ml, dmlb=g.mlb, dmw=g.mw,
                    dmwb=g.mwb)

    return fwd, bwd, results


def plain_results(args, dout) -> dict:
    from vision_toolbox_tpu_torch.ops import cait_attention as ca

    dq, dk, dv, g = ca.talking_head_bwd_plain(*args, dout)
    return dict(out=ca.talking_head_plain(*args), dq=dq, dk=dk, dv=dv, dml=g.ml, dmlb=g.mlb,
                dmw=g.mw, dmwb=g.mwb)


MIX_GRADS = ("dml", "dmlb", "dmw", "dmwb")


def compare(got: dict, want: dict) -> dict:
    """Per tensor: max abs over max|want| ("max") and rel L2 ("l2"); the
    mix gradients by rel L2 only, dmlb (zero in exact arithmetic) against
    ‖dml‖."""
    res = {}
    for n, w in want.items():
        a, b = got[n].float(), w.float()
        d = (a - b).norm().item()
        ref = want["dml"].float() if n == "dmlb" else b
        l2 = 0.0 if d == 0 else d / max(ref.norm().item(), 1e-30)
        res[n] = {"l2": l2} if n in MIX_GRADS else {
            "max": (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30), "l2": l2}
    return res


def snapshot(results) -> dict:
    return {k: v.clone() for k, v in results().items()}


def run_case(label, case, builds, report, name_power):
    """One shape: the timings in turns first (other, this, this, other),
    then each launch apart, then the outputs against each other and the
    plain versions."""
    from vision_toolbox_tpu_torch.ops import _cuda

    B, T, S, H, hd, dtype = case
    g = torch.Generator().manual_seed(14)
    args, dout = make_args(g, B, T, S, H, hd, dtype)
    iters = 10 if B >= 32 else 20
    row = {"shape": dict(B=B, T=T, S=S, H=H, hd=hd, dtype=str(dtype).split(".")[-1]),
           "clocks": clocks(), "this": {}, "others": {}}
    main_lib = _cuda.lib()
    this_fns = this_calls(args, dout)
    others = {}
    for bname, lib, parent in builds:
        if parent:
            others[bname] = parent_calls(lib, args, dout)
            continue

        def on(fn, lib=lib):  # this checkout's wrappers, the other build's library
            def call():
                _cuda._lib = lib
                try:
                    fn()
                finally:
                    _cuda._lib = main_lib
            return call

        f, b, r = this_calls(args, dout)
        others[bname] = (on(f), on(b), r)
    for bname, ofns in others.items():
        orow = row["others"][bname] = {}
        for k, what in enumerate(("forward", "backward")):
            ofn, tfn = ofns[k], this_fns[k]
            e1, n1, n2, e2 = (time_ms(ofn, iters), time_ms(tfn, iters), time_ms(tfn, iters),
                              time_ms(ofn, iters))
            orow[what] = dict(other_ms=(e1 + e2) / 2, this_ms=(n1 + n2) / 2, runs=[e1, n1, n2, e2])
            print(f"[ab] {label} {what:8s} {bname}: {e1:.4f} / {e2:.4f} ms, this {n1:.4f} / "
                  f"{n2:.4f} ms  [{name_power}]", flush=True)
    if not others:
        for k, what in enumerate(("forward", "backward")):
            ms = time_ms(this_fns[k], iters)
            row["this"][what] = dict(ms=ms)
            print(f"[ab] {label} {what:8s} this: {ms:.4f} ms  [{name_power}]", flush=True)
    row["clocks_after"] = clocks()
    for who, fns in (("this", this_fns), *others.items()):
        dest = row["this"] if who == "this" else row["others"][who]
        for k, what in enumerate(("forward", "backward")):
            dest[f"{what}_parts_ms"] = kernel_parts(fns[k])
            print(f"[parts] {label} {what:8s} {who}: "
                  + ", ".join(f"{n} {ms:.4f}" for n, ms in dest[f"{what}_parts_ms"].items()),
                  flush=True)
    # outputs: each build's first run, this checkout's second backward
    this_fns[0]()
    this_fns[1]()
    first = snapshot(this_fns[2])
    this_fns[1]()
    torch.cuda.synchronize()
    second = this_fns[2]()
    row["this"]["second_backward_bit_equal"] = {
        n: bool(torch.equal(first[n], second[n])) for n in first if n != "out"}
    got_others = {}
    for bname, ofns in others.items():
        ofns[0]()
        ofns[1]()
        torch.cuda.synchronize()
        got_others[bname] = snapshot(ofns[2])
    want = plain_results(args, dout)
    row["this"]["vs_plain"] = compare(first, want)
    for bname, got in got_others.items():
        row["others"][bname]["vs_plain"] = compare(got, want)
        row["others"][bname]["this_vs_other"] = compare(first, got)
    for who, r in (("this", row["this"]), *row["others"].items()):
        shown = {k: v for k, v in r.items() if not k.endswith("parts_ms")}
        print(f"[ab] {label} {who}: {json.dumps(shown)}", flush=True)
    report["cases"][label] = row
    del args, dout, first, second, want, got_others, this_fns, others
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_talking_head: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
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
    builds = []
    for name, parent, out, proc in started:
        try:
            lib, regs = load_build(name, out, proc, parent)
        except RuntimeError as e:  # a variant that does not build is reported, not timed
            if parent:
                raise
            print(f"[build] {name} failed, left out: {str(e)[-2000:]}", flush=True)
            report["others"][name] = {"build_failed": str(e)[-2000:]}
            continue
        report["others"][name] = {"ptxas": regs}
        print(f"[ptxas] {name}: {'; '.join(regs)}", flush=True)
        builds.append((name, lib, parent))
    for label, case in CASES.items():
        if args.quick and label not in QUICK:
            continue
        run_case(label, case, builds, report, name_power)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_talking_head.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
