#!/usr/bin/env python3
"""Time the two forms of the attention core's exponentials on one GPU:
K1f (csrc/sra_attention.cu) and K3f (csrc/attn_block.cu) with the
exponentials written over the score registers or packed straight into P's
fragments (attn_fwd_core.cuh ``IN_PLACE``), each built from a patched copy
of the sources (nothing in the package changes).

    python3 tools/kernel_variants.py

Prints ptxas's registers and C75 lines of each build, and each variant's ms
a launch by CUDA events (two rounds) at MiT-B2's stages (batch 2, 1024²
input). The builds go to build/kernel_variants/, removed at the end.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from segmentation_factory_tpu_torch.ops import _build  # noqa: E402

SRC = ROOT / "segmentation_factory_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "kernel_variants"
V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# (K1f's form, K3f's form): the core's IN_PLACE argument in each kernel
CORE_VARIANTS = {
    "in_place": ([("run<D, ROW, false>", "run<D, ROW, true>")], []),
    "packed": ([], [("run<D, L::ROW, true>", "run<D, L::ROW, false>")]),
}


def build(name: str, lib: str, patches) -> tuple:
    """Compile csrc/<lib>.cu with ``patches`` applied (to the .cu and the
    headers alike); returns (path of the library, ptxas log)."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for f in list(SRC.glob("*.cuh")) + [SRC / f"{lib}.cu"]:
        text = f.read_text()
        for a, b in patches:
            text = text.replace(a, b)
        (d / f.name).write_text(text)
    so = d / f"{lib}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
                          str(d / f"{lib}.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return so, res.stdout + res.stderr


def check_patched(lib: str, patches) -> None:
    text = "".join(f.read_text() for f in list(SRC.glob("*.cuh")) + [SRC / f"{lib}.cu"])
    for a, _ in patches:
        if a not in text:
            raise RuntimeError(f"{lib}: patch anchor not found: {a[:60]!r}")


def report(name: str, log: str) -> None:
    regs = [ln.split("Used ")[1].split(" reg")[0] for ln in log.splitlines() if "Used" in ln]
    c75 = sum("C75" in ln for ln in log.splitlines())
    spills = sum("spill" in ln and "0 bytes spill stores" not in ln for ln in log.splitlines())
    print(f"{name}: registers {regs}, C75 lines {c75}, lines with spills {spills}", flush=True)


def events_ms(call, n=30) -> float:
    call()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        call()
    e1.record()
    e1.synchronize()
    return round(e0.elapsed_time(e1) / n, 4)


def attn_core() -> None:
    libs = {}
    for name, (k3_patches, k1_patches) in CORE_VARIANTS.items():
        check_patched("attn_block", k3_patches)
        check_patched("sra_attention", k1_patches)
        k1_so, k1_log = build(f"core_{name}", "sra_attention", k1_patches)
        k3_so, k3_log = build(f"core_{name}", "attn_block", k3_patches)
        report(f"attn_core {name} K1f", k1_log)
        report(f"attn_core {name} K3f", k3_log)
        libs[name] = (k1_so, k3_so)
    g = torch.Generator(device="cuda").manual_seed(0)
    st = torch.cuda.current_stream().cuda_stream
    rnd = lambda *s, sc=1.0: (torch.randn(*s, device="cuda", generator=g) * sc)  # noqa: E731
    k1_cases = []
    for n, h in ((65536, 1), (16384, 2), (4096, 5), (1024, 8)):
        q, k, v = (rnd(2, r, h, 64).bfloat16() for r in (n, 1024, 1024))
        k1_cases.append((q, k, v, torch.empty_like(q), n, h))
    k3_cases = []
    for s, c in ((256, 64), (128, 128), (64, 320)):
        k3_cases.append(dict(x=rnd(2, s * s, c).bfloat16(), k=rnd(2, 1024, c, sc=0.5).bfloat16(),
                             v=rnd(2, 1024, c, sc=0.5).bfloat16(), lg=torch.ones(c, device="cuda"),
                             lb=torch.zeros(c, device="cuda"), wq=rnd(c, c, sc=c ** -0.5).bfloat16(),
                             bq=rnd(c, sc=0.1).bfloat16(), wo=rnd(c, c, sc=c ** -0.5).bfloat16(),
                             bo=rnd(c, sc=0.1).bfloat16(), fac=torch.ones(2, device="cuda"),
                             out=torch.empty(2, s * s, c, device="cuda").bfloat16(), n=s * s, c=c))
    for rnd_i in range(2):
        for name, (k1_so, k3_so) in libs.items():
            f1 = ctypes.CDLL(str(k1_so)).sft_sra_attention
            f1.argtypes = [V] * 5 + [I] * 5 + [F, I, V]
            f1.restype = I
            f3 = ctypes.CDLL(str(k3_so)).sft_attn_block
            f3.argtypes = [V] * 13 + [I] * 5 + [F, I, V]
            f3.restype = I
            t1 = []
            for q, k, v, o, n, h in k1_cases:
                call = lambda: f1(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,  # noqa: E731
                                  2, n, 1024, h, 64, 0.125, 1, st)
                assert call() == 0
                t1.append(events_ms(call))
            t3 = []
            for t in k3_cases:
                ptrs = [t[k].data_ptr() for k in
                        ("x", "k", "v", "lg", "lb", "wq", "bq", "wo", "bo", "fac", "out")]
                call = lambda: f3(*ptrs, None, None, 2, t["n"], 1024, t["c"], 64, 0.125,  # noqa: E731
                                  1, st)
                assert call() == 0
                t3.append(events_ms(call))
            print(f"round {rnd_i} attn_core {name}: K1f ms a launch {t1} (stages 1-4), "
                  f"K3f {t3} (stages 1-3)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    try:
        attn_core()
    finally:
        shutil.rmtree(OUT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
