#!/usr/bin/env python3
"""Time K9b (csrc/ms_deform_attn.cu) on one GPU at the Mask2Former slice's
shapes against patched builds of the same source, to show what its
shared-memory windows buy.

    python3 tools/k9_variants.py [--out FILE]

Variants (patched copies of the source built into build/k9_variants/,
removed at the end; nothing in the package changes): ``no_window``, no
block takes a window, so every d(value) row goes straight to device
memory by 16-byte vector reductions (the blocks, the box pass and the
barriers stay: step (a)'s reductions under step (b)'s blocks);
``window_1024`` and ``window_4096``, windows of half and twice the
pixels (bands of fewer or more rows); ``threads_256``, blocks of 256
threads (half the queries), two an SM. The tree's build and each
variant run in turns (tree, variant, variant, tree) on the same inputs
(``chip_smoke.k9_inputs``, bf16, offsets of up to 4 pixels, and of up to
40 for ``wide``); each variant's three gradients are held to the tree's,
within 2^-7 of each one's largest entry (atomics reorder d(value)'s
float32 sums before its cast to bf16). Kernel time from
``chip_smoke.kernel_trace``, CUDA events from ``chip_smoke.cuda_ms``, ms a
launch, one JSON line each and all of them in the last line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from segmentation_factory_tpu_torch.ops import _build  # noqa: E402
from segmentation_factory_tpu_torch.ops import msdeform as K9  # noqa: E402

sys.path.insert(0, str(ROOT / "tools"))
from transpose_variants import use  # noqa: E402

SRC = ROOT / "segmentation_factory_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "k9_variants"
WINDOW = "constexpr int WINDOW_PIXELS = 2048;"
THREADS = "constexpr int BWD_THREADS = 512;"
VARIANTS = {
    "no_window": [("const bool windowed = any && P <= GROUP && bw <= WINDOW_PIXELS;",
                   "const bool windowed = false;")],
    "window_1024": [(WINDOW, "constexpr int WINDOW_PIXELS = 1024;")],
    "window_4096": [(WINDOW, "constexpr int WINDOW_PIXELS = 4096;")],
    "threads_256": [(THREADS, "constexpr int BWD_THREADS = 256;"),
                    ("__launch_bounds__(BWD_THREADS, 1)", "__launch_bounds__(BWD_THREADS, 2)")],
}


def build(name: str, patches) -> Path:
    """csrc/ms_deform_attn.cu with ``patches`` ((anchor, replacement), ...)
    applied, compiled into its own library; the path of the library."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for f in SRC.glob("*.cuh"):
        (d / f.name).write_text(f.read_text())
    text = (SRC / "ms_deform_attn.cu").read_text()
    for anchor, line in patches:
        if anchor not in text:
            raise RuntimeError(f"patch anchor not found: {anchor!r}")
        text = text.replace(anchor, line)
    (d / "ms_deform_attn.cu").write_text(text)
    so = d / "ms_deform_attn.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(d / "ms_deform_attn.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return so


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the last line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k9_variants: no CUDA device", file=sys.stderr)
        return 2
    out = {"gpu": cs.nvidia_smi()}

    def emit(key, value):
        out[key] = value
        print(json.dumps({key: value}), flush=True)

    _build.build(["ms_deform_attn"])
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    for tag in ("slice", "wide"):
        b, levels, m, d, p, px = cs.K9_SHAPES[tag]
        v, loc, attn = cs.k9_inputs(torch.bfloat16, b, levels, m, d, p, px, 970)
        g = cs.randn((b, loc.shape[1], m * d), cs.gen(971))
        call = lambda: K9.ms_deform_attn_bwd(v, levels, loc, attn, g)  # noqa: E731
        for name, so in libs.items():
            res = {"tree": [], "variant": []}
            ref = None
            for which in ("tree", name, name, "tree"):
                use("ms_deform_attn", None if which == "tree" else so)
                got = call()
                torch.cuda.synchronize()
                if which == "tree":
                    ref = got if ref is None else ref
                else:
                    errs = [cs.max_err(a, r) / max(r.float().abs().max().item(), 1e-30)
                            for a, r in zip(got, ref)]
                    res.setdefault("rel_err_vs_tree", errs)
                res["tree" if which == "tree" else "variant"].append(
                    {"device_ms": cs.device_ms(cs.kernel_trace(call)), "ms": cs.cuda_ms(call)})
            use("ms_deform_attn", None)
            res["ok"] = all(e <= 2 ** -7 for e in res["rel_err_vs_tree"])
            emit(f"ms_deform_attn_bwd:{tag}:{name}", res)
    shutil.rmtree(OUT, ignore_errors=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0 if all(v.get("ok", True) for v in out.values() if isinstance(v, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
