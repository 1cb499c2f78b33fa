#!/usr/bin/env python3
"""Time K5b (csrc/resize_sum_bwd.cu) and K7b (csrc/lowres_loss.cu) on one
GPU at the main path's shapes, at other geometries and as patched builds
that leave a part of the kernel out, to show where their time goes.

    python3 tools/transpose_variants.py [--out FILE]

Geometries (the same kernels with other tables from
ops/transpose_geometry.py): K5b's bands of 32, 64 and 128 fine columns,
K7b's chunks of 4-8 fine rows. Parts (patched copies of the sources built
into build/transpose_variants/, removed at the end; nothing in the package
changes): K5b without the gather of completed rows (the rows' loads and
rolling sums alone), K7b without its transpose and without its softmax
passes. A patched build computes wrong values; only its time is printed.
Kernel time from chip_smoke.kernel_trace, ms a launch, one JSON line each
and all of them in the last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from segmentation_factory_tpu_torch.ops import _build  # noqa: E402
from segmentation_factory_tpu_torch.ops import lowres_loss as K7  # noqa: E402
from segmentation_factory_tpu_torch.ops import resize_sum as K5  # noqa: E402
from segmentation_factory_tpu_torch.ops import transpose_geometry as TG  # noqa: E402

SRC = ROOT / "segmentation_factory_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "transpose_variants"

PARTS = {
    ("resize_sum_bwd", "no_gather"): [
        ("    for (int it = t; it < first[NL]; it += nthr) {",
         "    for (int it = t; it < 0; it += nthr) {")],
    ("lowres_loss", "no_transpose"): [
        ("        for (int k = 0; k < pn[u]; ++k) v = fmaf(w[k], src[k], v);",
         "        for (int k = 0; k < 0; ++k) v = fmaf(w[k], src[k], v);")],
    ("lowres_loss", "no_softmax"): [
        ("      for (int c = 0; c < C; ++c) {  // rows first, then columns, as resize()",
         "      for (int c = 0; c < 0; ++c) {  // rows first, then columns, as resize()"),
        ("      float se = 0.f, inner = 0.f;\n#pragma unroll 4\n      for (int c = 0; c < C; ++c) {",
         "      float se = 1.f, inner = 0.f;\n#pragma unroll 4\n      for (int c = 0; c < 0; ++c) {")],
}


def build(lib: str, name: str, patches) -> Path:
    """csrc/<lib>.cu with ``patches`` applied, compiled into its own
    library; the path of the library."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for f in list(SRC.glob("*.cuh")) + [SRC / f"{lib}.cu"]:
        text = f.read_text()
        if f.suffix == ".cu":
            for a, b in patches:
                if a not in text:
                    raise RuntimeError(f"{lib}: patch anchor not found: {a[:60]!r}")
                text = text.replace(a, b)
        (d / f.name).write_text(text)
    so = d / f"{lib}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(d / f"{lib}.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return so


def use(lib: str, so) -> None:
    """Route the wrapper of ``lib`` to the library ``so`` (None: the
    package's own build)."""
    _build._FUNCS.clear()
    _build._LIBS.pop(lib, None)
    if so is not None:
        handle = ctypes.CDLL(str(so))
        handle.sft_error_string.argtypes = [ctypes.c_int]
        handle.sft_error_string.restype = ctypes.c_char_p
        _build._LIBS[lib] = handle


def with_geometry(geo, call):
    """``call()``'s kernel time with the tables of ``geo`` in place of the
    wrapper's own."""
    tab = torch.from_numpy(geo.table).to(cs.DEV)
    saved = TG.device_tables
    TG.device_tables = lambda kind, key, device: (geo, tab)
    try:
        return cs.device_ms(cs.kernel_trace(call))
    finally:
        TG.device_tables = saved


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the last line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("transpose_variants: no CUDA device", file=sys.stderr)
        return 2
    out = {"gpu": cs.nvidia_smi()}

    def emit(key, value):
        out[key] = value
        print(json.dumps({key: value}), flush=True)

    bf = torch.bfloat16
    levels = cs.sum_inputs(bf)
    g = cs.randn(levels[-1].shape, cs.gen(95), dtype=bf)
    shapes = [tuple(z.shape) for z in levels]
    k5 = lambda: K5.resize_sum_bwd(g, shapes)  # noqa: E731
    small = tuple((s[1], s[2]) for s in shapes[:-1])
    for band in (64, 32, 128):
        geo = TG.sum_bwd_geometry(g.shape[1], g.shape[2], small, g.shape[3], band=band)
        emit(f"resize_sum_bwd:band{band}", {"ms": with_geometry(geo, k5),
                                            "threads": geo.threads, "quads": geo.quads,
                                            "read_factor": geo.read_factor})
    lo, lab = cs.argmax_inputs(torch.float32), cs.loss_labels()
    loss_map, parts = K7.lowres_loss_fwd(lo, lab)
    _, wmap = K7.ce_scalar_and_weights(loss_map, lab != cs.IGNORE, "ohem", lab)
    dcoef = torch.stack(K7.dice_coefs(parts[:, 0], parts[:, 1], parts[:, 2]), 1).contiguous()
    k7 = lambda: K7.lowres_loss_bwd(lo, lab, wmap, dcoef)  # noqa: E731
    hl, wl, c = lo.shape[1:]
    for rows in (7, 4, 5, 6, 8):
        geo = TG.loss_bwd_geometry(hl, wl, lab.shape[1], lab.shape[2], c, 4, rows=rows)
        emit(f"lowres_loss_bwd:rows{rows}", {"ms": with_geometry(geo, k7),
                                             "threads": geo.threads, "smem": geo.smem})
    for (lib, part), patches in PARTS.items():
        use(lib, build(lib, part, patches))
        call = k5 if lib == "resize_sum_bwd" else k7
        emit(f"{'resize_sum_bwd' if lib == 'resize_sum_bwd' else 'lowres_loss_bwd'}:{part}",
             {"ms": cs.device_ms(cs.kernel_trace(call))})
        use(lib, None)
    shutil.rmtree(OUT, ignore_errors=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
