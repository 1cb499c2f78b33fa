#!/usr/bin/env python3
"""Time K7f (csrc/lowres_loss.cu) and K8 (csrc/resize_argmax.cu) on one GPU at
the main path's shapes (lo (2, 256, 256, 19) float32 sampled at 1024²), at
other geometries and as patched builds that leave a part out, to show where
their time goes.

    python3 tools/lowres_variants.py [--out FILE]

Geometries (the same kernels with other tables from
ops/transpose_geometry.py `lowres_fwd_geometry`): the wrappers' own, as
many bands as fill the card's resident blocks in one wave (also at 64
threads a block); bands of 4-16 fine rows; blocks of 64 or 128 threads;
the rows split over 2 or 3 waves. Parts (patched copies of the sources built
into build/lowres_variants/, removed at the end; nothing in the package
changes): K8 without its class loop (the front end, the stores), K7f without
its pixels (the front end, the label loads and loss stores), without its
dice sums, without its exponentials; K8 without the loads shared by pixel
pairs that sample the same columns (`pairs`). A patched build computes wrong
values; only its time is printed. Kernel time from chip_smoke.kernel_trace
(K7f: both launches), ms a call, one JSON line each and all of them in the
last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from segmentation_factory_tpu_torch.ops import _build  # noqa: E402
from segmentation_factory_tpu_torch.ops import lowres_loss as K7  # noqa: E402
from segmentation_factory_tpu_torch.ops import resize_argmax as K8  # noqa: E402
from segmentation_factory_tpu_torch.ops import transpose_geometry as TG  # noqa: E402
from tools import transpose_variants as TV  # noqa: E402

OUT = ROOT / "build" / "lowres_variants"


def with_geometry(geo, name, call):
    """``call()``'s kernel time with the tables of ``geo`` in place of the
    wrapper's own (its cached table lookup, per shape)."""
    kernel, mod, attr = (("loss", K7, "_fwd_tables") if name == "lowres_loss_fwd"
                         else ("argmax", K8, "_tables"))
    layout = geo.layout(kernel)
    tables = (geo, torch.from_numpy(geo.table).to(cs.DEV), (ctypes.c_int * len(layout))(*layout))
    saved = getattr(mod, attr)
    setattr(mod, attr, lambda *args: tables)
    try:
        return cs.device_ms(cs.kernel_trace(call))
    finally:
        setattr(mod, attr, saved)

PARTS = {
    ("resize_argmax", "no_classes"): [
        ("      for (int c = 0; c < C; ++c) {", "      for (int c = 0; c < 0; ++c) {")],
    ("resize_argmax", "no_pairs"): [("    if (g.pairs) {", "    if (false) {")],
    ("lowres_loss", "no_pixels"): [("    pair(0, V);\n    pair(2, V);\n", "")],
    ("lowres_loss", "no_dice"): [
        ("        psum[c] += pa;\n        psum[c] += pb;",
         "        if (pa == 12345.f) psum[c] += pa + pb;")],
    ("lowres_loss", "no_exp"): [
        ("        ea[c] = ex2(fmaf(ea[c], L2E, na));\n        eb[c] = ex2(fmaf(eb[c], L2E, nb));",
         "        ea[c] = fmaf(ea[c], L2E, na);\n        eb[c] = fmaf(eb[c], L2E, nb);")],
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the last line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lowres_variants: no CUDA device", file=sys.stderr)
        return 2
    out = {"gpu": cs.nvidia_smi()}

    def emit(key, value):
        out[key] = value
        print(json.dumps({key: value}), flush=True)

    TV.OUT = OUT
    lo, lab = cs.argmax_inputs(torch.float32), cs.loss_labels()
    b, hl, wl, c = lo.shape
    hh, ww = lab.shape[1:]
    calls = {"lowres_loss_fwd": lambda: K7.lowres_loss_fwd(lo, lab),
             "resize_argmax": lambda: K8.resize_argmax_to(lo, (hh, ww))}
    for name, call in calls.items():
        emit(f"{name}:default", {"ms": cs.device_ms(cs.kernel_trace(call))})
    slots = {"lowres_loss_fwd": K7.fwd_geometry(lo, lab)[0].loss,
             "resize_argmax": K8.geometry(lo, (hh, ww))[0].argmax}
    emit("one_wave", {k: {"bands": v.bands, "rows": v.rows, "blocks": b * v.bands * v.spans}
                      for k, v in slots.items()})
    geos = {f"rows{rows}_threads{threads}": TG.lowres_fwd_geometry(
        hl, wl, hh, ww, c, 4, rows=rows, threads=threads)
        for rows in (4, 8, 12, 16) for threads in (128, 64)}
    for waves in (2, 3):  # bands a wave's share of the rows, 2 or 3 waves
        n = {k: b * v.bands * v.spans * waves for k, v in slots.items()}
        geos[f"waves{waves}"] = TG.lowres_fwd_geometry(
            hl, wl, hh, ww, c, 4, batch=b, slots=(n["lowres_loss_fwd"], n["resize_argmax"]))
    # one wave of blocks of 64 threads (spans of 256 columns)
    small = TG.lowres_fwd_geometry(hl, wl, hh, ww, c, 4, threads=64)
    n = [ctypes.c_int(), ctypes.c_int()]
    ints = ctypes.POINTER(ctypes.c_int)
    _build.launch("lowres_loss", "sft_lowres_loss_fwd_slots", [_build.INT] * 4 + [ints], c, 0,
                  small.loss.threads, small.loss.smem, ctypes.byref(n[0]))
    _build.launch("resize_argmax", "sft_resize_argmax_slots", [_build.INT] * 3 + [ints], 0,
                  small.argmax.threads, small.argmax.smem, ctypes.byref(n[1]))
    geos["one_wave_threads64"] = TG.lowres_fwd_geometry(
        hl, wl, hh, ww, c, 4, batch=b, slots=(n[0].value, n[1].value), threads=64)
    for tag, geo in geos.items():
        for name, call in calls.items():
            lay = geo.loss if name == "lowres_loss_fwd" else geo.argmax
            emit(f"{name}:{tag}", {"ms": with_geometry(geo, name, call), "smem": lay.smem,
                                   "blocks": b * lay.bands * lay.spans})
    for (lib, part), patches in PARTS.items():
        TV.use(lib, TV.build(lib, part, patches))
        name = "resize_argmax" if lib == "resize_argmax" else "lowres_loss_fwd"
        emit(f"{name}:{part}", {"ms": cs.device_ms(cs.kernel_trace(calls[name]))})
        TV.use(lib, None)
    shutil.rmtree(OUT, ignore_errors=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
