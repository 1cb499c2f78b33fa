#!/usr/bin/env python3
"""Time K5f (csrc/resize_sum.cu) and K6f (csrc/head_tail.cu) on one GPU at
the main path's shapes, at other geometries and as patched builds that
leave a part of the kernel out or change one choice, to show where their
time goes.

    python3 tools/head_variants.py [--out FILE]

Geometries (the same kernel with other tables from
ops/transpose_geometry.py): K5f's bands of 16, 32 and 64 fine rows and
slabs of 32, 64 and 128 channels. Patched copies of the sources (built into
build/transpose_variants/, removed at the end; nothing in the package
changes): K5f with two or three blocks an SM asked of ptxas
(``__launch_bounds__``), with its interpolations contracted into FMAs,
without the vertical pass (the rows' interpolation into shared memory)
and without the smaller levels' columns (the full-size level streamed in
and the output out alone); K6f with its logits' products at one class of the
slice, with y3 = s (no BatchNorm, ReLU or dropout), with both (its loads
of s nearly alone), without its loads of s after the first chunk (the
compute alone), with its loop over a chunk's units unrolled, with its
loop over a unit's quads rolled, with chunks of 128 or 32 bytes a pixel
(the former at 2 pixels a thread; both loads alone), and with four rows
a thread in flight in its statistics kernel instead of eight. A patched build computes wrong values; only its
time is printed. Kernel time from chip_smoke.kernel_trace, ms a call
(K6f also by step: statistics, logits), one JSON line each and all of them
in the last line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke as cs  # noqa: E402
import transpose_variants as tv  # noqa: E402
from segmentation_factory_tpu_torch.ops import head_tail as K6  # noqa: E402
from segmentation_factory_tpu_torch.ops import resize_sum as K5  # noqa: E402
from segmentation_factory_tpu_torch.ops import transpose_geometry as TG  # noqa: E402

_K5_BOUNDS = "__global__ void __launch_bounds__(THREADS, 2)\nresize_sum_kernel("
# K6f's product at one class of the slice (its y3 still feeds it), and y3
# without the BatchNorm, ReLU and dropout (s itself)
_K6_PRODUCT = ("        for (int k = 0; k < KS; ++k) {\n          const float4 w = wq[k];",
               "        for (int k = 0; k < 1; ++k) {\n          const float4 w = wq[k];")
_K6_Y3 = ("          y[j] = make_float4(relu(bn_y1v<T>(x.x, q0.x, q0.y, q0.z, q0.w, xh)) * dm.x,",
          "          y[j] = x; if (false) y[j] = make_float4(relu(bn_y1v<T>(x.x, q0.x, q0.y, q0.z, q0.w, xh)) * dm.x,")
# K6f with its chunk's unit loop unrolled, with its quad loop rolled too;
# with 128-byte chunks a pixel (2 pixels a thread at 19 classes, for the
# stages' shared memory); with 32-byte chunks
_K6_UNROLLED = ("#pragma unroll 1\n    for (int u = 0; u < UNITS; ++u) {\n      uint4 raw[P];",
                "#pragma unroll\n    for (int u = 0; u < UNITS; ++u) {\n      uint4 raw[P];")
_K6_QUAD_ROLLED = ("#pragma unroll\n      for (int h = 0; h < CPU / 4; ++h) {",
                   "#pragma unroll 1\n      for (int h = 0; h < CPU / 4; ++h) {")
_K6_CHUNK128 = [
    ("constexpr int LCB = 64; ", "constexpr int LCB = 128;"),
    ("    case 19: return launch_logits<T, 19, 4>(", "    case 19: return launch_logits<T, 19, 2>("),
    ("logits_smem(a.e, ks, ks <= 20 ? 4 : 2, sizeof(T))", "logits_smem(a.e, ks, 2, sizeof(T))")]
_K6_CHUNK32 = ("constexpr int LCB = 64; ", "constexpr int LCB = 32; ")
# K6f's logits without loads of s after the first chunk (the compute alone,
# on stale stages)
_K6_NO_LOADS = ("    if (ch + 1 < chunks) stage_chunk(ch + 1);\n    else cp_async_commit();",
                "    cp_async_commit();")
# K6f's statistics with four rows a thread in flight instead of eight
_K6_STATS4 = [
    ("    for (; p + 7 * step < n; p += 8 * step) {\n      float x[8][VEC];",
     "    for (; p + 3 * step < n; p += 4 * step) {\n      float x[4][VEC];"),
    ("      for (int u = 0; u < 8; ++u) load_vec<T, VEC>(x[u], s + (size_t)(p + u * step) * e + c);",
     "      for (int u = 0; u < 4; ++u) load_vec<T, VEC>(x[u], s + (size_t)(p + u * step) * e + c);"),
    ("      for (int u = 0; u < 8; ++u)\n#pragma unroll\n        for (int j = 0; j < VEC; ++j) {",
     "      for (int u = 0; u < 4; ++u)\n#pragma unroll\n        for (int j = 0; j < VEC; ++j) {")]
PARTS = {
    ("resize_sum", "bounds3"): [(_K5_BOUNDS, _K5_BOUNDS.replace("2)", "3)"))],
    ("resize_sum", "fma"): [
        ("  return __fadd_rn(__fmul_rn(x0, a), __fmul_rn(x1, b));",
         "  return fmaf(x1, b, x0 * a);"),
        ("          o[0] = __fadd_rn(o[0], lerp_rn(v0.x, a, v1.x, bw));\n"
         "          o[1] = __fadd_rn(o[1], lerp_rn(v0.y, a, v1.y, bw));\n"
         "          o[2] = __fadd_rn(o[2], lerp_rn(v0.z, a, v1.z, bw));\n"
         "          o[3] = __fadd_rn(o[3], lerp_rn(v0.w, a, v1.w, bw));",
         "          o[0] = fmaf(v1.x, bw, fmaf(v0.x, a, o[0]));\n"
         "          o[1] = fmaf(v1.y, bw, fmaf(v0.y, a, o[1]));\n"
         "          o[2] = fmaf(v1.z, bw, fmaf(v0.z, a, o[2]));\n"
         "          o[3] = fmaf(v1.w, bw, fmaf(v0.w, a, o[3]));")],
    ("resize_sum", "no_vertical"): [
        ("    for (int it = t; it < first[NL]; it += THREADS) {\n#pragma unroll",
         "    for (int it = t; it < 0; it += THREADS) {\n#pragma unroll")],
    ("resize_sum", "no_columns"): [
        ("        if (l >= p.nl) continue;\n        const Level& L = p.lv[l];\n"
         "        const int4 ct",
         "        if (true) continue;\n        const Level& L = p.lv[l];\n"
         "        const int4 ct")],
    ("head_tail", "one_class"): [_K6_PRODUCT],
    ("head_tail", "no_y3"): [_K6_Y3],
    ("head_tail", "loads_only"): [_K6_PRODUCT, _K6_Y3],
    ("head_tail", "no_loads"): [_K6_NO_LOADS],
    ("head_tail", "unit_loop_unrolled"): [_K6_UNROLLED],
    ("head_tail", "quad_loop_rolled"): [_K6_QUAD_ROLLED],
    ("head_tail", "chunk128_p2_loads_only"): _K6_CHUNK128 + [_K6_PRODUCT, _K6_Y3],
    ("head_tail", "chunk32_loads_only"): [_K6_CHUNK32, _K6_PRODUCT, _K6_Y3],
    ("head_tail", "stats_4_in_flight"): _K6_STATS4,
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the last line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("head_variants: no CUDA device", file=sys.stderr)
        return 2
    out = {"gpu": cs.nvidia_smi()}

    def emit(key, value):
        out[key] = value
        print(json.dumps({key: value}), flush=True)

    bf = torch.bfloat16
    levels = cs.sum_inputs(bf)
    k5 = lambda: K5.resize_sum(levels)  # noqa: E731
    h, w, e = levels[-1].shape[1:]
    small = tuple((z.shape[1], z.shape[2]) for z in levels[:-1])
    ta, dm = cs.tail_inputs(bf), cs.tail_mask()
    k6 = lambda: K6.head_tail_train(*ta[:3], dm, *ta[3:], 1e-5)  # noqa: E731

    def k6_times():
        trace = cs.kernel_trace(k6)
        return {"ms": cs.device_ms(trace), "by_step": cs.phases_of(trace)}

    emit("resize_sum:package", {"ms": cs.device_ms(cs.kernel_trace(k5))})
    emit("head_tail:package", {**k6_times(), "plan": K6.fwd_plan(ta[0].shape, cs.NC, bf)})
    for rows, slab in ((16, 64), (64, 64), (32, 32), (32, 128), (16, 128)):
        geo = TG.sum_fwd_geometry(h, w, small, e, 2, rows=rows, slab=slab)
        emit(f"resize_sum:rows{rows}_slab{slab}", {"ms": tv.with_geometry(geo, k5),
                                                   "cols": geo.cols, "smem": geo.smem,
                                                   "read_factor": geo.read_factor})
    for (lib, part), patches in PARTS.items():
        tv.use(lib, tv.build(lib, part, patches))
        emit(f"{lib}:{part}", {"ms": cs.device_ms(cs.kernel_trace(k5))} if lib == "resize_sum"
             else k6_times())
        tv.use(lib, None)
    shutil.rmtree(tv.OUT, ignore_errors=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
