#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch port on one GPU: run ``chip_smoke.py``
of each in turns (parent, change, change, parent) and summarise the kernels'
times and the end-to-end figures of every run, then the means of each tree.

    python3 tools/chip_turns.py PARENT_DIR --out DIR [--change DIR]
                                [--order pccp] [--kernels a,b]

PARENT_DIR holds the other checkout (e.g. ``git archive`` of the parent
commit unpacked into a directory that .gitignore lists); the change is the
checkout this script lives in, or ``--change``. Each run's output goes to
``<out>/<i>_<tree>.out``; the summary is
printed as JSON lines, the last one the per-tree means. A run that fails
makes the exit code 1.
Times: "ev" the CUDA-event time, "dev" the profiler's kernel time
(``chip_smoke.kernel_trace``), per launch at each stage and per fused train
step; a call's kernel time by phase (K2f's fc1 / stencil / fc2, K6b's two
passes, the backwards' phases) where the run reports it; the step's and a
predict's device time from the profiled calls; the kernels' device time a
train step summed over every kernel, fused and per-op.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("sra_attention", "mixffn", "attn_block", "ffn_block", "resize_sum", "head_tail",
           "head_tail_bwd")


def lines(text):
    for ln in text.splitlines():
        if ln.startswith("{"):
            try:
                yield json.loads(ln)
            except json.JSONDecodeError:
                continue


def summarise(text, kernels):
    """The figures of one chip_smoke run."""
    phases = {d["phase"]: d for d in lines(text) if "phase" in d}
    out = {"ok": all(d.get("ok") for d in phases.values()) and "times" in phases,
           "gpu": phases.get("device", {}).get("gpu")}
    times, train = phases.get("times", {}), phases.get("train", {})
    for name in kernels:
        rows = [r for r in times.get("shapes", []) if r["kernel"] == name]
        out[name] = {
            "ev_per_launch": [r["ms"] for r in rows],
            "dev_per_launch": [r["device_ms"] for r in rows],
            "null_because": [r.get("null_because") for r in rows if r.get("null_because")],
            "shapes": [r["shape"] for r in rows],
            "step": {k: times.get("per_step", {}).get(name, {}).get(k)
                     for k in ("ms", "device_ms", "bound_ms", "plain_ms", "library_ms",
                               "library_device_ms")},
            "step_per_op": {k: times.get("per_step_per_op", {}).get(name, {}).get(k)
                            for k in ("ms", "device_ms")},
        }
    # a run of an older tree reports the backwards' phases as "bwd_phases"
    out["phases"] = {f"{r['kernel']}:s{r['stage']}": r["device_ms"]
                     for r in times.get("phases") or times.get("bwd_phases") or []
                     if r["kernel"] in kernels}
    prof_t, prof_p = train.get("profile") or {}, times.get("profile_predict") or {}
    out["train_step_device_ms"] = prof_t.get("device_busy_ms")
    out["train_step_wall_ms"] = prof_t.get("wall_ms")
    out["train_idle_share"] = prof_t.get("idle_share")
    out["predict_device_ms"] = prof_p.get("device_busy_ms")
    out["predict_wall_ms"] = prof_p.get("wall_ms")
    for key, part in (("kernels_device_ms", "per_step"),
                      ("kernels_device_ms_per_op", "per_step_per_op")):
        out[key] = sum(r.get("device_ms") or 0.0 for r in times.get(part, {}).values())
    for k in ("train_images_per_s", "train_images_per_s_per_op", "predict_images_per_s",
              "predict_images_per_s_per_op", "train_turns", "predict_turns"):
        out[k] = times.get(k)
    out["check"] = {k: {f: v.get(f) for f in ("f32_max_abs_err", "bf16_max_abs_err",
                                              "bf16_plain_err", "ok")}
                    for k, v in phases.get("check", {}).items()
                    if isinstance(v, dict) and k.split(":")[0] in kernels}
    return out


def mean(vals):
    vals = [v for v in vals if isinstance(v, (int, float))]
    return sum(vals) / len(vals) if vals else None


def means(runs, kernels):
    """Per-tree means of the numeric figures (lists element by element)."""
    out = {}
    for key in ("train_step_device_ms", "predict_device_ms", "kernels_device_ms",
                "kernels_device_ms_per_op", "train_images_per_s",
                "train_images_per_s_per_op", "predict_images_per_s",
                "predict_images_per_s_per_op", "train_idle_share"):
        out[key] = mean([r[key] for r in runs])
    for name in kernels:
        k = {}
        for field in ("ev_per_launch", "dev_per_launch"):
            cols = zip(*[r[name][field] for r in runs])
            k[field] = [mean(c) for c in cols]
        for part in ("step", "step_per_op"):
            k[part] = {f: mean([r[name][part][f] for r in runs]) for f in runs[0][name][part]}
        out[name] = k
    out["phases"] = {key: {ph: mean([(r["phases"].get(key) or {}).get(ph) for r in runs])
                           for ph in by}
                     for key, by in runs[0]["phases"].items() if by}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", help="the other checkout's root")
    ap.add_argument("--order", default="pccp", help="p = parent, c = change, in turn")
    ap.add_argument("--change", default=str(ROOT),
                    help="the changed checkout's root (default: this one)")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--out", required=True, help="directory for each run's output")
    args = ap.parse_args()
    kernels = tuple(args.kernels.split(","))
    trees = {"p": Path(args.parent).resolve(), "c": Path(args.change).resolve()}
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = {"p": [], "c": []}
    failed = False
    for i, which in enumerate(args.order):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=trees[which],
                             capture_output=True, text=True)
        name = "parent" if which == "p" else "change"
        (out_dir / f"{i}_{name}.out").write_text(res.stdout)
        (out_dir / f"{i}_{name}.err").write_text(res.stderr)
        summary = summarise(res.stdout, kernels)
        summary.update(turn=i, tree=name, rc=res.returncode,
                       seconds=time.perf_counter() - t0)
        failed = failed or res.returncode != 0 or not summary["ok"]
        runs[which].append(summary)
        print(json.dumps(summary), flush=True)
    print(json.dumps({"means": {("parent" if w == "p" else "change"): means(r, kernels)
                                for w, r in runs.items() if r}}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
