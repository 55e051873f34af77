"""Compile-service acceptance bench over the port.

What the pre-warm driver buys. A compile in the port is a library build:
the nvcc build of each CUDA kernel library and the g++ build of the
native library (runtime/compile_service.note_build; `compile_count`
counts them, a library found on disk under its source hash is a hit).
They persist in the build directory, which the bench points at a
temporary directory of its own through BLAZE_TPU_TORCH_BUILD_DIR (the
port's counterpart of the JAX package's BLAZE_TPU_XLA_CACHE), with the
shape manifest in it (BLAZE_TPU_COMPILE_MANIFEST). The package's own
`build/` is never touched.

  phase 1  empty build directory + empty manifest: run the TPC-DS
           mini-matrix once at `--rows` and once at each extra scale
           (t_first) — builds the libraries AND fills the shape
           manifest.
  phase 2  delete the built libraries but KEEP the manifest; run the
           warm driver (`python -m blaze_tpu_torch.runtime.
           compile_service --warm`), which rebuilds the libraries and
           replays the manifest and the catalogue (t_warmup).
  phase 3  one fresh process with the libraries on disk: run the matrix
           (t_cold_warmed), then again in-process (t_warm).
           Acceptance: t_cold_warmed <= 2 x t_warm, with compile_count /
           compile_ns / whole-stage coverage visible, and the shape
           registry showing >= 4x reduction of raw sort/join row-count
           space onto canonical capacity rungs (`canonical_capacity` is
           the JAX package's; the port pads no batch to it).

Every child runs on `--device` (passed on its command line and as
BLZ_DEVICE). Stands for the JAX package's tools/compile_warm_bench.py
(COMPILE_SERVICE_r06.json). Takes `--device` (default `cuda`); without a
card and without `--device cpu` it refuses to start. Writes its report
only where `--json-out` says.

    python -m blaze_tpu_torch.tools.compile_warm_bench --device cpu \
        --rows 200000 --extra-scales 160000,120000 --json-out cwb.json
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MANIFEST = "compile_manifest.json"


def _libraries() -> dict:
    """What this process built or found of the port's libraries, and why
    a library could not build (reported, never hidden)."""
    from blaze_tpu_torch import kernels, native

    available = native.available()
    return {"kernels_built": sorted(kernels.BUILD_INFO),
            "kernels_loaded": sorted(kernels._libs),
            "native_available": available,
            "native_build_s": native.BUILD_INFO.get("seconds"),
            "native_error": None if available else native.build_error()}


def _matrix_child(args) -> int:
    """Run the tpcds mini-matrix `--passes` times in one process; emit
    per-pass wall clock + compile telemetry as JSON on the last line."""
    from blaze_tpu_torch.runtime import compile_service
    from blaze_tpu_torch.spark.validator import run_matrix

    queries = [q for q in args.queries.split(",") if q]
    # cumulative view: the manifest aggregates canonical-shape
    # observations across every phase of the bench (and any prior run of
    # this engine config), which is what the shape-reduction acceptance
    # reads — bucketing pays off across a *population* of input scales
    compile_service.registry().load()
    scales = [int(r) for r in str(args.rows).split(",")]
    out = {"passes": []}
    with tempfile.TemporaryDirectory(prefix="blaze_torch_cwb_") as tmp:
        for i, rows in enumerate(scales * args.passes
                                 if len(scales) == 1 else scales):
            os.makedirs(os.path.join(tmp, f"p{i}"), exist_ok=True)
            base = dict(compile_service.TELEMETRY.snapshot())
            t = time.time()
            results = run_matrix(os.path.join(tmp, f"p{i}"), rows=rows,
                                 queries=queries, suite="tpcds",
                                 device=args.device)
            dt = time.time() - t
            snap = compile_service.TELEMETRY.snapshot()
            delta = {k: snap.get(k, 0) - base.get(k, 0) for k in snap}
            delta["whole_stage_coverage_pct"] = snap.get(
                "whole_stage_coverage_pct", 0)
            failed = [r.query for r in results if not r.ok]
            out["passes"].append({
                "rows": rows, "seconds": round(dt, 2),
                "cells": len(results), "failed": failed,
                "telemetry": delta,
            })
        out["shape_reduction"] = compile_service.registry().shape_reduction()
        out["manifest_path"] = compile_service.default_manifest_path()
        out["libraries"] = _libraries()
        compile_service.registry().persist()
    print("CWB_JSON " + json.dumps(out))
    return 0 if not any(p["failed"] for p in out["passes"]) else 1


def _run_child(env, argv, tag):
    print(f"[bench] {tag}: {' '.join(argv)}", flush=True)
    t = time.time()
    proc = subprocess.run(argv, env=env, capture_output=True, text=True)
    dt = time.time() - t
    sys.stdout.write(proc.stdout[-4000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"{tag} failed rc={proc.returncode}")
    payload = None
    for line in proc.stdout.splitlines():
        if line.startswith("CWB_JSON "):
            payload = json.loads(line[len("CWB_JSON "):])
    return dt, payload


def _clear_xla_cache_keep_manifest(build_root):
    """Delete every built library under `build_root`, keeping the
    manifest: the port's build directory stands where the JAX package's
    XLA cache stood."""
    for dirpath, _dirs, files in os.walk(build_root):
        for f in files:
            if f != MANIFEST:
                os.unlink(os.path.join(dirpath, f))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blaze_tpu_torch.tools.compile_warm_bench")
    ap.add_argument("--rows", type=str, default="2000000",
                    help="primary matrix scale (child mode: comma list "
                    "runs one pass per scale)")
    ap.add_argument("--extra-scales", type=str,
                    default="1600000,1400000,1200000,1000000,700000",
                    help="additional phase-1 scales ('' disables): the "
                    "manifest then shows raw shape diversity from a "
                    "POPULATION of input sizes collapsing onto shared "
                    "canonical rungs, as a long-lived deployment would")
    ap.add_argument("--queries", type=str, default="q01,q03,q05,q06")
    ap.add_argument("--modes", type=str, default="bhj,smj")
    ap.add_argument("--json-out", type=str, default="")
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--child-matrix", action="store_true",
                    help="internal: run the matrix in this process")
    ap.add_argument("--device", default="cuda",
                    help="torch device every child runs on (default: the "
                         "CUDA card; --device cpu runs on the host)")
    args = ap.parse_args(argv)
    from blaze_tpu_torch.tools import refuse_device

    if refuse_device("compile_warm_bench", args.device):
        return 2
    if args.child_matrix:
        return _matrix_child(args)
    rows = int(args.rows.split(",")[0])

    work = tempfile.mkdtemp(prefix="blaze_torch_cwb_root_")
    build = os.path.join(work, "build")
    env = dict(os.environ)
    env.update({
        "BLAZE_TPU_TORCH_BUILD_DIR": build,
        "BLAZE_TPU_COMPILE_MANIFEST": os.path.join(build, MANIFEST),
        "BLZ_DEVICE": args.device,
        "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
    })
    child = [sys.executable, "-m", "blaze_tpu_torch.tools.compile_warm_bench",
             "--child-matrix", "--queries", args.queries,
             "--device", args.device]
    p1_rows = ",".join([str(rows)] +
                       [s for s in args.extra_scales.split(",") if s])

    try:
        t_first, first = _run_child(
            env, child + ["--rows", p1_rows, "--passes", "1"], "phase1-cold")
        built = sorted(os.listdir(build)) if os.path.isdir(build) else []

        _clear_xla_cache_keep_manifest(build)
        t_warmup, _ = _run_child(
            env, [sys.executable, "-m",
                  "blaze_tpu_torch.runtime.compile_service",
                  "--warm", "--queries", args.queries, "--rows",
                  str(rows), "--modes", args.modes,
                  "--num-partitions", "4", "--device", args.device],
            "phase2-warm-driver")

        _, final = _run_child(
            env, child + ["--rows", str(rows), "--passes", "2"],
            "phase3-cold-then-warm")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    t_cold_warmed = final["passes"][0]["seconds"]
    t_warm = final["passes"][1]["seconds"]
    red = final["shape_reduction"]
    sj = {k: v for k, v in red.items()
          if k.startswith(("sort", "join"))}
    raw = sum(v["raw_rowcounts"] for v in sj.values())
    canon = sum(v["canonical_capacities"] for v in sj.values())
    doc = {
        "note": "compile-service acceptance bench: tpcds mini-matrix "
                f"({args.queries}) at {rows} rows on {args.device}. "
                "phase1 = everything cold (empty build directory and "
                "manifest, plus one pass per extra scale to populate the "
                "manifest with a realistic input-size population); phase2 "
                "= libraries deleted, manifest kept, warm driver rebuilds "
                "them and replays; phase3 = fresh process with the "
                "libraries on disk runs the matrix twice (the "
                "seconds_cold_jit_warm_xla pass, then seconds_warm). "
                "Acceptance: "
                "cold_warmed <= 2x warm; sort/join raw row-count space "
                "collapses >= 4x onto canonical rungs (read from the "
                "cumulative manifest).",
        "device": args.device,
        "rows": rows, "extra_scales": args.extra_scales,
        "queries": args.queries,
        "phase1_passes": first["passes"],
        "phase1_libraries": first["libraries"],
        "phase1_build_dir": built,
        "phase3_libraries": final["libraries"],
        "seconds_first_everything_cold": round(t_first, 2),
        "seconds_warm_driver": round(t_warmup, 2),
        "seconds_cold_jit_warm_xla": t_cold_warmed,
        "seconds_warm": t_warm,
        "cold_over_warm_ratio": round(t_cold_warmed / max(t_warm, 1e-9), 3),
        "acceptance_cold_le_2x_warm": t_cold_warmed <= 2 * t_warm,
        "telemetry_cold_pass": final["passes"][0]["telemetry"],
        "telemetry_warm_pass": final["passes"][1]["telemetry"],
        "shape_reduction": red,
        "sortjoin_raw_rowcounts": raw,
        "sortjoin_canonical_capacities": canon,
        "sortjoin_reduction_factor": round(raw / max(canon, 1), 2),
        "acceptance_shape_reduction_ge_4x": raw >= 4 * canon,
    }
    print(json.dumps(doc, indent=1))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    ok = doc["acceptance_cold_le_2x_warm"] and \
        doc["acceptance_shape_reduction_ge_4x"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
