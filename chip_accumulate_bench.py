"""Timing of the digit-plane accumulate kernel chain against other designs,
on one NVIDIA GPU.

    python3 chip_accumulate_bench.py [--variant-cu PATH ...]
                                     [--baseline-cu PATH] [--parent-tree DIR]
                                     [--spare-slots N ...]

Runs from the repo root on a CUDA card with nvcc. At the main path's shape
(chip_smoke.py's kernel-phase inputs: 2^21 rows, 2^16 keys, 7 planes,
3 words, about 45% of rows kept), for each of chip_smoke.py's key
distributions (uniform; 90% of rows on 8 keys in 8 key slices, or in one;
one key), it measures:

  * the kernel chain of blaze_tpu_torch/csrc/mxu_accumulate.cu, first held
    torch.equal to the plain version; kernel-only device time from the
    profiler's kernel durations, split by kernel;
  * with --variant-cu, each other source with the same C entry points
    (an edited copy of mxu_accumulate.cu), built beside it, held to the
    plain version and timed the same way;
  * with --baseline-cu, another source with the one-row-per-thread C entry
    `mxu_accumulate(keys, ok, word_ptrs, n_words, recipe, n_planes, n, out,
    device, stream)` that adds into a zeroed int32 (gh, P, 128) table with
    one global atomic per digit (the design of commit f43975b; extract it
    with `git show f43975b:blaze_tpu_torch/csrc/mxu_accumulate.cu >
    _checkout/rowwise.cu`), held to the plain version and timed the same
    way, kernel-only and with its table's zeroing;
  * one `index_add_` into the carry on precomputed indices (yardstick);
  * with --parent-tree, the main path of chip_smoke.py (bench.py's q06 plan,
    64 x 2^21 rows) and its general_agg phase (the same rows grouped by
    2 M nullable customer keys through the streaming AggExec) run from
    that checkout and from this one, in turns (parent, this, this,
    parent), each in its own process: for q06 the median rep time and,
    from torch.profiler over one rep, the device launches and busy time by
    kernel; for general_agg the phase's median rep, device busy time and
    idle share. Unpack the other checkout with `git archive <commit> | tar
    -x -C _checkout/parent`.
  * with --spare-slots, chip_smoke.py's general_agg plan (64 x 2^21 rows
    grouped by 2 M nullable customer keys, through the streaming AggExec)
    with ops/segment.py's `_SPARE` (the slots past the end that take the
    masked rows of a segment scatter) set to each value in turns (a, b,
    b, a), every run held to the first one's result: the median rep time
    and one profiled rep's device busy time and top operations.

Every ratio it prints is of two times from this one run. It prints one JSON
line per measurement, then the card's nvidia-smi line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from blaze_tpu_torch import kernels
from blaze_tpu_torch.ops import mxu_agg


def _build(src: Path, tag: str) -> ctypes.CDLL:
    out = kernels.BUILD_DIR / f"lib{src.stem}-{tag}.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def _load_variant(src: Path) -> ctypes.CDLL:
    lib = _build(src, "variant")
    for fn, (argtypes, restype) in kernels.SIGNATURES[
            "mxu_accumulate"].items():
        f = getattr(lib, fn)
        f.argtypes, f.restype = argtypes, restype
    return lib


def _load_baseline(src: Path) -> ctypes.CDLL:
    lib = _build(src, "baseline")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mxu_accumulate.argtypes = [P, P, P, I, P, I, ctypes.c_longlong, P,
                                   I, P]
    lib.mxu_accumulate.restype = I
    lib.mxu_accumulate_error.argtypes = [I]
    lib.mxu_accumulate_error.restype = ctypes.c_char_p
    return lib


def _baseline_call(lib, keys, valid, words, recipe, gh):
    """The row-per-thread kernel's launch into its int32 table, zeroed
    first as its wrapper did, with every other host step done."""
    ok = valid.to(torch.int32)
    P, W = len(recipe), len(words)
    out = torch.zeros(gh * P * 128, dtype=torch.int32, device=keys.device)
    rc, _ = mxu_agg._recipe_arg(recipe)
    ptrs = (ctypes.c_void_p * W)(*[w.data_ptr() for w in words])
    stream = torch.cuda.current_stream(keys.device).cuda_stream

    def launch():
        out.zero_()
        err = lib.mxu_accumulate(
            keys.data_ptr(), ok.data_ptr(), ctypes.addressof(ptrs), W,
            ctypes.addressof(rc), P, keys.shape[0], out.data_ptr(),
            keys.device.index or 0, stream)
        if err != 0:
            raise RuntimeError(lib.mxu_accumulate_error(err).decode())

    launch.keep = (ok, ptrs, rc)
    return launch, out


# one main-path run in a checkout of the port, as its own process
_REP_PROBE = r"""
import json, sys
sys.path.insert(0, ".")
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
cs.phase_build()
main = cs.phase_main_path({"ms": 0.0})
plan, med = main["plan"], main["rep_s"]
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    cs.collect_fetch(plan, cs._digest)
    torch.cuda.synchronize()
by = {}
for e in prof.key_averages():
    if "CUDA" in str(getattr(e, "device_type", "")):
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        c, t = by.get(e.key[:90], (0, 0.0))
        by[e.key[:90]] = (c + int(e.count), t + float(us) / 1e3)
general = cs.phase_general_agg(main["datas"], main["batches"])
if isinstance(general, tuple):  # trees since the shuffle slice
    general = general[0]
print("REP " + json.dumps({
    "median_rep_s": med, "device_launches": sum(c for c, _ in by.values()),
    "device_busy_ms": sum(t for _, t in by.values()), "by_kernel": by,
    "general_agg": {k: general[k] for k in (
        "median_rep_s", "rep_s", "device_busy_ms", "idle_share",
        "host_pulls_per_rep", "collapses_per_rep",
        "top100_median_rep_s")}}))
"""


def _rep_probe(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", _REP_PROBE], cwd=tree,
                         capture_output=True, text=True, check=True,
                         timeout=600).stdout
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("REP ")][-1][4:])


def _plain_table(keys, valid, words, recipe, rng):
    acc = torch.zeros(((rng + 127) // 128, len(recipe), 128),
                      dtype=torch.int64, device=keys.device)
    mxu_agg._accumulate_into_ref(acc, keys, valid, words, recipe, rng)
    return acc


def _time_chain(lib, design, case, k, v, words, recipe, rng, want):
    """The chain of one built library, held to the plain table and timed
    kernel-only; the library stands in for the tree's own meanwhile."""
    own = kernels._libs["mxu_accumulate"]
    kernels._libs["mxu_accumulate"] = lib
    try:
        acc = torch.zeros_like(want)
        launch = mxu_agg._chain_call(acc, k, v, words, recipe, rng)
        launch()
        torch.cuda.synchronize()
        if not torch.equal(acc, want):
            raise AssertionError(f"{design} != plain at {case}")
        ms, split = cs._profiled_ms(launch)
        stretch = cs._stretch_ms(launch)
    finally:
        kernels._libs["mxu_accumulate"] = own
    cs._emit({"case": case, "design": design, "ms": ms,
              "stretch_ms": stretch, "split": split})
    return ms


def _spare_slots_ab(values) -> None:
    """general_agg's plan under each `_SPARE` value, in turns."""
    import numpy as np

    from blaze_tpu_torch.columnar.batch import ColumnBatch
    from blaze_tpu_torch.ops import segment
    from blaze_tpu_torch.plan.from_proto import decode_task_definition
    from blaze_tpu_torch.runtime import resources
    from blaze_tpu_torch.runtime.executor import collect_fetch

    batches = [ColumnBatch.from_numpy(cs._make_data(s), cs.SCHEMA,
                                      capacity=cs.ROWS)
               for s in range(cs.GENERAL_BATCHES)]
    gb = cs._general_batches(batches, [cs._make_customers(s)
                                       for s in range(len(batches))])
    rid = resources.register(lambda: iter(gb))
    plan, _ = decode_task_definition(cs._build_task(
        cs.GENERAL_SCHEMA_PB, rid, key="ss_customer_sk",
        aggs=cs.GENERAL_AGGS))
    ncols = 1 + len(cs.GENERAL_AGGS)
    want = None
    for n in list(values) + list(values)[::-1]:
        segment._SPARE = n
        packed = collect_fetch(plan, cs._full)
        if want is None:
            want = packed
        np.testing.assert_allclose(packed, want, rtol=1e-9)
        times = cs._timed_reps(plan, packed, ncols)
        rows, busy_ms = cs._device_profile(
            lambda: collect_fetch(plan, cs._digest))
        cs._emit({"spare_slots": n, "rep_s": times,
                  "median_rep_s": float(np.median(times)),
                  "device_busy_ms": busy_ms, "top": cs._top(rows, 8)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant-cu", type=Path, action="append", default=[])
    ap.add_argument("--baseline-cu", type=Path, default=None)
    ap.add_argument("--parent-tree", type=Path, default=None)
    ap.add_argument("--spare-slots", type=int, nargs="+", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_accumulate_bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    designs = {"chain": kernels.load("mxu_accumulate")}
    for src in args.variant_cu:
        designs[src.stem] = _load_variant(src)
    base = _load_baseline(args.baseline_cu) if args.baseline_cu else None
    rng = cs.GROUPS
    gh = rng // 128
    summary = {}
    for case, (k, v, words, recipe) in cs.main_path_inputs().items():
        want = _plain_table(k, v, words, recipe, rng)
        P = len(recipe)
        row = summary.setdefault(case, {})
        for design, lib in designs.items():
            row[design] = _time_chain(lib, design, case, k, v, words, recipe,
                                      rng, want)
        if base is not None:
            launch, out = _baseline_call(base, k, v, words, recipe, gh)
            launch()
            torch.cuda.synchronize()
            if not torch.equal(out.view(gh, P, 128).to(torch.int64), want):
                raise AssertionError(f"row-per-thread design != plain at "
                                     f"{case}")
            ms, split = cs._profiled_ms(launch)
            kern = sum(t for name, (t, _) in split.items()
                       if "mxu_accumulate_kernel" in name)
            cs._emit({"case": case, "design": "row_per_thread",
                      "ms_with_zeroing": ms, "ms": kern,
                      "stretch_ms": cs._stretch_ms(launch), "split": split})
            row["row_per_thread"] = kern
        idx = mxu_agg._plane_index(k, P).reshape(-1)
        vals = (mxu_agg._expand_words(words, recipe).to(torch.int64)
                * v[:, None]).reshape(-1)
        lib_acc = torch.zeros(want.numel(), dtype=torch.int64,
                              device=k.device)
        row["index_add_"] = cs._stretch_ms(
            lambda: lib_acc.index_add_(0, idx, vals))
    cs._emit({"summary": summary})
    if args.parent_tree is not None:
        trees = [("parent", args.parent_tree), ("this", Path("."))]
        for label, tree in trees + trees[::-1]:
            cs._emit({"main_path_probe": label, **_rep_probe(tree)})
    if args.spare_slots:
        _spare_slots_ab(args.spare_slots)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
