"""blazelint CLI — `python -m blaze_tpu_torch.tools.blazelint` from the
repo root.

Exit status: 0 when every finding is baselined/suppressed, 1 when new
findings exist, 2 on usage errors. `--json-out` writes the report
(per-checker counts, baseline size, runtime)."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from blaze_tpu_torch.tools.blazelint import (PACKAGE, default_checkers,
                                             load_baseline, run_checkers,
                                             save_baseline)

REPO_ROOT = Path(__file__).resolve().parents[3]
BASELINE = Path(__file__).resolve().parent / "baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="blazelint",
        description="AST invariant checkers for the engine's runtime")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs relative to the repo root "
                         "(default: the package)")
    ap.add_argument("--root", type=Path, default=REPO_ROOT)
    ap.add_argument("--package", default=PACKAGE,
                    help="the package whose config, registries, doctor, "
                         f"autopilot and hot modules are read (default: "
                         f"{PACKAGE})")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="suppression baseline (default: "
                         "blaze_tpu_torch/tools/blazelint/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report everything)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write every current finding into the baseline, "
                         "keeping existing justifications")
    ap.add_argument("--json-out", type=Path, default=None,
                    help="write the machine-readable report/artifact here")
    ap.add_argument("--max-findings", type=int, default=200,
                    help="cap on printed findings (default 200)")
    args = ap.parse_args(argv)

    root = args.root.resolve()
    args.paths = args.paths or [args.package]
    baseline_path = args.baseline or BASELINE
    baseline = {} if args.no_baseline else load_baseline(baseline_path)

    checkers = default_checkers(root, package=args.package)
    result = run_checkers(root, args.paths, checkers, baseline)

    if args.update_baseline:
        save_baseline(baseline_path, result.findings + result.baselined,
                      old=baseline)
        print(f"baseline written: {baseline_path} "
              f"({len(result.findings) + len(result.baselined)} findings)")
        return 0

    for f in result.findings[:args.max_findings]:
        print(f.render())
        print(f"    id: {f.id}")
    if len(result.findings) > args.max_findings:
        print(f"... {len(result.findings) - args.max_findings} more")
    n_err = sum(1 for f in result.findings if f.severity == "error")
    n_warn = len(result.findings) - n_err
    summary = (f"blazelint: {result.files_scanned} files, "
               f"{n_err} errors, {n_warn} warnings "
               f"({len(result.baselined)} baselined, "
               f"{len(result.stale_baseline)} stale baseline entries) "
               f"in {result.runtime_s:.2f}s")
    print(summary)
    if result.stale_baseline:
        print("stale baseline ids (fixed findings — prune them):")
        for fid in result.stale_baseline:
            print(f"    {fid}")

    if args.json_out is not None:
        report = {
            "tool": "blazelint",
            "paths": list(args.paths),
            "files_scanned": result.files_scanned,
            "runtime_s": round(result.runtime_s, 3),
            "per_checker": result.per_checker,
            "baseline_size": len(baseline),
            "baselined": len(result.baselined),
            "stale_baseline": result.stale_baseline,
            "new_findings": [
                {"id": f.id, "path": f.path, "line": f.line,
                 "checker": f.checker, "rule": f.rule,
                 "severity": f.severity, "message": f.message}
                for f in result.findings
            ],
            "ok": not result.findings,
        }
        args.json_out.write_text(json.dumps(report, indent=2) + "\n",
                                 encoding="utf-8")
        print(f"report written: {args.json_out}")

    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
