"""The port's copy of blazelint (blaze_tpu_torch/tools/blazelint) against
the JAX package's tools/blazelint.

Pointed at `blaze_tpu` (`package="blaze_tpu"`) with the repo root's
LINT_BASELINE.json, the copy must report exactly the JAX linter's
findings, with the baseline and without it. Over `blaze_tpu_torch` at its
defaults (the port's own config, registries, doctor, autopilot and hot
modules, and its baseline beside the package) it must report nothing new,
leave no baseline entry stale, and every baseline entry must say why.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from blaze_tpu_torch.tools import blazelint as port_lint
from blaze_tpu_torch.tools.blazelint import __main__ as port_main
from blaze_tpu_torch.tools.blazelint import hot_path_gating
from tools import blazelint as jax_lint

REPO = Path(__file__).resolve().parents[1]


def _facts(result):
    return {
        "new": [(f.id, f.path, f.line, f.severity, f.message)
                for f in result.findings],
        "baselined": sorted(f.id for f in result.baselined),
        "stale": result.stale_baseline,
        "files": result.files_scanned,
        "per_checker": result.per_checker,
    }


@pytest.mark.parametrize("baseline", [True, False])
def test_copy_on_the_jax_package_matches_tools_blazelint(baseline):
    ids = (jax_lint.load_baseline(REPO / "LINT_BASELINE.json")
           if baseline else {})
    want = jax_lint.run_checkers(REPO, ["blaze_tpu"],
                                 jax_lint.default_checkers(REPO), ids)
    got = port_lint.run_checkers(
        REPO, ["blaze_tpu"],
        port_lint.default_checkers(REPO, package="blaze_tpu"), ids)
    assert _facts(got) == _facts(want)
    if not baseline:
        assert want.findings  # the comparison has something to compare


def test_port_is_clean_with_every_baseline_entry_justified(capsys):
    assert port_main.main([]) == 0
    out = capsys.readouterr().out
    assert ", 0 errors, 0 warnings" in out and "0 stale" in out
    doc = json.loads(port_main.BASELINE.read_text())
    assert doc["entries"]
    for e in doc["entries"]:
        assert e["id"].split(":")[2].startswith("blaze_tpu_torch/")
        j = e["justification"]
        assert j and not j.startswith("TODO") and len(j) > 40, e["id"]


def test_port_checkers_read_the_ports_registries():
    """Every registry the checkers read is the port's: with them the
    port's tree has no registry-sync, knob or doctor finding beyond the
    baseline, and the hot modules are the port's."""
    result = port_lint.run_checkers(
        REPO, ["blaze_tpu_torch"], port_lint.default_checkers(REPO),
        port_lint.load_baseline(port_main.BASELINE))
    assert result.findings == []
    assert hot_path_gating.is_hot("blaze_tpu_torch/ops/agg.py")
    assert hot_path_gating.is_hot("blaze_tpu_torch/runtime/pipeline.py")
    assert not hot_path_gating.is_hot("blaze_tpu/ops/agg.py")
    assert hot_path_gating.is_hot("blaze_tpu/ops/agg.py", "blaze_tpu")
    syncs = [c for c in port_lint.default_checkers(REPO)
             if c.name == "registry-sync"]
    assert syncs[0].faults_rel == "blaze_tpu_torch/runtime/faults.py"


def test_module_entry_point_exits_zero():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m",
                        "blaze_tpu_torch.tools.blazelint"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 errors, 0 warnings" in r.stdout
