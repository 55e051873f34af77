"""Doctor↔knob sync checker.

The self-tuning autopilot (``runtime/autopilot.py``) parses the top
doctor finding's ``suggestion`` string for a ``conf.<knob>`` mention and
steps that knob — so the suggestion text is machine-actuated, not
advisory prose. Two invariants keep that loop closed:

  * **unactionable-suggestion** (error): every ``Finding(...)``
    constructed in ``runtime/doctor.py`` must name at least one declared
    Knob as ``conf.<name>`` in its suggestion, and every ``conf.<name>``
    it mentions must resolve in the ``KNOBS`` registry. A typo'd or
    free-form suggestion silently disables the autopilot for that
    finding class (and misleads the operator reading the dossier).
  * **actuator-schedule** (error): every knob in autopilot's
    ``ACTUATORS`` registry must be declared in ``KNOBS`` with a full
    step schedule (``step``/``min``/``max`` all set) — the explorer
    refuses to move a knob without declared rails, so a schedule-less
    actuator is dead weight that LOOKS autotunable.

The knob registry is loaded by executing ``config.py`` standalone (the
knob-registry checker's posture — never an import of the package);
``ACTUATORS`` is extracted from the autopilot module's AST.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from blaze_tpu_torch.tools.blazelint.core import (PACKAGE, Checker, Finding,
                                                  ModuleInfo, call_name,
                                                  load_config_module,
                                                  module_registry,
                                                  package_rel)

DOCTOR_REL = "runtime/doctor.py"        # inside the package
AUTOPILOT_REL = "runtime/autopilot.py"

_KNOB_RE = re.compile(r"conf\.([a-z0-9_]+)")


def _static_text(node: ast.AST) -> str:
    """Best-effort static text of a suggestion expression: plain (and
    implicitly concatenated) literals come back whole; f-strings and
    ``+``/``%``/``.format`` constructions contribute their literal parts
    — enough to see every ``conf.<name>`` mention, which doctor never
    builds dynamically."""
    parts: List[str] = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            parts.append(sub.value)
    return "".join(parts)


class DoctorKnobSync(Checker):
    name = "doctor-knob-sync"

    def __init__(self, root: Optional[Path] = None,
                 knobs: Optional[Dict[str, object]] = None,
                 config_rel: Optional[str] = None,
                 package: str = PACKAGE) -> None:
        config_rel = config_rel or package_rel(package, "config.py")
        self.doctor_rel = package_rel(package, DOCTOR_REL)
        self.autopilot_rel = package_rel(package, AUTOPILOT_REL)
        if knobs is None:
            assert root is not None
            knobs = dict(load_config_module(root / config_rel).KNOBS)
        self.knobs = knobs
        self._suggestions: List[Tuple[ModuleInfo, ast.Call, str]] = []
        self._actuators: Optional[List[str]] = None
        self._autopilot_seen = False

    # -- per module --------------------------------------------------------

    def check_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        if mod.rel == self.autopilot_rel:
            self._autopilot_seen = True
            self._actuators = module_registry(mod.tree, "ACTUATORS")
        if mod.rel != self.doctor_rel:
            return ()
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or \
                    call_name(node) != "Finding":
                continue
            sugg: Optional[ast.AST] = None
            if len(node.args) >= 4:
                sugg = node.args[3]
            for kw in node.keywords:
                if kw.arg == "suggestion":
                    sugg = kw.value
            if sugg is not None:
                self._suggestions.append((mod, node, _static_text(sugg)))
        return ()

    # -- finalize ----------------------------------------------------------

    def finalize(self, modules: Sequence[ModuleInfo]) -> Iterable[Finding]:
        findings: List[Finding] = []
        for mod, node, text in self._suggestions:
            names = _KNOB_RE.findall(text)
            declared = [n for n in names if n in self.knobs]
            for n in names:
                if n not in self.knobs:
                    findings.append(Finding(
                        checker=self.name, rule="unactionable-suggestion",
                        path=mod.rel, line=node.lineno, severity="error",
                        message=(f"Finding suggestion mentions "
                                 f"conf.{n}, which is not a declared "
                                 f"knob in config.KNOBS"),
                        symbol=n))
            if not declared:
                findings.append(Finding(
                    checker=self.name, rule="unactionable-suggestion",
                    path=mod.rel, line=node.lineno, severity="error",
                    message=("Finding suggestion names no declared "
                             "conf.<knob> — the autopilot (and the 3am "
                             "operator) cannot act on it"),
                    symbol="suggestion"))
        if self._autopilot_seen:
            if self._actuators is None:
                findings.append(Finding(
                    checker=self.name, rule="missing-registry",
                    path=self.autopilot_rel, line=1, severity="error",
                    message=("module-level registry ACTUATORS not found "
                             "in runtime/autopilot.py"),
                    symbol="ACTUATORS"))
            else:
                findings.extend(self._check_actuators())
        return findings

    def _check_actuators(self) -> List[Finding]:
        findings: List[Finding] = []
        for name in self._actuators or []:
            knob = self.knobs.get(name)
            if knob is None:
                findings.append(Finding(
                    checker=self.name, rule="actuator-schedule",
                    path=self.autopilot_rel, line=1, severity="error",
                    message=(f"ACTUATORS entry {name!r} is not a "
                             f"declared knob in config.KNOBS"),
                    symbol=name))
                continue
            missing = [f for f in ("step", "min", "max")
                       if getattr(knob, f, None) is None]
            if missing:
                findings.append(Finding(
                    checker=self.name, rule="actuator-schedule",
                    path=self.autopilot_rel, line=1, severity="error",
                    message=(f"actuatable knob {name!r} declares no "
                             f"{'/'.join(missing)} — the explorer "
                             f"cannot step a knob without rails"),
                    symbol=name))
        return findings
