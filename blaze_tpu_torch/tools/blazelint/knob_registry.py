"""Knob-registry checker.

Three-way sync between the declarative knob registry in
``<package>/config.py`` (``KNOBS``), the runtime's ``conf.<name>``
accesses, and the README knob catalog:

  * **undeclared-knob** (error): a ``conf.<name>`` access (attribute
    read/write, or a ``conf.update(name=...)`` keyword) that resolves to
    no declared knob and no public ``BlazeConf`` method. This is the
    static version of ``BlazeConf.update``'s ``KeyError`` — it catches
    the typo before a query runs.
  * **dead-knob** (error): a declared knob never read anywhere in the
    scanned tree. Dead knobs rot: their doc string promises behavior no
    code implements.
  * **undocumented-knob** (error): a declared knob whose name never
    appears in README.md — the catalog there is the user-facing contract.

The registry is loaded by executing ``config.py`` standalone (by file
path — never an import of the package, whose ``__init__`` pulls in
torch or jax).
Tests inject a synthetic registry/README instead.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

from blaze_tpu_torch.tools.blazelint.core import (PACKAGE, Checker, Finding,
                                                  ModuleInfo,
                                                  load_config_module,
                                                  package_rel)

CONF_NAMES = {"conf"}  # names the config singleton is bound to


class KnobRegistry(Checker):
    name = "knob-registry"

    def __init__(self, root: Optional[Path] = None,
                 knobs: Optional[Dict[str, object]] = None,
                 methods: Optional[Set[str]] = None,
                 readme_text: Optional[str] = None,
                 config_rel: Optional[str] = None,
                 package: str = PACKAGE) -> None:
        config_rel = config_rel or package_rel(package, "config.py")
        self.config_rel = config_rel
        if knobs is None:
            assert root is not None
            cfg = load_config_module(root / config_rel)
            knobs = dict(cfg.KNOBS)
            methods = {n for n in dir(cfg.BlazeConf)
                       if not n.startswith("_")
                       and callable(getattr(cfg.BlazeConf, n))} - set(knobs)
            readme = root / "README.md"
            readme_text = readme.read_text(encoding="utf-8") \
                if readme.exists() else ""
        self.knobs = knobs
        self.methods = methods or set()
        self.readme_text = readme_text or ""
        self._reads: Set[str] = set()
        self._decl_lines: Dict[str, int] = {}

    # -- helpers -----------------------------------------------------------

    def _is_conf(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name) and node.id in CONF_NAMES:
            return True
        # blaze_tpu_torch.config.conf / config.conf
        return isinstance(node, ast.Attribute) and node.attr == "conf"

    # -- per module --------------------------------------------------------

    def check_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        if mod.rel == self.config_rel:
            for node in ast.walk(mod.tree):
                # record knob declaration lines for finalize()'s findings
                if isinstance(node, ast.Call) and node.args and \
                        isinstance(node.func, ast.Name) and \
                        node.func.id == "Knob" and \
                        isinstance(node.args[0], ast.Constant):
                    self._decl_lines[node.args[0].value] = node.lineno
                # BlazeConf helper methods reading knobs through self
                # (op_enabled -> enable_ops) count as reads
                elif isinstance(node, ast.Attribute) and \
                        isinstance(node.ctx, ast.Load) and \
                        isinstance(node.value, ast.Name) and \
                        node.value.id == "self" and node.attr in self.knobs:
                    self._reads.add(node.attr)
            return ()
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) and self._is_conf(node.value):
                name = node.attr
                if name in self.knobs:
                    if isinstance(node.ctx, ast.Load):
                        self._reads.add(name)
                    continue
                if name in self.methods:
                    if name == "update":
                        continue  # keywords handled below via Call
                    continue
                findings.append(Finding(
                    checker=self.name, rule="undeclared-knob",
                    path=mod.rel, line=node.lineno, severity="error",
                    message=(f"conf.{name} resolves to no knob declared "
                             f"in {self.config_rel} (KNOBS) and no "
                             f"BlazeConf method"),
                    symbol=name))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "update" and \
                    self._is_conf(node.func.value):
                for kw in node.keywords:
                    if kw.arg is not None and kw.arg not in self.knobs:
                        findings.append(Finding(
                            checker=self.name, rule="undeclared-knob",
                            path=mod.rel, line=node.lineno,
                            severity="error",
                            message=(f"conf.update({kw.arg}=...) sets an "
                                     f"undeclared knob (would raise "
                                     f"KeyError at runtime)"),
                            symbol=kw.arg))
        return findings

    def finalize(self, modules: Sequence[ModuleInfo]) -> Iterable[Finding]:
        findings: List[Finding] = []
        for name in sorted(self.knobs):
            line = self._decl_lines.get(name, 1)
            if name not in self._reads:
                findings.append(Finding(
                    checker=self.name, rule="dead-knob",
                    path=self.config_rel, line=line, severity="error",
                    message=(f"knob {name!r} is declared but never read "
                             f"in the scanned tree — delete it or wire "
                             f"it up"),
                    symbol=name))
            if name not in self.readme_text:
                findings.append(Finding(
                    checker=self.name, rule="undocumented-knob",
                    path=self.config_rel, line=line, severity="error",
                    message=(f"knob {name!r} is not documented in "
                             f"README.md (knob catalog)"),
                    symbol=name))
        return findings
