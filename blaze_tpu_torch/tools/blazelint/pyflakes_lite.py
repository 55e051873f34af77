"""Pyflakes-equivalent pass: syntax, unused imports, undefined names.

Stdlib-only (``compile()`` + ``ast``) so the repo needs no external
linter. Deliberately conservative where real pyflakes is scope-precise:

  * **syntax-error** (error): ``compile(source, ..., "exec")`` fails.
  * **unused-import** (warning): an imported binding whose name is never
    loaded anywhere in the module (including inside annotations — the
    tree keeps them under ``from __future__ import annotations``) and is
    not re-exported via ``__all__``. ``__init__.py`` re-export idiom and
    intentionally-unused (``import x  # blazelint: ignore`` /
    ``as _x``) bindings are skipped.
  * **undefined-name** (error): a ``Name`` load that matches *no*
    binding anywhere in the module (imports, assignments, defs, params,
    comprehension targets, walrus, except-as, globals) and no builtin.
    Module-flat on purpose: it can miss scope leaks but cannot
    false-positive on closures.
"""

from __future__ import annotations

import ast
import builtins
from typing import Dict, Iterable, List, Set

from blaze_tpu_torch.tools.blazelint.core import Checker, Finding, ModuleInfo

_BUILTINS = set(dir(builtins)) | {"__file__", "__name__", "__doc__",
                                  "__package__", "__spec__", "__loader__",
                                  "__builtins__", "__debug__", "__path__",
                                  "__class__"}


def _bindings(tree: ast.Module) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and isinstance(
                node.ctx, (ast.Store, ast.Del)):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.arg):
            names.add(node.arg)
        elif isinstance(node, ast.alias):
            names.add((node.asname or node.name).split(".")[0])
        elif isinstance(node, ast.ExceptHandler) and node.name:
            names.add(node.name)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            names.update(node.names)
    return names


class PyflakesLite(Checker):
    name = "pyflakes"

    def check_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        # generated code (protobuf builders inject names via globals())
        # can't be name-checked statically
        if mod.rel.endswith("_pb2.py") or \
                "Generated by the protocol buffer compiler" in \
                mod.source[:400]:
            return ()
        if mod.syntax_error is not None:
            e = mod.syntax_error
            return [Finding(
                checker=self.name, rule="syntax-error",
                path=mod.rel, line=e.lineno or 1, severity="error",
                message=f"syntax error: {e.msg}", symbol=str(e.lineno))]
        try:
            compile(mod.source, mod.rel, "exec")
        except SyntaxError as e:
            return [Finding(
                checker=self.name, rule="syntax-error",
                path=mod.rel, line=e.lineno or 1, severity="error",
                message=f"syntax error: {e.msg}", symbol=str(e.lineno))]
        findings: List[Finding] = []
        findings.extend(self._unused_imports(mod))
        findings.extend(self._undefined_names(mod))
        return findings

    def _unused_imports(self, mod: ModuleInfo) -> List[Finding]:
        if mod.rel.endswith("__init__.py"):
            return []  # re-export surface
        imported: Dict[str, int] = {}
        star = False
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    imported[(a.asname or a.name).split(".")[0]] = \
                        node.lineno
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for a in node.names:
                    if a.name == "*":
                        star = True
                        continue
                    imported[a.asname or a.name] = node.lineno
        if star or not imported:
            return []
        used: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                used.add(node.id)
            elif isinstance(node, ast.Constant) and \
                    isinstance(node.value, str):
                pass  # doctest/strings don't count as use
        exported: Set[str] = set()
        for node in mod.tree.body:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == "__all__":
                        for e in ast.walk(node.value):
                            if isinstance(e, ast.Constant) and \
                                    isinstance(e.value, str):
                                exported.add(e.value)
        findings = []
        for name, line in sorted(imported.items()):
            if name in used or name in exported or name.startswith("_"):
                continue
            findings.append(Finding(
                checker=self.name, rule="unused-import",
                path=mod.rel, line=line, severity="warning",
                message=f"{name!r} imported but unused", symbol=name))
        return findings

    def _undefined_names(self, mod: ModuleInfo) -> List[Finding]:
        bound = _bindings(mod.tree) | _BUILTINS
        findings = []
        seen: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Name) and \
                    isinstance(node.ctx, ast.Load) and \
                    node.id not in bound and node.id not in seen:
                seen.add(node.id)
                findings.append(Finding(
                    checker=self.name, rule="undefined-name",
                    path=mod.rel, line=node.lineno, severity="error",
                    message=f"undefined name {node.id!r}", symbol=node.id))
        return findings
