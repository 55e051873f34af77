"""Hot-path gating checker.

The documented observability posture (README "Observability", ops/base
``count_stream``): with a subsystem off, each instrumentation call site
on the hot path costs exactly ONE truthiness check. This checker makes
the posture mechanical: in hot modules (``ops/``, ``columnar/``,
``runtime/pipeline.py``) every call into a trace/monitor/history/faults
*record* function must be dominated by its gate —

    trace.event/on_batch/record_value/...  ->  conf.trace_enabled
    monitor.count_copy/count_move/...      ->  conf.monitor_enabled
    history.observe_*/record_run           ->  conf.history_dir
                                               (or `history is not None`,
                                                the import-gate pattern)
    faults.inject                          ->  conf.fault_injection_spec

A call is *dominated* when (a) an enclosing ``if`` test mentions the
gate (the knob itself, or a local alias assigned from it), or (b) an
earlier statement in the same function is an early-return guard
(``if not <gate>...: return``). ``trace.span(...)`` is exempt: it
returns a shared null span when disabled, the documented pattern for
with-statement sites.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from blaze_tpu_torch.tools.blazelint.core import (PACKAGE, Checker, Finding,
                                                  ModuleInfo)

# hot modules, inside the package
HOT_PREFIXES = ("ops/", "columnar/")
HOT_FILES = ("runtime/pipeline.py",)

# module alias -> (record functions, gate tokens)
RECORD_FUNCS: Dict[str, Tuple[Set[str], Tuple[str, ...]]] = {
    "trace": ({"event", "on_batch", "record_value", "counter"},
              ("trace_enabled",)),
    "monitor": ({"count_copy", "count_move", "note_leak", "observe"},
                ("monitor_enabled",)),
    "history": ({"observe_rows", "observe_groups", "record_run"},
                ("history_dir", "history")),
    "faults": ({"inject"}, ("fault_injection_spec",)),
    "progress": ({"on_batch"}, ("progress_enabled", "progress")),
    "profiler": ({"ensure_started", "sample_once", "merge_remote",
                  "export_query"},
                 ("profile_enabled",)),
}


def is_hot(rel: str, package: str = PACKAGE) -> bool:
    prefix = package + "/"
    if not rel.startswith(prefix):
        return False
    rel = rel[len(prefix):]
    return rel.startswith(HOT_PREFIXES) or rel in HOT_FILES


def _mentions_token(test: ast.AST, tokens: Sequence[str],
                    aliases: Set[str]) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Attribute) and n.attr in tokens:
            return True
        if isinstance(n, ast.Name) and (n.id in tokens or n.id in aliases):
            return True
    return False


class HotPathGating(Checker):
    name = "hot-path-gating"

    def __init__(self, hot_predicate=None, package: str = PACKAGE) -> None:
        self._is_hot = hot_predicate or (lambda rel: is_hot(rel, package))

    def check_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        if not self._is_hot(mod.rel):
            return ()
        findings: List[Finding] = []
        parents = mod.parents()
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            target = self._record_target(node)
            if target is None:
                continue
            alias, fname, tokens = target
            func = self._owner_function(parents, node)
            aliases = self._gate_aliases(func, tokens) if func else set()
            if self._dominated(parents, func, node, tokens, aliases):
                continue
            qual = self._qualname(parents, node)
            findings.append(Finding(
                checker=self.name, rule="ungated-record",
                path=mod.rel, line=node.lineno, severity="error",
                message=(f"hot-path call {alias}.{fname}() in {qual} is "
                         f"not dominated by its gate "
                         f"(conf.{tokens[0]} truthiness check)"),
                symbol=f"{qual}.{alias}.{fname}"))
        return findings

    # -- resolution --------------------------------------------------------

    @staticmethod
    def _record_target(node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            alias = f.value.id
            entry = RECORD_FUNCS.get(alias)
            if entry and f.attr in entry[0]:
                return alias, f.attr, entry[1]
        return None

    @staticmethod
    def _owner_function(parents, node):
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = parents.get(cur)
        return None

    @staticmethod
    def _qualname(parents, node) -> str:
        parts = []
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = parents.get(cur)
        return ".".join(reversed(parts)) or "<module>"

    @staticmethod
    def _gate_aliases(func, tokens: Sequence[str]) -> Set[str]:
        """Local names assigned from a gate knob (``stats = conf.X``)."""
        aliases: Set[str] = set()
        for n in ast.walk(func):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name):
                v = n.value
                if isinstance(v, ast.Attribute) and v.attr in tokens:
                    aliases.add(n.targets[0].id)
        return aliases

    def _dominated(self, parents, func, call: ast.Call,
                   tokens: Sequence[str], aliases: Set[str]) -> bool:
        # (a) enclosing if/while test mentions the gate (also covers
        #     `history is not None` via the bare-name token "history")
        cur = parents.get(call)
        child = call
        while cur is not None and cur is not func:
            if isinstance(cur, (ast.If, ast.While)) and \
                    child in getattr(cur, "body", ()):
                if _mentions_token(cur.test, tokens, aliases):
                    return True
            if isinstance(cur, ast.IfExp) and \
                    _mentions_token(cur.test, tokens, aliases):
                return True
            child = cur
            cur = parents.get(cur)
        # (b) early-return guard earlier in the same function:
        #     `if not conf.X...: return/raise/continue`
        if func is not None:
            for n in ast.walk(func):
                if not isinstance(n, ast.If) or n.lineno >= call.lineno:
                    continue
                if not _mentions_token(n.test, tokens, aliases):
                    continue
                body = n.body
                if body and isinstance(body[-1], (ast.Return, ast.Raise,
                                                  ast.Continue)):
                    return True
        return False
