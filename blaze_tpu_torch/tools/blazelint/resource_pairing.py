"""Resource-pairing checker.

Acquire-shaped calls must provably release on every exit path. The
runtime's own conventions (sort/agg wrap SpillFile in try/finally, the
shuffle writer claims the CommitGate inside a try whose except aborts,
pipeline reservations release in the stream finalizer) become rules:

  * **unreleased-acquire** (error): a call to an acquire (``reserve``,
    ``reserve_pipeline``, ``claim``, ``acquire``) that is neither a
    ``with``-statement context, nor inside a ``try`` whose
    finally/except contains the matching release, nor paired at class
    level (the release appears in a teardown-shaped method: ``close``/
    ``stop``/``release*``/``abort``/``__exit__``/``_finalize*``).
  * **unclosed-local** (error): a locally-bound resource construction
    (``SpillFile(...)``, ``open(...)`` outside ``with``) whose handle
    neither escapes the function (returned / yielded / stored on self /
    passed along / registered) nor is closed in a finally/except.
  * **bare-enter** (error): a direct ``.__enter__()`` call with no
    ``.__exit__`` in the same function — span/lock context protocols
    must use ``with``.

Path-sensitivity is deliberately approximate: the goal is to force the
*shape* (with / try-finally / teardown pairing) the runtime already
standardizes on, not to prove liveness.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from blaze_tpu_torch.tools.blazelint.core import (Checker, Finding, ModuleInfo,
                                                  call_name)

# acquire method name -> acceptable release method names
PAIRS: Dict[str, Tuple[str, ...]] = {
    "reserve": ("release",),
    "reserve_pipeline": ("release_pipeline",),
    "claim": ("abort", "release", "close"),
    "acquire": ("release",),
}
# constructors that hand back a close()-owing handle
RESOURCE_CTORS = {"SpillFile": "close", "open": "close"}
TEARDOWN_PREFIXES = ("close", "stop", "release", "abort", "shutdown",
                     "_finalize", "__exit__", "__del__", "quiesce",
                     "_quiesce", "drain", "_drain")


def _enclosing(parents: Dict[ast.AST, ast.AST], node: ast.AST,
               types) -> List[ast.AST]:
    out = []
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, types):
            out.append(cur)
        cur = parents.get(cur)
    return out


def _calls_named(tree: ast.AST, names: Tuple[str, ...]) -> bool:
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and call_name(n) in names:
            return True
    return False


class ResourcePairing(Checker):
    name = "resource-pairing"

    def check_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        findings: List[Finding] = []
        parents = mod.parents()
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # only direct bodies: nested defs get their own visit
            findings.extend(self._check_function(mod, parents, node))
        return findings

    # -- per function ------------------------------------------------------

    def _func_qualname(self, parents, node) -> str:
        parts = [node.name]
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = parents.get(cur)
        return ".".join(reversed(parts))

    def _class_of(self, parents, node) -> Optional[ast.ClassDef]:
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cur = parents.get(cur)
                continue
            cur = parents.get(cur)
        return None

    def _check_function(self, mod: ModuleInfo, parents,
                        func: ast.AST) -> List[Finding]:
        findings: List[Finding] = []
        qual = self._func_qualname(parents, func)
        own_nodes = [n for n in ast.walk(func)
                     if self._owner_function(parents, n) is func]
        cls = self._class_of(parents, func)

        for node in own_nodes:
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in PAIRS and isinstance(node.func, ast.Attribute):
                if name == "acquire" and not self._lockish(node.func):
                    continue
                if not self._release_reachable(parents, func, cls, node,
                                               PAIRS[name]):
                    findings.append(Finding(
                        checker=self.name, rule="unreleased-acquire",
                        path=mod.rel, line=node.lineno, severity="error",
                        message=(f".{name}() in {qual}() has no matching "
                                 f"{'/'.join(PAIRS[name])} reachable via "
                                 f"with / try-finally / except / a "
                                 f"teardown method"),
                        symbol=f"{qual}.{name}"))
            elif name == "__enter__":
                # a context-manager ADAPTER (its own __enter__/__exit__
                # delegate to an inner cm, e.g. trace._SpanCM wrapping
                # trace.context) legitimately splits the pair across
                # methods — require the pair at class level there
                scope = cls if (
                    cls is not None and
                    isinstance(func, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) and
                    func.name in ("__enter__", "__exit__")) else func
                if not _calls_named(scope, ("__exit__",)):
                    findings.append(Finding(
                        checker=self.name, rule="bare-enter",
                        path=mod.rel, line=node.lineno, severity="error",
                        message=(f"direct .__enter__() in {qual}() without "
                                 f".__exit__() — use a with statement"),
                        symbol=f"{qual}.__enter__"))
        findings.extend(self._check_locals(mod, parents, func, qual,
                                           own_nodes))
        return findings

    @staticmethod
    def _lockish(funcattr: ast.Attribute) -> bool:
        """Only flag .acquire() on lock-shaped receivers (``*lock*`` /
        ``*_cv`` / ``*cond*`` names) — `.acquire` is a common verb."""
        v = funcattr.value
        name = ""
        if isinstance(v, ast.Name):
            name = v.id
        elif isinstance(v, ast.Attribute):
            name = v.attr
        low = name.lower()
        return "lock" in low or "cv" in low or "cond" in low

    @staticmethod
    def _owner_function(parents, node) -> Optional[ast.AST]:
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = parents.get(cur)
        return None

    def _release_reachable(self, parents, func, cls, call: ast.Call,
                           releases: Tuple[str, ...]) -> bool:
        # (a) the acquire IS a with-context: `with gate.claim():` etc.
        p = parents.get(call)
        if isinstance(p, ast.withitem):
            return True
        # (b) an enclosing try has the release in a finally/except
        for t in _enclosing(parents, call, ast.Try):
            if t.finalbody and any(_calls_named(s, releases)
                                   for s in t.finalbody):
                return True
            for h in t.handlers:
                if any(_calls_named(s, releases) for s in h.body):
                    return True
        # (c) release appears later in the same function inside ANY
        #     try-finally/except (acquire-then-guarded-release shape)
        for t in (n for n in ast.walk(func) if isinstance(n, ast.Try)):
            if t.finalbody and any(_calls_named(s, releases)
                                   for s in t.finalbody):
                return True
        # (d) class-level pairing: release lives in a teardown method
        if cls is not None:
            for meth in cls.body:
                if isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) and \
                        meth.name.startswith(TEARDOWN_PREFIXES) and \
                        _calls_named(meth, releases):
                    return True
            # ...or in any *_locked helper a teardown delegates to
            for meth in cls.body:
                if isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) and \
                        meth.name.endswith("_locked") and \
                        _calls_named(meth, releases):
                    return True
        return False

    # -- local resource handles -------------------------------------------

    def _check_locals(self, mod: ModuleInfo, parents, func, qual: str,
                      own_nodes: Sequence[ast.AST]) -> List[Finding]:
        findings: List[Finding] = []
        handles: List[Tuple[str, ast.Call, str]] = []
        for node in own_nodes:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    isinstance(node.value, ast.Call):
                ctor = call_name(node.value)
                if ctor in RESOURCE_CTORS:
                    if isinstance(parents.get(node), ast.withitem):
                        continue
                    handles.append((node.targets[0].id, node.value,
                                    RESOURCE_CTORS[ctor]))
        for var, ctor_call, closer in handles:
            if self._handle_ok(parents, func, own_nodes, var, ctor_call,
                               closer):
                continue
            findings.append(Finding(
                checker=self.name, rule="unclosed-local",
                path=mod.rel, line=ctor_call.lineno, severity="error",
                message=(f"local {var!r} ({call_name(ctor_call)}) in "
                         f"{qual}() is neither closed in a finally/except "
                         f"nor escapes the function — wrap in with/"
                         f"try-finally"),
                symbol=f"{qual}.{var}"))
        return findings

    def _handle_ok(self, parents, func, own_nodes, var: str,
                   ctor_call: ast.Call, closer: str) -> bool:
        escaped = False
        closed_guarded = False
        for node in own_nodes:
            if isinstance(node, ast.Return) and node.value is not None and \
                    self._escapes_via(parents, node.value, var):
                escaped = True
            elif isinstance(node, (ast.Yield, ast.YieldFrom)) and \
                    node.value is not None and \
                    self._escapes_via(parents, node.value, var):
                escaped = True
            elif isinstance(node, ast.Call):
                fname = call_name(node)
                if fname == closer and isinstance(node.func, ast.Attribute) \
                        and isinstance(node.func.value, ast.Name) and \
                        node.func.value.id == var:
                    # close() must sit in a finally or except handler
                    for t in _enclosing(parents, node, ast.Try):
                        in_final = t.finalbody and any(
                            node in ast.walk(s) for s in t.finalbody)
                        in_handler = any(node in ast.walk(h)
                                         for h in t.handlers)
                        if in_final or in_handler:
                            closed_guarded = True
                elif node is not ctor_call and any(
                        isinstance(a, ast.Name) and a.id == var
                        for a in list(node.args) +
                        [kw.value for kw in node.keywords]):
                    escaped = True  # handed to another owner
            elif isinstance(node, ast.Assign):
                # stored on self/global/container -> ownership transferred
                if isinstance(node.value, ast.Name) and \
                        node.value.id == var:
                    if not all(isinstance(t, ast.Name)
                               for t in node.targets):
                        escaped = True
        return escaped or closed_guarded

    @staticmethod
    def _escapes_via(parents, tree: ast.AST, var: str) -> bool:
        """The HANDLE leaves the function: ``return fh`` / ``yield fh``
        (possibly inside a container or passed to a call) — but NOT
        ``return fh.read()``, where only a derived value escapes and the
        handle still owes a close."""
        for n in ast.walk(tree):
            if isinstance(n, ast.Name) and n.id == var:
                p = parents.get(n)
                if isinstance(p, ast.Attribute) and p.value is n:
                    continue  # receiver of a method/attr access only
                return True
        return False
