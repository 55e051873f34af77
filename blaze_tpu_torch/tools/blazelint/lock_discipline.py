"""Lock-discipline checker.

Two analyses:

1. **Guarded-attribute inference** — per class, the set of ``self.X``
   attrs ever *written* inside a ``with self._lock:`` (or ``_cv``) block
   is inferred to be lock-guarded; any read or write of a guarded attr
   outside a lock context is flagged (write=error, read=warning). The
   same inference runs at module level for globals written under a
   module-level lock. Conventions honoured:

   * ``__init__`` / ``__del__`` are exempt (no concurrent aliases yet /
     interpreter teardown);
   * methods named ``*_locked`` are exempt (caller-holds-lock
     convention, e.g. ``PrefetchStream._maybe_pump_locked``);
   * ``threading.Condition(self._lock)`` aliases the underlying lock;
   * ``threading.Event`` / ``queue.Queue`` attrs are self-synchronizing
     and never treated as guarded;
   * container mutation (``.append``/``.pop``/…) counts as a write.

2. **Lock-acquisition-order graph** — each function's directly-acquired
   locks are indexed; an edge L→M is added when code holding L either
   acquires M inline or calls a function that acquires M (one level of
   call indirection, resolved conservatively: ``self.f()`` within the
   class, ``mod.f()`` within a scanned module, bare/unique names only
   when unambiguous). Cycles in the graph are reported as potential
   deadlocks (warning — the resolution is approximate by design).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from blaze_tpu_torch.tools.blazelint.core import (PACKAGE, Checker, Finding,
                                                  ModuleInfo, call_name)

LOCK_CTORS = {"Lock", "RLock", "Condition"}
SELF_SYNC_CTORS = {"Event", "Queue", "SimpleQueue", "LifoQueue",
                   "PriorityQueue", "Semaphore", "BoundedSemaphore",
                   "Barrier"}
MUTATORS = {"append", "appendleft", "extend", "insert", "remove", "pop",
            "popleft", "clear", "add", "discard", "update", "setdefault",
            "popitem"}
EXEMPT_METHODS = {"__init__", "__del__", "__post_init__"}


def _ctor_name(value: ast.AST) -> str:
    """'Lock' for threading.Lock() / Lock(); '' otherwise."""
    if isinstance(value, ast.Call):
        return call_name(value)
    return ""


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _Access:
    __slots__ = ("attr", "write", "locked", "func", "line")

    def __init__(self, attr: str, write: bool, locked: bool,
                 func: str, line: int) -> None:
        self.attr, self.write, self.locked = attr, write, locked
        self.func, self.line = func, line


class _ScopeWalker(ast.NodeVisitor):
    """Walk one class body (or module function set), tracking whether the
    current position is inside a ``with <lock>:`` region, and recording
    every access to candidate guarded names."""

    def __init__(self, lock_names: Dict[str, str], is_self: bool,
                 known_names: Set[str]) -> None:
        # lock_names: attr/global -> canonical lock name (Condition alias)
        self.lock_names = lock_names
        self.is_self = is_self          # self.X accesses vs module globals
        self.known_names = known_names  # candidate guarded names
        self.depth = 0                  # >0 == some lock held
        self.func_stack: List[str] = []
        self.accesses: List[_Access] = []
        # lock acquisition structure for the order graph:
        #   direct[func] = [canonical lock, ...]
        #   held_calls[func] = [(held lock, callee simple name, qualifier,
        #                        line), ...]
        self.direct: Dict[str, List[Tuple[str, int]]] = {}
        self.held_calls: List[Tuple[str, str, str, str, int]] = []
        self.held_locks: List[str] = []
        # (outer held lock, inner lock, line) for `with A: ... with B:`
        self.nested_pairs: List[Tuple[str, str, int]] = []

    # -- scope plumbing ----------------------------------------------------

    def _func(self) -> str:
        return self.func_stack[0] if self.func_stack else "<module>"

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.func_stack.append(node.name)
        outer_depth = self.depth
        # a nested function does NOT inherit the lock context of its
        # definition site: it may run later on another thread (pool
        # submit); analyze its body as unlocked unless it takes locks.
        if len(self.func_stack) > 1:
            self.depth = 0
            saved_held = self.held_locks
            self.held_locks = []
            self.generic_visit(node)
            self.held_locks = saved_held
        else:
            self.generic_visit(node)
        self.depth = outer_depth
        self.func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # same deferred-execution argument as nested defs
        saved, self.depth = self.depth, 0
        self.generic_visit(node)
        self.depth = saved

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        return  # nested classes get their own walker

    # -- lock regions ------------------------------------------------------

    def _lock_of_withitem(self, item: ast.withitem) -> Optional[str]:
        expr = item.context_expr
        name = None
        if self.is_self:
            name = _self_attr(expr)
        elif isinstance(expr, ast.Name):
            name = expr.id
        if name is not None and name in self.lock_names:
            return self.lock_names[name]
        return None

    def visit_With(self, node: ast.With) -> None:
        locks = [l for l in
                 (self._lock_of_withitem(i) for i in node.items)
                 if l is not None]
        for item in node.items:
            self.visit(item)
        if locks:
            fn = self._func()
            for lk in locks:
                self.direct.setdefault(fn, []).append((lk, node.lineno))
                for outer in set(self.held_locks):
                    if outer != lk:
                        self.nested_pairs.append((outer, lk, node.lineno))
                self.held_locks.append(lk)
            self.depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if locks:
            self.depth -= 1
            del self.held_locks[-len(locks):]

    # -- accesses ----------------------------------------------------------

    def _record(self, name: str, write: bool, line: int) -> None:
        if name in self.lock_names:
            return
        self.accesses.append(_Access(
            name, write, self.depth > 0, self._func(), line))

    def _target_name(self, node: ast.AST) -> Optional[str]:
        """Name written by an assignment target (self.X / global / X[k])."""
        if self.is_self:
            return _self_attr(node)
        if isinstance(node, ast.Name):
            return node.id if node.id in self.known_names else None
        if isinstance(node, ast.Subscript):
            return self._target_name(node.value)
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            for sub in ast.walk(tgt):
                name = self._target_name(sub) if not isinstance(
                    sub, (ast.Tuple, ast.List)) else None
                if name is not None:
                    self._record(name, True, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        name = self._target_name(node.target)
        if name is not None:
            self._record(name, True, node.lineno)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            name = self._target_name(node.target)
            if name is not None:
                self._record(name, True, node.lineno)
            self.visit(node.value)

    def visit_Call(self, node: ast.Call) -> None:
        # container mutation == write to the container attr
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in MUTATORS:
            name = None
            if self.is_self:
                name = _self_attr(f.value)
            elif isinstance(f.value, ast.Name) and \
                    f.value.id in self.known_names:
                name = f.value.id
            if name is not None:
                self._record(name, True, node.lineno)
                for arg in node.args:
                    self.visit(arg)
                for kw in node.keywords:
                    self.visit(kw.value)
                return
        # call made while holding locks -> candidate order-graph edge
        if self.held_locks:
            qual = ""
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name):
                qual = f.value.id
            nm = call_name(node)
            if nm:
                for lk in set(self.held_locks):
                    self.held_calls.append(
                        (lk, nm, qual, self._func(), node.lineno))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self.is_self and isinstance(node.ctx, ast.Load):
            name = _self_attr(node)
            if name is not None:
                self._record(name, False, node.lineno)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if not self.is_self and isinstance(node.ctx, ast.Load) \
                and node.id in self.known_names:
            self._record(node.id, False, node.lineno)


def _collect_self_attrs(cls: ast.ClassDef) -> Tuple[Dict[str, str], Set[str],
                                                    Set[str]]:
    """(lock attr -> canonical, self-sync attrs, all written attrs)."""
    locks: Dict[str, str] = {}
    self_sync: Set[str] = set()
    written: Set[str] = set()
    assigns: List[Tuple[str, ast.AST]] = []
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                name = _self_attr(tgt)
                if name is not None:
                    written.add(name)
                    assigns.append((name, node.value))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            name = _self_attr(node.target)
            if name is not None:
                written.add(name)
    for name, value in assigns:
        ctor = _ctor_name(value)
        if ctor in LOCK_CTORS:
            locks[name] = name
        elif ctor in SELF_SYNC_CTORS:
            self_sync.add(name)
    # Condition(self._lock) aliases the wrapped lock
    for name, value in assigns:
        if _ctor_name(value) == "Condition" and isinstance(value, ast.Call) \
                and value.args:
            inner = _self_attr(value.args[0])
            if inner in locks:
                locks[name] = locks[inner]
    return locks, self_sync, written


class LockDiscipline(Checker):
    name = "lock-discipline"

    def __init__(self, package: str = PACKAGE) -> None:
        self.package = package
        # lock id -> [(lock id acquired inside, rel, line, context)]
        self._edges: Dict[str, List[Tuple[str, str, int, str]]] = {}
        # function simple name -> [(lock ids directly acquired, owner)]
        self._acquirers: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {}
        self._pending_calls: List[Tuple[str, str, str, str, str, int]] = []

    # -- per module --------------------------------------------------------

    def check_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(mod, node))
        findings.extend(self._check_module_globals(mod))
        return findings

    def _check_class(self, mod: ModuleInfo,
                     cls: ast.ClassDef) -> List[Finding]:
        locks, self_sync, _ = _collect_self_attrs(cls)
        if not locks:
            return []
        walker = _ScopeWalker(locks, is_self=True, known_names=set())
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walker.visit(stmt)
        guarded = {a.attr for a in walker.accesses
                   if a.write and a.locked} - self_sync
        findings = []
        for a in walker.accesses:
            if a.attr not in guarded or a.locked:
                continue
            if a.func in EXEMPT_METHODS or a.func.endswith("_locked"):
                continue
            kind = "write" if a.write else "read"
            findings.append(Finding(
                checker=self.name,
                rule=f"unguarded-{kind}",
                path=mod.rel, line=a.line,
                severity="error" if a.write else "warning",
                message=(f"{cls.name}.{a.attr} is written under "
                         f"{cls.name} lock(s) "
                         f"{sorted(set(locks.values()))} but "
                         f"{kind} without a lock in {a.func}()"),
                symbol=f"{cls.name}.{a.func}.{a.attr}.{kind[0]}"))
        self._index_order_graph(mod, f"{cls.name}.", walker)
        return findings

    def _check_module_globals(self, mod: ModuleInfo) -> List[Finding]:
        locks: Dict[str, str] = {}
        globals_: Set[str] = set()
        for node in mod.tree.body:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        globals_.add(tgt.id)
                        if _ctor_name(node.value) in LOCK_CTORS:
                            locks[tgt.id] = tgt.id
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                globals_.add(node.target.id)
                if node.value is not None and \
                        _ctor_name(node.value) in LOCK_CTORS:
                    locks[node.target.id] = node.target.id
        if not locks:
            return []
        walker = _ScopeWalker(locks, is_self=False,
                              known_names=globals_ - set(locks))
        for stmt in mod.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walker.visit(stmt)
        guarded = {a.attr for a in walker.accesses if a.write and a.locked}
        findings = []
        for a in walker.accesses:
            if a.attr not in guarded or a.locked:
                continue
            if a.func in EXEMPT_METHODS or a.func.endswith("_locked"):
                continue
            kind = "write" if a.write else "read"
            findings.append(Finding(
                checker=self.name,
                rule=f"unguarded-{kind}",
                path=mod.rel, line=a.line,
                severity="error" if a.write else "warning",
                message=(f"module global {a.attr} is written under "
                         f"{sorted(set(locks.values()))} but {kind} "
                         f"without a lock in {a.func}()"),
                symbol=f"<module>.{a.func}.{a.attr}.{kind[0]}"))
        self._index_order_graph(mod, "", walker)
        return findings

    # -- lock-order graph --------------------------------------------------

    def _index_order_graph(self, mod: ModuleInfo, owner_prefix: str,
                           walker: _ScopeWalker) -> None:
        def lock_id(lk: str) -> str:
            return f"{mod.rel}:{owner_prefix}{lk}"

        for fn, locks in walker.direct.items():
            names = tuple(sorted({lock_id(lk) for lk, _ in locks}))
            self._acquirers.setdefault(fn, []).append(
                (f"{mod.rel}:{owner_prefix}{fn}", names))
        for held, callee, qual, fn, line in walker.held_calls:
            self._pending_calls.append(
                (lock_id(held), callee, qual, owner_prefix.rstrip("."),
                 mod.rel, line))
        for outer, inner, line in walker.nested_pairs:
            self._edges.setdefault(lock_id(outer), []).append(
                (lock_id(inner), mod.rel, line, "nested-with"))

    def finalize(self, modules: Sequence[ModuleInfo]) -> Iterable[Finding]:
        # resolve held-lock calls one level deep
        for held, callee, qual, owner_cls, rel, line in self._pending_calls:
            cands = self._acquirers.get(callee, [])
            if not cands:
                continue
            chosen: Optional[Tuple[str, Tuple[str, ...]]] = None
            if qual == "self" and owner_cls:
                same = [c for c in cands
                        if c[0].startswith(f"{rel}:{owner_cls}")]
                chosen = same[0] if len(same) == 1 else None
            if chosen is None and len(cands) == 1:
                chosen = cands[0]
            if chosen is None:
                continue
            for inner in chosen[1]:
                if inner != held:
                    self._edges.setdefault(held, []).append(
                        (inner, rel, line, f"call {callee}()"))
        return self._report_cycles()

    def _report_cycles(self) -> List[Finding]:
        graph = {src: sorted({e[0] for e in edges})
                 for src, edges in self._edges.items()}
        cycles: List[Tuple[str, ...]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()

        def dfs(node: str, path: List[str], on_path: Set[str]) -> None:
            for nxt in graph.get(node, ()):  # noqa: B007
                if nxt in on_path:
                    i = path.index(nxt)
                    cyc = path[i:] + [nxt]
                    key = tuple(sorted(set(cyc)))
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        cycles.append(tuple(cyc))
                    continue
                path.append(nxt)
                on_path.add(nxt)
                dfs(nxt, path, on_path)
                on_path.discard(nxt)
                path.pop()

        for start in sorted(graph):
            dfs(start, [start], {start})
        findings = []
        for cyc in cycles:
            detail = []
            for a, b in zip(cyc, cyc[1:]):
                site = next((e for e in self._edges.get(a, ())
                             if e[0] == b), None)
                if site is not None:
                    detail.append(f"{a} -> {b} at {site[1]}:{site[2]} "
                                  f"({site[3]})")
            first = next((e for e in self._edges.get(cyc[0], ())
                          if e[0] == cyc[1]), None)
            findings.append(Finding(
                checker=self.name, rule="lock-order-cycle",
                path=first[1] if first else self.package,
                line=first[2] if first else 1,
                severity="warning",
                message=("potential deadlock: lock acquisition cycle "
                         + "; ".join(detail)),
                symbol="|".join(sorted(set(cyc)))))
        return findings
