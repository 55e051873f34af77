"""blazelint core: module model, checker plugin API, baseline, report.

The runtime's thread-safety and observability contracts are conventions
(attrs touched only under ``self._lock``, every knob declared in
``config.py``, every fault point in ``faults.KNOWN_POINTS``, hot-path
instrumentation behind one truthiness check). Nothing in CPython enforces
them — the reference engine leans on rustc's Send/Sync checking for this
class of bug; here we build the checker ourselves on stdlib ``ast``.

Design constraints:

  * NO imports of the package under analysis: its ``__init__`` imports
    torch (the JAX package's, jax) and may touch device backends. Modules
    under analysis are *parsed*, never imported; the one exception is
    ``config.py``, which is loaded standalone by file path (it only
    imports dataclasses/os/typing).
  * Findings carry a *stable id* (checker:rule:path:symbol — no line
    numbers) so the committed baseline survives unrelated line drift.
  * Checkers are plugins: subclass :class:`Checker`, yield
    :class:`Finding`s from ``check_module`` (per file) and ``finalize``
    (whole-program, e.g. dead knobs / lock-order cycles).

Inline suppression: a ``# blazelint: ignore[rule]`` comment on the
finding's line (or a bare ``# blazelint: ignore``) suppresses it; the
committed baseline (``baseline.json`` beside this package) suppresses by
stable id with a recorded justification (see README "Static analysis").
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

SEVERITIES = ("error", "warning")

# the package every path the checkers name is relative to (its config,
# registries, doctor, autopilot and hot modules); `--package` changes it
PACKAGE = "blaze_tpu_torch"


def package_rel(package: str, rel: str) -> str:
    """`rel` (a path inside the package) as a repo-relative path."""
    return f"{package}/{rel}"

_PRAGMA_RE = re.compile(r"#\s*blazelint:\s*ignore(?:\[([\w\-, ]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One checker hit. ``symbol`` anchors the stable id — it names the
    offending object (``Class.method.attr``, knob name, fault point…), so
    the id survives line drift while staying unique enough to baseline."""

    checker: str
    rule: str
    path: str          # repo-relative posix path
    line: int
    severity: str      # "error" | "warning"
    message: str
    symbol: str = ""

    @property
    def id(self) -> str:
        return f"{self.checker}:{self.rule}:{self.path}:{self.symbol}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.checker}/{self.rule}] "
                f"{self.severity}: {self.message}")


class ModuleInfo:
    """A parsed source file plus the per-line suppression pragmas."""

    def __init__(self, root: Path, path: Path) -> None:
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.source = path.read_text(encoding="utf-8")
        self.syntax_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(self.source, filename=str(path))
        except SyntaxError as e:
            # keep the module in the run so the pyflakes pass can report
            # it as a finding instead of the whole lint run crashing
            self.syntax_error = e
            self.tree = ast.Module(body=[], type_ignores=[])
        self.lines = self.source.splitlines()
        # lineno -> set of suppressed rules (empty set == suppress all)
        self.pragmas: Dict[int, set] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(text)
            if m:
                rules = m.group(1)
                self.pragmas[i] = (
                    {r.strip() for r in rules.split(",")} if rules else set())
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    def parents(self) -> Dict[ast.AST, ast.AST]:
        """Child -> parent map (lazily built; checkers share it)."""
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def suppressed(self, finding: Finding) -> bool:
        rules = self.pragmas.get(finding.line)
        if rules is None:
            return False
        return not rules or finding.rule in rules


class Checker:
    """Plugin base. ``check_module`` runs once per file; ``finalize``
    runs after every file, for whole-program rules."""

    name = "checker"

    def check_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        return ()

    def finalize(self, modules: Sequence[ModuleInfo]) -> Iterable[Finding]:
        return ()


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def call_name(node: ast.Call) -> str:
    """Simple name of the callee ('' when unnameable)."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def call_qualifier(node: ast.Call) -> str:
    """Name the callee is invoked *on* ('' for bare names / complex)."""
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id
    return ""


def static_string_prefix(node: ast.AST) -> Optional[str]:
    """Statically-known leading string of an expression: a literal, the
    constant head of an f-string, or the left side of ``"lit" + x``.
    None when nothing is known (bare Name / call result)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        if node.values and isinstance(node.values[0], ast.Constant) \
                and isinstance(node.values[0].value, str):
            return node.values[0].value
        return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return static_string_prefix(node.left)
    return None


def literal_strings(node: ast.AST) -> List[str]:
    """String constants inside a literal tuple/list/set/frozenset/dict
    (dict: keys). Used to extract module-level registries without
    importing the module."""
    if isinstance(node, ast.Call) and call_name(node) in (
            "frozenset", "set", "tuple", "list") and node.args:
        return literal_strings(node.args[0])
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return [e.value for e in node.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    if isinstance(node, ast.Dict):
        return [k.value for k in node.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)]
    return []


def module_registry(tree: ast.Module, name: str) -> Optional[List[str]]:
    """Extract module-level ``NAME = (literal strings…)``; None if the
    assignment is missing (distinct from present-but-empty)."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    return literal_strings(node.value)
        if isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name) and node.target.id == name:
                return literal_strings(node.value)
    return None


def load_config_module(config_path: Path):
    """Load <package>/config.py standalone (WITHOUT importing the
    package, whose __init__ pulls in torch or jax). config.py's own
    imports are stdlib-only, so a by-path module load is safe and gives
    the linter the same KNOBS registry the runtime consumes."""
    import importlib.util
    import sys

    name = "_blazelint_config"
    spec = importlib.util.spec_from_file_location(name, config_path)
    module = importlib.util.module_from_spec(spec)
    # dataclass processing resolves annotations via sys.modules[__module__]
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        sys.modules.pop(name, None)
        raise
    return module


# ---------------------------------------------------------------------------
# runner + baseline
# ---------------------------------------------------------------------------


def collect_modules(root: Path, paths: Sequence[str]) -> List[ModuleInfo]:
    files: List[Path] = []
    for p in paths:
        fp = (root / p)
        if fp.is_dir():
            files.extend(sorted(fp.rglob("*.py")))
        elif fp.suffix == ".py":
            files.append(fp)
    mods = []
    for f in files:
        if "__pycache__" in f.parts:
            continue
        mods.append(ModuleInfo(root, f))
    return mods


@dataclasses.dataclass
class RunResult:
    findings: List[Finding]            # new (not baselined, not pragma'd)
    baselined: List[Finding]           # matched a baseline entry
    stale_baseline: List[str]          # baseline ids with no finding
    files_scanned: int
    runtime_s: float
    per_checker: Dict[str, Dict[str, int]]


def run_checkers(root: Path, paths: Sequence[str],
                 checkers: Sequence[Checker],
                 baseline_ids: Optional[Dict[str, str]] = None) -> RunResult:
    t0 = time.monotonic()
    modules = collect_modules(root, paths)
    by_mod = {m.rel: m for m in modules}
    raw: List[Finding] = []
    for chk in checkers:
        for mod in modules:
            raw.extend(chk.check_module(mod))
        raw.extend(chk.finalize(modules))
    raw.sort(key=lambda f: (f.path, f.line, f.checker, f.rule, f.symbol))
    # collapse exact duplicates (two reads of one global on one line)
    deduped: List[Finding] = []
    last_key = None
    for f in raw:
        key = (f.id, f.line)
        if key != last_key:
            deduped.append(f)
        last_key = key
    raw = deduped

    baseline_ids = baseline_ids or {}
    new: List[Finding] = []
    baselined: List[Finding] = []
    seen_ids = set()
    for f in raw:
        seen_ids.add(f.id)
        mod = by_mod.get(f.path)
        if mod is not None and mod.suppressed(f):
            continue
        (baselined if f.id in baseline_ids else new).append(f)
    stale = sorted(set(baseline_ids) - seen_ids)

    per_checker: Dict[str, Dict[str, int]] = {}
    for chk in checkers:
        per_checker[chk.name] = {"new": 0, "baselined": 0}
    for f in new:
        per_checker.setdefault(f.checker, {"new": 0, "baselined": 0})
        per_checker[f.checker]["new"] += 1
    for f in baselined:
        per_checker.setdefault(f.checker, {"new": 0, "baselined": 0})
        per_checker[f.checker]["baselined"] += 1

    return RunResult(findings=new, baselined=baselined,
                     stale_baseline=stale, files_scanned=len(modules),
                     runtime_s=time.monotonic() - t0,
                     per_checker=per_checker)


def load_baseline(path: Path) -> Dict[str, str]:
    """id -> justification (empty dict when the file doesn't exist)."""
    if not path.exists():
        return {}
    data = json.loads(path.read_text(encoding="utf-8"))
    return {e["id"]: e.get("justification", "")
            for e in data.get("entries", [])}


def save_baseline(path: Path, findings: Sequence[Finding],
                  old: Optional[Dict[str, str]] = None) -> None:
    """Write every current finding as a baseline entry, carrying forward
    justifications for ids already present."""
    old = old or {}
    ids: Dict[str, Finding] = {}
    for f in findings:
        ids.setdefault(f.id, f)
    entries = [
        {"id": fid,
         "justification": old.get(fid, "TODO: justify or fix"),
         "note": f"{f.path}:{f.line} {f.message}"}
        for fid, f in sorted(ids.items())
    ]
    path.write_text(json.dumps({"version": 1, "entries": entries},
                               indent=2) + "\n", encoding="utf-8")
