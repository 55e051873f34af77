"""Registry-sync checker.

Free strings that name cross-cutting things must live in module-level
registries so tools can enumerate them (the chaos soak sweeps
``faults.KNOWN_POINTS``; the trace viewer and the Prometheus scrape
contract depend on stable names):

  * fault points passed to ``faults.inject(...)`` must prefix-resolve in
    ``faults.KNOWN_POINTS`` (hierarchical, ``"op"`` covers
    ``"op.<Kind>"`` — same longest-prefix rule as ``faults._rule_for``);
  * trace event kinds in ``trace.event(...)`` must be in
    ``trace.EVENT_KINDS``; span kinds in ``trace.span(...)`` in
    ``trace.SPAN_KINDS``. f-strings/concats check their static prefix
    (``f"compile_{event}"`` matches the registered ``compile_*`` kinds);
  * Prometheus sample names emitted by ``runtime/monitor.py`` must be in
    ``monitor.GAUGE_NAMES`` (dynamic families by ``GAUGE_PREFIXES``),
    and every registered gauge must actually be emitted (stale-registry).

Registries are extracted from the module ASTs — never imported (the
modules pull in the config singleton and, transitively, torch or jax).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from blaze_tpu_torch.tools.blazelint.core import (PACKAGE, Checker, Finding,
                                                  ModuleInfo, call_name,
                                                  call_qualifier,
                                                  module_registry,
                                                  package_rel,
                                                  static_string_prefix)

# the registries' modules, inside the package
FAULTS_REL = "runtime/faults.py"
TRACE_REL = "runtime/trace.py"
MONITOR_REL = "runtime/monitor.py"


def _prefix_match(registry: Sequence[str], name: str) -> bool:
    """faults._rule_for's hierarchy: a registered prefix covers every
    dotted point beneath it."""
    p = name
    while True:
        if p in registry:
            return True
        i = p.rfind(".")
        if i < 0:
            return False
        p = p[:i]


def _static_prefix_match(registry: Sequence[str], prefix: str) -> bool:
    """A partially-known name (f-string/concat): accept when its static
    prefix could still land on a registered entry."""
    return any(r.startswith(prefix) or prefix.startswith(r + ".")
               or prefix.rstrip(".") == r
               for r in registry)


class RegistrySync(Checker):
    name = "registry-sync"

    def __init__(self,
                 known_points: Optional[Sequence[str]] = None,
                 event_kinds: Optional[Sequence[str]] = None,
                 span_kinds: Optional[Sequence[str]] = None,
                 gauge_names: Optional[Sequence[str]] = None,
                 gauge_prefixes: Optional[Sequence[str]] = None,
                 package: str = PACKAGE) -> None:
        self.faults_rel = package_rel(package, FAULTS_REL)
        self.trace_rel = package_rel(package, TRACE_REL)
        self.monitor_rel = package_rel(package, MONITOR_REL)
        # None => extract from the scanned tree in check_module; tests
        # inject synthetic registries instead.
        self._injected = known_points is not None
        self.known_points = list(known_points or [])
        self.event_kinds = list(event_kinds or [])
        self.span_kinds = list(span_kinds or [])
        self.gauge_names = list(gauge_names or [])
        self.gauge_prefixes = list(gauge_prefixes or [])
        self._missing_registries: List[Tuple[str, str]] = []
        self._deferred: List[Tuple[str, ModuleInfo, ast.Call]] = []
        self._used_events: Set[str] = set()
        self._used_points: Set[str] = set()
        self._emitted_gauges: Set[str] = set()
        self._gauge_sites: List[Tuple[ModuleInfo, ast.Call]] = []

    # -- registry extraction ----------------------------------------------

    def _extract(self, mod: ModuleInfo) -> None:
        def take(attr: str, reg_name: str, target: List[str]) -> None:
            vals = module_registry(mod.tree, reg_name)
            if vals is None:
                self._missing_registries.append((mod.rel, reg_name))
            else:
                target.extend(vals)

        if mod.rel == self.faults_rel:
            take(mod.rel, "KNOWN_POINTS", self.known_points)
        elif mod.rel == self.trace_rel:
            take(mod.rel, "EVENT_KINDS", self.event_kinds)
            take(mod.rel, "SPAN_KINDS", self.span_kinds)
        elif mod.rel == self.monitor_rel:
            take(mod.rel, "GAUGE_NAMES", self.gauge_names)
            take(mod.rel, "GAUGE_PREFIXES", self.gauge_prefixes)

    # -- per module --------------------------------------------------------

    def check_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        if not self._injected:
            self._extract(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            qual, fname = call_qualifier(node), call_name(node)
            if fname == "inject" and (qual == "faults" or
                                      mod.rel == self.faults_rel):
                self._deferred.append(("point", mod, node))
            elif fname == "net_rule":
                # wire-fault lookups (faults.net_rule / the re-exported
                # shuffle_server.net_rule passthrough) use points too
                self._deferred.append(("point", mod, node))
            elif qual == "trace" and fname == "event":
                self._deferred.append(("event", mod, node))
            elif qual == "trace" and fname == "span":
                self._deferred.append(("span", mod, node))
            elif mod.rel == self.monitor_rel and fname == "emit":
                self._gauge_sites.append((mod, node))
        # trace.py's own event()/span() bodies also record kinds via
        # self-calls; internal `event(...)` bare calls inside trace.py:
        if mod.rel == self.trace_rel:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call) and node.args and \
                        isinstance(node.func, ast.Name) and \
                        node.func.id == "event":
                    self._deferred.append(("event", mod, node))
        return ()

    # -- finalize: all registries known ------------------------------------

    def finalize(self, modules: Sequence[ModuleInfo]) -> Iterable[Finding]:
        findings: List[Finding] = []
        for rel, reg in self._missing_registries:
            findings.append(Finding(
                checker=self.name, rule="missing-registry",
                path=rel, line=1, severity="error",
                message=f"module-level registry {reg} not found in {rel}",
                symbol=reg))
        for kind, mod, node in self._deferred:
            findings.extend(self._check_deferred(kind, mod, node))
        findings.extend(self._check_gauges())
        # stale-registry: registered but never used anywhere scanned
        if self._deferred:
            for ev in sorted(set(self.event_kinds) - self._used_events):
                findings.append(Finding(
                    checker=self.name, rule="stale-registry",
                    path=self.trace_rel, line=1, severity="warning",
                    message=(f"trace event kind {ev!r} is registered in "
                             f"EVENT_KINDS but never emitted"),
                    symbol=f"event.{ev}"))
            for pt in sorted(set(self.known_points) - self._used_points):
                findings.append(Finding(
                    checker=self.name, rule="stale-registry",
                    path=self.faults_rel, line=1, severity="warning",
                    message=(f"fault point {pt!r} is registered in "
                             f"KNOWN_POINTS but never injected"),
                    symbol=f"point.{pt}"))
        return findings

    def _check_deferred(self, kind: str, mod: ModuleInfo,
                        node: ast.Call) -> List[Finding]:
        arg = node.args[0]
        registry, label, rule = {
            "point": (self.known_points, "faults.KNOWN_POINTS",
                      "unregistered-fault-point"),
            "event": (self.event_kinds, "trace.EVENT_KINDS",
                      "unregistered-event"),
            "span": (self.span_kinds, "trace.SPAN_KINDS",
                     "unregistered-span"),
        }[kind]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            name = arg.value
            ok = _prefix_match(registry, name) if kind == "point" \
                else name in registry
            if ok:
                (self._used_points if kind == "point"
                 else self._used_events).add(
                    self._resolve_used(kind, registry, name))
                return []
            return [Finding(
                checker=self.name, rule=rule,
                path=mod.rel, line=node.lineno, severity="error",
                message=f"{kind} name {name!r} is not declared in {label}",
                symbol=name)]
        prefix = static_string_prefix(arg)
        if prefix is None:
            return []  # fully dynamic: nothing checkable statically
        if _static_prefix_match(registry, prefix):
            for r in registry:
                if r.startswith(prefix) or prefix.startswith(r + ".") or \
                        prefix.rstrip(".") == r:
                    (self._used_points if kind == "point"
                     else self._used_events).add(r)
            return []
        return [Finding(
            checker=self.name, rule=rule,
            path=mod.rel, line=node.lineno, severity="error",
            message=(f"dynamic {kind} name with static prefix {prefix!r} "
                     f"matches nothing in {label}"),
            symbol=f"{prefix}*")]

    @staticmethod
    def _resolve_used(kind: str, registry: Sequence[str],
                      name: str) -> str:
        if kind != "point":
            return name
        p = name
        while p not in registry and "." in p:
            p = p[:p.rfind(".")]
        return p

    def _check_gauges(self) -> List[Finding]:
        findings: List[Finding] = []
        for mod, node in self._gauge_sites:
            arg = node.args[0]
            # unwrap sanitizer wrappers: emit(_prom_name(f"{p}_{k}"), ...)
            if isinstance(arg, ast.Call) and arg.args:
                arg = arg.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                name = arg.value
                self._emitted_gauges.add(name)
                if name not in self.gauge_names:
                    findings.append(Finding(
                        checker=self.name, rule="unregistered-gauge",
                        path=mod.rel, line=node.lineno, severity="error",
                        message=(f"Prometheus sample {name!r} is not "
                                 f"declared in monitor.GAUGE_NAMES"),
                        symbol=name))
            else:
                prefix = static_string_prefix(arg)
                if prefix is not None and self.gauge_prefixes and \
                        not any(prefix.startswith(p) or p.startswith(prefix)
                                for p in self.gauge_prefixes):
                    findings.append(Finding(
                        checker=self.name, rule="unregistered-gauge",
                        path=mod.rel, line=node.lineno, severity="error",
                        message=(f"dynamic Prometheus sample with prefix "
                                 f"{prefix!r} matches no entry in "
                                 f"monitor.GAUGE_PREFIXES"),
                        symbol=f"{prefix}*"))
        if self._gauge_sites:
            for g in sorted(set(self.gauge_names) - self._emitted_gauges):
                findings.append(Finding(
                    checker=self.name, rule="stale-registry",
                    path=self.monitor_rel, line=1, severity="warning",
                    message=(f"gauge {g!r} is registered in GAUGE_NAMES "
                             f"but never emitted"),
                    symbol=f"gauge.{g}"))
        return findings
