"""Lock-discipline analyzer: guarded fields and the lock-order graph.

The runtime's concurrency contract is conventions: every shared
structure is mutated under its owner's lock, and locks nest in one
global order (`hot_swap` drains in-flight work under the pool lock
while touching the shared kernel cache — a second path acquiring those
two locks in the other order would deadlock).  This pass makes the
conventions machine-checked, driven by two comment registries in the
code itself:

  ``self._store = {}  # guarded-by: _lock``
      registers `_store` as guarded by `self._lock`; any mutation of a
      guarded field (assignment, augmented assignment, subscript/attr
      store, or a mutating method call like `.append`/`.pop`) outside a
      ``with self._lock:`` block is CVK201.

  ``# holds-lock: _lock``
      on a method's ``def`` line (or first body line) declares a
      caller-holds-lock helper — the analyzer treats the lock as held
      for the whole body.  Methods named ``*_locked`` and ``__init__``
      (construction precedes sharing) get the same waiver implicitly.

``threading.Condition(self._lock)`` aliases are resolved: holding the
condition IS holding the lock.  A class that owns a lock but annotates
no fields at all gets CVK203 (warning) — the registry must be complete
for CVK201 to mean anything.

The lock graph takes an edge held->acquired for every syntactic nesting
(``with self.a:`` inside ``with self.b:``) and, across objects, for
every call made under a lock to a method of a known lock-owning class
that itself acquires its lock (receivers resolved by attribute name
through ``self.x = OwnerClass(...)`` assignments).  Any cycle is CVK202.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.convserve.check.diagnostics import (
    WARNING,
    CheckReport,
    Diagnostic,
)

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
_HOLDS_RE = re.compile(r"#\s*holds-lock:\s*([A-Za-z_]\w*)")
_LOCK_CTORS = {"Lock", "RLock"}

# method calls that mutate their receiver in place
_MUTATORS = {
    "append", "appendleft", "add", "update", "pop", "popleft", "popitem",
    "clear", "extend", "extendleft", "remove", "discard", "insert",
    "setdefault", "move_to_end", "sort", "reverse",
}


@dataclasses.dataclass
class ClassInfo:
    """Everything the analyzer knows about one class."""

    name: str
    path: str
    node: ast.ClassDef
    locks: Set[str] = dataclasses.field(default_factory=set)
    guarded: Dict[str, str] = dataclasses.field(default_factory=dict)
    cond_alias: Dict[str, str] = dataclasses.field(default_factory=dict)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    # methods that (syntactically) acquire one of the class's own locks
    acquires: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)

    @property
    def owns_locks(self) -> bool:
        return bool(self.locks)

    def lock_of(self, attr: str) -> Optional[str]:
        """Resolve an attribute used in ``with self.<attr>:`` to the lock
        it holds (identity, or through a Condition alias)."""
        if attr in self.locks:
            return attr
        return self.cond_alias.get(attr)


def _call_name(node: ast.AST) -> str:
    """Dotted tail of a call target: `threading.RLock` -> 'RLock'."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _self_attr(node: ast.AST) -> Optional[str]:
    """`self.X` -> 'X' (else None)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _mutated_self_attr(target: ast.AST) -> Optional[str]:
    """The self-attribute a store-target mutates.

    `self.X = ..` and `self.X[k] = ..` and `self.X.attr = ..` all mutate
    (the object bound to) `self.X`; deeper chains resolve to the first
    self-attribute on the chain.
    """
    node = target
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        attr = _self_attr(node)
        if attr is not None:
            return attr
        node = node.value
    return None


def _scan_class(path: str, lines: List[str], node: ast.ClassDef) -> ClassInfo:
    info = ClassInfo(name=node.name, path=path, node=node)
    for stmt in ast.walk(node):
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            continue
        targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        value = stmt.value
        for tgt in targets:
            attr = _self_attr(tgt)
            if attr is None:
                continue
            if isinstance(value, ast.Call):
                ctor = _call_name(value.func)
                if ctor in _LOCK_CTORS:
                    info.locks.add(attr)
                elif ctor == "Condition":
                    # threading.Condition(self._lock): holding the
                    # condition is holding the lock
                    if value.args:
                        base = _self_attr(value.args[0])
                        if base is not None:
                            info.cond_alias[attr] = base
                    else:
                        info.locks.add(attr)  # owns its own lock
                elif ctor and ctor[0].isupper():
                    info.attr_types[attr] = ctor
            m = _GUARDED_RE.search(lines[stmt.lineno - 1])
            if m:
                info.guarded[attr] = m.group(1)
    # which methods acquire which of the class's own locks (any depth)
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            held: Set[str] = set()
            for sub in ast.walk(item):
                if isinstance(sub, ast.With):
                    for w in sub.items:
                        attr = _self_attr(w.context_expr)
                        lock = info.lock_of(attr) if attr else None
                        if lock:
                            held.add(lock)
            if held:
                info.acquires[item.name] = held
    return info


def _holds_waiver(lines: List[str], fn: ast.FunctionDef) -> Optional[str]:
    """`# holds-lock: X` anywhere between the ``def`` line and the first
    body statement (so it can sit above or below a docstring header)."""
    last = fn.body[0].lineno if fn.body else fn.lineno
    for ln in range(fn.lineno - 1, min(last, len(lines))):
        m = _HOLDS_RE.search(lines[ln])
        if m:
            return m.group(1)
    return None


class _MethodChecker(ast.NodeVisitor):
    """Walks one method body tracking the set of held locks."""

    def __init__(
        self,
        report: CheckReport,
        info: ClassInfo,
        path: str,
        fn: ast.FunctionDef,
        classes: Dict[str, "ClassInfo"],
        attr_types: Dict[str, str],
        edges: Set[Tuple[str, str]],
        initial: Set[str],
    ):
        self.report = report
        self.info = info
        self.path = path
        self.fn = fn
        self.classes = classes
        self.attr_types = attr_types
        self.edges = edges
        self.held: Set[str] = set(initial)

    def _diag(self, code: str, msg: str, line: int, severity: str = "error"):
        self.report.add(
            Diagnostic(
                code=code, message=msg, severity=severity,
                loc=f"{self.path}:{line}",
            )
        )

    # -- lock acquisition -------------------------------------------------

    def visit_With(self, node: ast.With):
        acquired: List[str] = []
        for w in node.items:
            attr = _self_attr(w.context_expr)
            lock = self.info.lock_of(attr) if attr else None
            if lock:
                for h in self.held:
                    if h != lock:
                        self.edges.add(
                            (f"{self.info.name}.{h}",
                             f"{self.info.name}.{lock}")
                        )
                acquired.append(lock)
        self.held.update(acquired)
        for stmt in node.body:
            self.visit(stmt)
        self.held.difference_update(acquired)

    # -- mutations --------------------------------------------------------

    def _check_mutation(self, attr: str, line: int, what: str):
        lock = self.info.guarded.get(attr)
        if lock is None:
            return
        if lock not in self.held:
            self._diag(
                "CVK201",
                f"{self.info.name}.{attr} ({what}) is guarded by "
                f"{lock!r} but mutated outside `with self.{lock}:` "
                f"in {self.fn.name}()",
                line,
            )

    def visit_Assign(self, node: ast.Assign):
        for tgt in node.targets:
            attr = _mutated_self_attr(tgt)
            if attr is not None:
                self._check_mutation(attr, node.lineno, "assignment")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        attr = _mutated_self_attr(node.target)
        if attr is not None:
            self._check_mutation(attr, node.lineno, "augmented assignment")
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            attr = _mutated_self_attr(node.target)
            if attr is not None:
                self._check_mutation(attr, node.lineno, "assignment")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete):
        for tgt in node.targets:
            attr = _mutated_self_attr(tgt)
            if attr is not None:
                self._check_mutation(attr, node.lineno, "del")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute):
            # self.X.append(...) and self.X[k].append(...) mutate self.X
            if func.attr in _MUTATORS:
                attr = _mutated_self_attr(func.value)
                if attr is not None:
                    self._check_mutation(
                        attr, node.lineno, f".{func.attr}()"
                    )
            # cross-object acquisition: calling, under a held lock, a
            # method of a known lock-owning class that takes its lock
            if self.held:
                self._cross_edge(func)
        self.generic_visit(node)

    def _cross_edge(self, func: ast.Attribute):
        recv = func.value
        recv_attr = None
        if isinstance(recv, ast.Attribute):
            recv_attr = recv.attr
        elif isinstance(recv, ast.Name) and recv.id != "self":
            recv_attr = recv.id
        if recv_attr is None:
            return
        target_cls = self.attr_types.get(recv_attr)
        if target_cls is None:
            return
        target = self.classes.get(target_cls)
        if target is None or not target.owns_locks:
            return
        for lock in target.acquires.get(func.attr, ()):
            for h in self.held:
                self.edges.add(
                    (f"{self.info.name}.{h}", f"{target.name}.{lock}")
                )


def _find_cycles(edges: Set[Tuple[str, str]]) -> List[List[str]]:
    graph: Dict[str, List[str]] = {}
    for a, b in sorted(edges):
        graph.setdefault(a, []).append(b)
    cycles: List[List[str]] = []
    seen_cycles: Set[Tuple[str, ...]] = set()

    def dfs(node: str, stack: List[str], on_stack: Set[str]):
        for nxt in graph.get(node, ()):
            if nxt in on_stack:
                cyc = stack[stack.index(nxt):] + [nxt]
                key = tuple(sorted(set(cyc)))
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cycles.append(cyc)
            elif nxt not in visited:
                visited.add(nxt)
                stack.append(nxt)
                on_stack.add(nxt)
                dfs(nxt, stack, on_stack)
                on_stack.discard(nxt)
                stack.pop()

    visited: Set[str] = set()
    for start in sorted(graph):
        if start not in visited:
            visited.add(start)
            dfs(start, [start], {start})
    return cycles


def analyze_locks(paths) -> CheckReport:
    """Run the lock-discipline pass over every ``.py`` file under the
    given files/directories and return one merged report."""
    report = CheckReport(analyzer="locks")
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    classes: Dict[str, ClassInfo] = {}
    attr_types: Dict[str, str] = {}
    parsed: List[Tuple[str, List[str], ast.Module]] = []
    for f in files:
        try:
            src = f.read_text()
            tree = ast.parse(src, filename=str(f))
        except (OSError, SyntaxError) as e:
            report.add(
                Diagnostic(
                    code="CVK203", message=f"unparseable: {e}",
                    severity=WARNING, loc=str(f),
                )
            )
            continue
        lines = src.splitlines()
        parsed.append((str(f), lines, tree))
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                info = _scan_class(str(f), lines, node)
                classes[info.name] = info
                attr_types.update(info.attr_types)
    edges: Set[Tuple[str, str]] = set()
    for path, lines, _tree in parsed:
        for info in classes.values():
            if info.path != path:
                continue
            if info.owns_locks and not info.guarded:
                report.add(
                    Diagnostic(
                        code="CVK203",
                        message=f"class {info.name} owns lock(s) "
                        f"{sorted(info.locks)} but annotates no fields "
                        "with `# guarded-by:`",
                        severity=WARNING,
                        loc=f"{path}:{info.node.lineno}",
                    )
                )
            for item in info.node.body:
                if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if item.name == "__init__" or item.name.endswith("_locked"):
                    continue
                initial: Set[str] = set()
                waiver = _holds_waiver(lines, item)
                if waiver:
                    initial.add(info.lock_of(waiver) or waiver)
                checker = _MethodChecker(
                    report, info, path, item, classes, attr_types,
                    edges, initial,
                )
                for stmt in item.body:
                    checker.visit(stmt)
    for cyc in _find_cycles(edges):
        report.add(
            Diagnostic(
                code="CVK202",
                message="lock-order cycle: " + " -> ".join(cyc),
                loc=cyc[0],
            )
        )
    return report
