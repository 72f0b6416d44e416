"""Clock/convention linter: pluggable AST rules over the source tree.

Rules are small objects with a stable code, run by `analyze_rules` over
every ``.py`` file under the given roots.  Adding a rule is: subclass
`Rule`, implement `check`, append an instance to `DEFAULT_RULES` (the
README documents this as the extension point).

The built-in rules encode two conventions the runtime depends on:

  *clock discipline* — the whole serving stack is testable because
  every time read routes through the injectable `Clock`
  (runtime/clock.py).  One stray ``time.perf_counter()`` makes a
  SimClock run nondeterministic (and its latency pairs incomparable
  with clocked ones), so direct reads are banned outside the allowlist:
  `runtime/clock.py` (the clock IS the time source) and `core/tune.py`
  (offline autotuning measures real kernels by design; its wisdom
  timestamps are wall-time on purpose).  `time.time()` is CVK301 —
  non-monotonic, wrong for durations everywhere; `time.perf_counter()`
  is CVK302; inside `convserve/` even `time.monotonic()`/`time.sleep()`
  are CVK303 (must go through a Clock so simulation reaches them).

  *kernel discipline* — a kernel is launched through its wrapper under
  ``repro_torch/kernels/``, which checks devices, dtypes and shapes,
  counts the launch (``LAUNCHES``, under ``_build.COUNT_LOCK``) and
  raises on a refused launch.  A call into a built CUDA library (a
  ``CudaLibrary`` handle's ``launch``/``fn``, through the ctypes
  library `kernels/_build.py` loads) or a ``@triton.jit`` launch
  anywhere else bypasses all three: a launch no counter sees and no
  check guards (CVK320).

  *registry discipline* — an `Algorithm` subclass must declare its
  `supports` predicate before (lexically above) its `execute` body
  (CVK310: the capability contract is read top-down, and a class that
  executes without any reachable `supports` in its base chain silently
  accepts every spec), and call sites must not pass ``wt=`` to an
  algorithm that does not consume pre-transformed weights (CVK311: the
  argument would be silently meaningless — the registry raises at
  runtime, the rule catches it statically when ``algo=`` is a literal).

  *telemetry discipline* — counters, gauges and spans mutate only
  through the `Telemetry`/`Tracer` API (CVK330).  A direct dict poke at
  the stores outside `runtime/telemetry.py` and `obs/` skips the lock
  AND the freshness stamp that the autoscaler's and adapt controller's
  stale-snapshot guards depend on.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.convserve.check.diagnostics import CheckReport, Diagnostic

# files where direct time reads are the point, not a leak
CLOCK_ALLOWLIST = ("runtime/clock.py", "core/tune.py")

_BANNED_EVERYWHERE = {"time": "CVK301", "perf_counter": "CVK302"}
_BANNED_CONVSERVE = {"monotonic": "CVK303", "sleep": "CVK303"}


def _is_allowlisted(path: str) -> bool:
    posix = Path(path).as_posix()
    return any(posix.endswith(suffix) for suffix in CLOCK_ALLOWLIST)


@dataclasses.dataclass
class FileContext:
    """One parsed file plus the cross-file class table (for rules that
    need whole-program knowledge, like supports/execute resolution)."""

    path: str
    lines: List[str]
    tree: ast.Module
    classes: Dict[str, "ClassDecl"]  # global, keyed by class name


@dataclasses.dataclass
class ClassDecl:
    name: str
    path: str
    bases: Tuple[str, ...]
    methods: Dict[str, int]  # name -> lineno


class Rule:
    """One convention: a stable code and a per-file check."""

    code = "CVK000"
    name = "rule"

    def check(self, ctx: FileContext, report: CheckReport) -> None:
        raise NotImplementedError


# ------------------------------------------------------------- clock rules


class DirectTimeRule(Rule):
    """CVK301/302/303: direct `time.*` reads outside the allowlist."""

    code = "CVK301"
    name = "direct-time"

    def check(self, ctx: FileContext, report: CheckReport) -> None:
        if _is_allowlisted(ctx.path):
            return
        in_convserve = "/convserve/" in Path(ctx.path).as_posix()
        # names imported straight off the time module:
        #   from time import perf_counter [as pc]
        direct: Dict[str, str] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    direct[alias.asname or alias.name] = alias.name
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            member = None
            if (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "time"
            ):
                member = func.attr
            elif isinstance(func, ast.Name) and func.id in direct:
                member = direct[func.id]
            if member is None:
                continue
            code = _BANNED_EVERYWHERE.get(member)
            if code is None and in_convserve:
                code = _BANNED_CONVSERVE.get(member)
            if code is None:
                continue
            report.add(
                Diagnostic(
                    code=code,
                    message=f"direct time.{member}() call: route through "
                    "the injected Clock"
                    + (" (non-monotonic, wrong for durations)"
                       if member == "time" else ""),
                    loc=f"{ctx.path}:{node.lineno}",
                )
            )


# ---------------------------------------------------------- registry rules

_ROOT_ALGO_CLASSES = {"Algorithm", "TransformedAlgorithm"}


class KernelLaunchOutsideKernelsRule(Rule):
    """CVK320: a launch into a built kernel outside ``kernels/``.

    Two launch forms are recognised.  A CUDA library handle
    (`kernels._build.CudaLibrary`, loaded with ctypes) launches through
    its ``launch`` or ``fn`` methods; a handle is a name bound to a
    ``CudaLibrary(...)`` call in the file, a name imported as ``LIB``
    (the wrappers' handle), or any ``<module>.LIB`` attribute.  A Triton
    kernel launches as ``kernel[grid](...)`` where ``kernel`` is a
    function of the file decorated with ``triton.jit`` (or a ``jit``
    imported from triton).  Either belongs to the kernel's wrapper under
    ``kernels/``, which checks its operands and counts its launches."""

    code = "CVK320"
    name = "kernel-launch-outside-kernels"

    HANDLE_METHODS = ("launch", "fn")

    def _handles(self, tree: ast.Module) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                ctor = node.value.func
                ctor_name = (
                    ctor.attr if isinstance(ctor, ast.Attribute)
                    else ctor.id if isinstance(ctor, ast.Name) else ""
                )
                if ctor_name == "CudaLibrary":
                    names.update(
                        t.id for t in node.targets if isinstance(t, ast.Name)
                    )
            elif isinstance(node, ast.ImportFrom):
                names.update(
                    alias.asname or alias.name
                    for alias in node.names if alias.name == "LIB"
                )
        return names

    def _triton_kernels(self, tree: ast.Module) -> Set[str]:
        jit_names = {"jit"} if any(
            isinstance(node, ast.ImportFrom)
            and (node.module or "").split(".")[0] == "triton"
            and any(a.name == "jit" for a in node.names)
            for node in ast.walk(tree)
        ) else set()
        kernels: Set[str] = set()
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if (
                    isinstance(target, ast.Attribute) and target.attr == "jit"
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "triton"
                ) or (isinstance(target, ast.Name) and target.id in jit_names):
                    kernels.add(node.name)
        return kernels

    def _is_handle(self, node: ast.AST, handles: Set[str]) -> bool:
        if isinstance(node, ast.Name):
            return node.id in handles
        return isinstance(node, ast.Attribute) and node.attr == "LIB"

    def check(self, ctx: FileContext, report: CheckReport) -> None:
        posix = Path(ctx.path).as_posix()
        if "/kernels/" in posix:
            return
        handles = self._handles(ctx.tree)
        triton_kernels = self._triton_kernels(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            what = None
            if (
                isinstance(func, ast.Attribute)
                and func.attr in self.HANDLE_METHODS
                and self._is_handle(func.value, handles)
            ):
                what = f"CUDA library call .{func.attr}()"
            elif (
                isinstance(func, ast.Subscript)
                and isinstance(func.value, ast.Name)
                and func.value.id in triton_kernels
            ):
                what = f"Triton launch {func.value.id}[grid]()"
            if what:
                report.add(
                    Diagnostic(
                        code=self.code,
                        message=f"{what} outside kernels/: launch through "
                        "the kernel's wrapper (repro_torch.kernels.*), "
                        "which checks operands and counts launches",
                        loc=f"{ctx.path}:{node.lineno}",
                    )
                )


class SupportsBeforeExecuteRule(Rule):
    """CVK310: an Algorithm subclass declares `supports` before
    `execute` — lexically within one body, and reachably across the
    base chain (a class that executes with no `supports` anywhere up to
    the root accepts every spec)."""

    code = "CVK310"
    name = "supports-before-execute"

    def _is_algorithm(self, decl: ClassDecl, classes: Dict[str, ClassDecl],
                      seen: Set[str]) -> bool:
        for b in decl.bases:
            if b in _ROOT_ALGO_CLASSES:
                return True
            if b in classes and b not in seen:
                seen.add(b)
                if self._is_algorithm(classes[b], classes, seen):
                    return True
        return False

    def _chain_declares_supports(
        self, decl: ClassDecl, classes: Dict[str, ClassDecl], seen: Set[str]
    ) -> bool:
        if "supports" in decl.methods:
            return True
        for b in decl.bases:
            if b in _ROOT_ALGO_CLASSES:
                # the registry root's default predicate counts only if
                # it is the REAL root (scanned); an unscanned base named
                # Algorithm is given the benefit of the doubt too --
                # fixture trees can define their own bare root
                root = classes.get(b)
                if root is None or "supports" in root.methods:
                    return True
                if self._chain_declares_supports(root, classes, seen):
                    return True
                continue
            if b in classes and b not in seen:
                seen.add(b)
                if self._chain_declares_supports(classes[b], classes, seen):
                    return True
        return False

    def check(self, ctx: FileContext, report: CheckReport) -> None:
        for decl in ctx.classes.values():
            if decl.path != ctx.path:
                continue
            if decl.name in _ROOT_ALGO_CLASSES:
                continue
            if not self._is_algorithm(decl, ctx.classes, set()):
                continue
            exec_line = decl.methods.get("execute")
            if exec_line is None:
                continue
            sup_line = decl.methods.get("supports")
            if sup_line is not None:
                if sup_line > exec_line:
                    report.add(
                        Diagnostic(
                            code=self.code,
                            message=f"{decl.name}.supports (line "
                            f"{sup_line}) is declared after execute "
                            f"(line {exec_line})",
                            loc=f"{ctx.path}:{sup_line}",
                        )
                    )
            elif not self._chain_declares_supports(
                decl, ctx.classes, {decl.name}
            ):
                report.add(
                    Diagnostic(
                        code=self.code,
                        message=f"{decl.name} defines execute but no "
                        "supports is reachable in its base chain: it "
                        "would accept every ConvSpec",
                        loc=f"{ctx.path}:{exec_line}",
                    )
                )


class WtToNonConsumerRule(Rule):
    """CVK311: `wt=` handed to an algorithm that does not consume
    pre-transformed weights (checked statically where `algo=` is a
    string literal; the registry raises the same complaint at call
    time)."""

    code = "CVK311"
    name = "wt-non-consumer"

    def _consumes(self, algo: str) -> Optional[bool]:
        try:  # live registry: single source of truth for capabilities
            from repro_torch.core import registry

            return registry.get(algo).consumes_wt
        except Exception:
            return None  # unknown algo: not this rule's complaint

    def check(self, ctx: FileContext, report: CheckReport) -> None:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else node.func.id if isinstance(node.func, ast.Name)
                else ""
            )
            if fname != "conv2d":
                continue
            kw = {k.arg: k.value for k in node.keywords if k.arg}
            wt = kw.get("wt")
            algo = kw.get("algo")
            if wt is None or isinstance(wt, ast.Constant) and wt.value is None:
                continue
            if not (isinstance(algo, ast.Constant)
                    and isinstance(algo.value, str)):
                continue
            if algo.value == "auto":
                continue
            if self._consumes(algo.value) is False:
                report.add(
                    Diagnostic(
                        code=self.code,
                        message=f"wt= passed to algo={algo.value!r}, "
                        "which does not consume pre-transformed weights",
                        loc=f"{ctx.path}:{node.lineno}",
                    )
                )


class TelemetryDisciplineRule(Rule):
    """CVK330: counters, gauges and spans mutate only through the
    `Telemetry`/`Tracer` API.  An ad-hoc poke at the metric stores
    (``telemetry._counters[...] = ...``, ``tracer._events.append(...)``,
    a ``telemetry.counters`` dict write) outside ``runtime/telemetry.py``
    and ``obs/`` bypasses both the lock and the freshness stamp -- the
    mutation is invisible to the stale-snapshot guards downstream, so
    the autoscaler/adapt controller would act on data that looks stale
    (or, worse, looks fresh) for the wrong reason."""

    code = "CVK330"
    name = "telemetry-discipline"

    # attrs that ARE the stores (Telemetry internals)
    STORES = ("_counters", "_gauges", "_hists")
    # attrs that are only suspicious when the owner expression names the
    # registry ("telemetry"/"tracer"): `pool._events` is a legit event
    # heap, `tracer._events` is the span ring buffer
    LOOSE = ("counters", "gauges", "_events")
    MUTATORS = ("setdefault", "update", "pop", "popitem", "clear",
                "append", "appendleft", "extend")

    # files that own the stores: mutation is the point there
    ALLOW_SUFFIXES = ("runtime/telemetry.py",)
    ALLOW_PARTS = ("/obs/",)

    def _allowlisted(self, path: str) -> bool:
        posix = Path(path).as_posix()
        return (
            any(posix.endswith(s) for s in self.ALLOW_SUFFIXES)
            or any(p in posix for p in self.ALLOW_PARTS)
        )

    def _store_attr(self, node) -> Optional[str]:
        """The store name if `node` is an Attribute reading one."""
        if not isinstance(node, ast.Attribute):
            return None
        if node.attr in self.STORES:
            return node.attr
        if node.attr in self.LOOSE:
            try:
                owner = ast.unparse(node.value).lower()
            except Exception:  # pragma: no cover - unparse is total on ast
                return None
            if "telemetry" in owner or "tracer" in owner:
                return node.attr
        return None

    def _flag(self, report: CheckReport, ctx: FileContext, lineno: int,
              store: str, what: str) -> None:
        report.add(
            Diagnostic(
                code=self.code,
                message=f"{what} of telemetry store {store!r}: mutate "
                "through the Telemetry/Tracer API (inc/set_gauge/"
                "observe, begin/end/instant) so the lock and the "
                "freshness stamp see it",
                loc=f"{ctx.path}:{lineno}",
            )
        )

    def check(self, ctx: FileContext, report: CheckReport) -> None:
        if self._allowlisted(ctx.path):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        store = self._store_attr(t.value)
                        if store:
                            self._flag(report, ctx, node.lineno,
                                       store, "item write")
                    elif isinstance(t, ast.Attribute):
                        store = self._store_attr(t)
                        if store:
                            self._flag(report, ctx, node.lineno,
                                       store, "rebind")
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if (isinstance(t, ast.Subscript)
                            and self._store_attr(t.value)):
                        self._flag(report, ctx, node.lineno,
                                   self._store_attr(t.value), "item delete")
            elif isinstance(node, ast.Call):
                func = node.func
                if (isinstance(func, ast.Attribute)
                        and func.attr in self.MUTATORS):
                    store = self._store_attr(func.value)
                    if store:
                        self._flag(report, ctx, node.lineno, store,
                                   f"{func.attr}() call")


DEFAULT_RULES: List[Rule] = [
    DirectTimeRule(),
    KernelLaunchOutsideKernelsRule(),
    SupportsBeforeExecuteRule(),
    WtToNonConsumerRule(),
    TelemetryDisciplineRule(),
]


# --------------------------------------------------------------- driver


def _collect_files(paths) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    return files


def analyze_rules(paths, rules: Optional[List[Rule]] = None) -> CheckReport:
    """Run every rule over every ``.py`` file under `paths`."""
    rules = DEFAULT_RULES if rules is None else rules
    report = CheckReport(analyzer="rules")
    parsed: List[Tuple[str, List[str], ast.Module]] = []
    classes: Dict[str, ClassDecl] = {}
    for f in _collect_files(paths):
        try:
            src = f.read_text()
            tree = ast.parse(src, filename=str(f))
        except (OSError, SyntaxError) as e:
            report.add(
                Diagnostic(
                    code="CVK304", message=f"unparseable: {e}",
                    severity="warning", loc=str(f),
                )
            )
            continue
        parsed.append((str(f), src.splitlines(), tree))
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                classes[node.name] = ClassDecl(
                    name=node.name,
                    path=str(f),
                    bases=tuple(
                        b.attr if isinstance(b, ast.Attribute)
                        else b.id if isinstance(b, ast.Name) else ""
                        for b in node.bases
                    ),
                    methods={
                        item.name: item.lineno
                        for item in node.body
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
                    },
                )
    for path, lines, tree in parsed:
        ctx = FileContext(path=path, lines=lines, tree=tree, classes=classes)
        for rule in rules:
            rule.check(ctx, report)
    return report
