"""Coded diagnostics: the one vocabulary every convcheck analyzer —
and `program.lower`'s own runtime validation — speaks.

A `Diagnostic` is one finding: a stable ``CVK###`` code, a severity, a
location (file:line for AST findings, net/stage coordinates for IR
findings), a one-line message, and a one-line fix hint.  `CheckReport`
collects them per analyzer run; `ProgramError` / `VerificationError`
carry them across the raise boundary so a runtime lowering failure and
a static verifier finding print identically and are matched by tests
the same way (both subclass ValueError, and str() keeps the plain
message the pre-convcheck ValueErrors carried).

Code space (documented in README "Static verification"):

  CVK1xx  IR verifier (`check.ir`) — ExecProgram legality
  CVK2xx  lock discipline (`check.locks`)
  CVK3xx  clock + kernel + registry conventions (`check.rules`)
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Tuple

ERROR = "error"
WARNING = "warning"

# one-line fix hints, keyed by code — a diagnostic may override, but the
# table is the documented default (and the README's source of truth)
HINTS = {
    "CVK101": "re-plan the net, or load the plan file for this net",
    "CVK102": "re-plan: every conv layer needs a LayerPlan",
    "CVK103": "stale plan file: re-plan against the current NetSpec",
    "CVK104": "unknown kind/algo: check spelling against the registry",
    "CVK105": "keep one dtype across a fusion group (and the plan dtype)",
    "CVK106": "channel chain broken: layer c_in must equal producer c_out",
    "CVK107": "fusion groups may only name conv layers",
    "CVK108": "fusion groups must cover adjacent conv units",
    "CVK109": "remove the layer from one of the overlapping groups",
    "CVK110": "maxpool must terminate its fusion group (move or split)",
    "CVK111": "tile_rows oversizes the resident slab: re-derive via "
              "planner.plan_fusion_groups",
    "CVK112": "joint kernel matrices overflow the shared level: split "
              "the group",
    "CVK113": "shape chain breaks under stride/pool: pick a bucket that "
              "survives NetSpec.downsample_factor",
    "CVK114": "kernel-cache key is not injective here: restore the "
              "algorithm's declared weight params / deduplicate units",
    "CVK115": "members cannot chain: same transform family with "
              "compatible tiles required",
    "CVK116": "stage geometry disagrees with shape propagation: re-plan "
              "at the plan's input_hw",
    "CVK201": "mutate guarded fields inside `with self.<lock>:` (or mark "
              "the helper `# holds-lock: <lock>` / suffix it `_locked`)",
    "CVK202": "lock-order cycle: acquire locks in one global order",
    "CVK203": "annotate shared fields with `# guarded-by: <lock>`",
    "CVK301": "read time through the injected Clock (runtime/clock.py)",
    "CVK302": "measure through the injected Clock (runtime/clock.py)",
    "CVK303": "convserve code must route time/sleep through a Clock",
    "CVK304": "fix the syntax error so the linter can parse the file",
    "CVK310": "declare supports() before execute() on the Algorithm",
    "CVK311": "this algorithm does not consume wt=: drop the argument",
    "CVK320": "launch through the kernel's wrapper in "
              "repro_torch.kernels (it checks operands and counts "
              "launches); keep CUDA library and Triton calls there",
    "CVK330": "mutate metrics through the Telemetry/Tracer API "
              "(inc/set_gauge/observe, begin/end/instant) -- direct "
              "store pokes skip the lock and the freshness stamp",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One coded finding."""

    code: str
    message: str
    severity: str = ERROR
    loc: str = ""  # "path:line" or "net/stage" coordinates
    hint: str = ""

    def __post_init__(self):
        if self.severity not in (ERROR, WARNING):
            raise ValueError(f"unknown severity {self.severity!r}")
        if not self.hint:
            object.__setattr__(self, "hint", HINTS.get(self.code, ""))

    def format(self) -> str:
        loc = f"{self.loc}: " if self.loc else ""
        tail = f"  [fix: {self.hint}]" if self.hint else ""
        return f"{loc}{self.code} {self.severity}: {self.message}{tail}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CheckReport:
    """All findings of one analyzer run (or several merged runs)."""

    analyzer: str = ""
    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, other: "CheckReport") -> None:
        self.diagnostics.extend(other.diagnostics)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> Tuple[str, ...]:
        return tuple(sorted({d.code for d in self.diagnostics}))

    def has(self, code: str) -> bool:
        return any(d.code == code for d in self.diagnostics)

    def format(self) -> str:
        if not self.diagnostics:
            return f"{self.analyzer or 'check'}: clean"
        return "\n".join(d.format() for d in self.diagnostics)

    def to_dict(self) -> dict:
        return {
            "analyzer": self.analyzer,
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)


class ProgramError(ValueError):
    """A lowering/IR-structure failure carrying its diagnostic.

    Subclasses ValueError so callers (and tests) that matched the old
    inline ``raise ValueError(...)`` messages keep working; str() is the
    plain message, the code rides on `.diagnostic`.
    """

    def __init__(self, diagnostic: Diagnostic):
        super().__init__(diagnostic.message)
        self.diagnostic = diagnostic

    @property
    def code(self) -> str:
        return self.diagnostic.code


class VerificationError(ValueError):
    """A verifier rejection carrying the whole report (one or many
    diagnostics).  str() lists every error message, so substring matching
    against any individual finding still works."""

    def __init__(self, report: CheckReport):
        msgs = "; ".join(d.message for d in report.errors) or "verification failed"
        codes = ",".join(sorted({d.code for d in report.errors}))
        super().__init__(f"[{codes}] {msgs}" if codes else msgs)
        self.report = report

    @property
    def codes(self) -> Tuple[str, ...]:
        return tuple(sorted({d.code for d in self.report.errors}))


def program_error(code: str, message: str, *, loc: str = "") -> ProgramError:
    """Shorthand used by `program.lower` and the IR verifier."""
    return ProgramError(Diagnostic(code=code, message=message, loc=loc))
