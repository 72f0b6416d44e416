"""convcheck: static verification for the serving stack.

Three analyzers behind one diagnostic vocabulary (``CVK###`` codes,
see `diagnostics.HINTS`):

  * `check.ir.verify_program` — ExecProgram legality (shapes, fusion
    budgets, halo recursion, cache-key injectivity),
  * `check.locks.analyze_locks` — guarded-field discipline and the
    lock-order graph,
  * `check.rules.analyze_rules` — clock discipline and registry
    conventions (pluggable rules).

Run all three from the command line::

    python -m repro_torch.convserve.check [--strict] [--only ir|locks|rules] [--baseline out.json]

Only the diagnostics core is imported eagerly: `program.py` raises
through `ProgramError`, so this package must be importable from inside
`repro_torch.convserve.program`'s own import — the analyzer submodules (which
import `program` back) load on first attribute access.
"""

from repro_torch.convserve.check.diagnostics import (  # noqa: F401
    CheckReport,
    Diagnostic,
    ProgramError,
    VerificationError,
    program_error,
)

_SUBMODULES = ("ir", "locks", "rules", "diagnostics")

__all__ = [
    "CheckReport",
    "Diagnostic",
    "ProgramError",
    "VerificationError",
    "program_error",
    *_SUBMODULES,
]


def __getattr__(name):  # PEP 562: lazy analyzer imports
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
