"""convcheck: the coded diagnostic vocabulary (``CVK###`` codes, see
`diagnostics.HINTS`) that `program.lower` raises through.  The static
analyzers (IR verifier, lock and rule checks) are not ported yet."""

from repro_torch.convserve.check.diagnostics import (  # noqa: F401
    CheckReport,
    Diagnostic,
    ProgramError,
    VerificationError,
    program_error,
)

__all__ = [
    "CheckReport",
    "Diagnostic",
    "ProgramError",
    "VerificationError",
    "program_error",
]
