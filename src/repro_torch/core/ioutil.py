"""Small shared I/O helpers."""

from __future__ import annotations

import os
import pathlib
import tempfile


def atomic_write_text(path: pathlib.Path, text: str) -> None:
    """Write-temp-then-rename so concurrent writers never publish torn
    files (mkstemp gives each writer its own temp name)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
