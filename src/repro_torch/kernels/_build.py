"""Build and bind the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each kernel is one `csrc/*.cu` file with a plain C entry point that
launches on the caller's stream and returns ``cudaGetLastError()``.  A
`CudaLibrary` compiles its source with nvcc for sm_90a on first use, into
``build/repro_torch/`` at the repository root, and loads it with ctypes.
Nothing is built or loaded when a module is imported: the CPU tests
import every kernel module without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# guards every wrapper's `LAUNCHES += 1`: replica threads launch kernels
# concurrently, and an unguarded read-add-write on a module global can
# lose counts
COUNT_LOCK = threading.Lock()
# entry-point calls by (library stem, card index), beside each wrapper's own
# `LAUNCHES`: where a run on several cards launched its kernels
CARD_LAUNCHES: Dict[Tuple[str, int], int] = {}  # guarded-by: COUNT_LOCK

# a quoted include: a header of the repository, relative to the includer,
# else one of the headers every kernel source shares (INCLUDE_DIR)
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
INCLUDE_DIR = pathlib.Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(INCLUDE_DIR),
)


def refuse_grad(kernel: str, roadmap: str, *tensors: torch.Tensor) -> None:
    """Raise `NotImplementedError` when grad mode is on and an input of a
    kernel that has no backward requires grad: its output, written by the
    kernel into a fresh tensor, would carry no `grad_fn`, and a backward
    pass would silently leave everything upstream without a gradient.
    `roadmap` names the item that brings the backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no autograd backward: under grad its output would "
            f"carry no gradient ({roadmap})"
        )


def source_text(path: pathlib.Path, seen: Optional[set] = None) -> bytes:
    """A source's bytes followed by those of every header it includes by a
    quoted path, recursively, each once: what a build depends on."""
    path = pathlib.Path(path).resolve()
    seen = set() if seen is None else seen
    seen.add(path)
    text = path.read_bytes()
    out = [text]
    for name in _INCLUDE.findall(text.decode()):
        header = path.parent / name
        if not header.exists():  # nvcc's -I: a shared header
            header = INCLUDE_DIR / name
        header = header.resolve()
        if header not in seen:
            out.append(source_text(header, seen))
    return b"".join(out)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(pathlib.Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (the release and build)."""
    out = subprocess.run([nvcc(), "--version"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


class CudaLibrary:
    """One kernel source, built once per content version and loaded once.

    `entry_points` maps each exported C function to its ctypes argtypes
    (``c_void_p`` for every pointer and the stream, ``c_int`` for ints);
    every entry point returns a CUDA error code as ``int``.
    """

    def __init__(
        self,
        source: pathlib.Path,
        stem: str,
        entry_points: Dict[str, Sequence],
    ):
        self.source = pathlib.Path(source)
        self.stem = stem
        self.entry_points = dict(entry_points)
        self._lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock
        self._lock = threading.Lock()

    def library_path(self) -> pathlib.Path:
        """Build output, named by the content hash of the source and the
        headers it includes, so an edited source or header never loads a
        stale library."""
        digest = hashlib.sha1(
            source_text(self.source) + " ".join(NVCC_FLAGS).encode()
        )
        return BUILD_DIR / f"lib{self.stem}-{digest.hexdigest()[:12]}.so"

    def build(self) -> pathlib.Path:
        """Compile the kernel (once per source version); returns the .so.
        Writes to a temporary name and renames, so concurrent builds never
        load a half-written library."""
        lib = self.library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {self.source}:\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return lib

    def fn(self, name: str):
        """The bound C entry point `name` (builds and loads on first use)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for fname, argtypes in self.entry_points.items():
                    f = getattr(lib, fname)
                    f.argtypes = list(argtypes)
                    f.restype = ctypes.c_int
                self._lib = lib
        return getattr(self._lib, name)

    def launch(self, name: str, device, *args) -> None:
        """Call entry point `name` with `args` and the current stream of
        `device` (appended last), on that card, then raise if it returned
        a CUDA error: a refused launch never runs, and a later synchronize
        would not report it.  Counts the call in `CARD_LAUNCHES`."""
        fn = self.fn(name)
        index = device.index if device.index is not None else torch.cuda.current_device()
        # the current stream's cudaStream_t, without building a Stream object
        if index == torch.cuda.current_device():
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            raise RuntimeError(f"{name} failed: CUDA error {err}")
        with COUNT_LOCK:
            CARD_LAUNCHES[self.stem, index] = CARD_LAUNCHES.get((self.stem, index), 0) + 1
