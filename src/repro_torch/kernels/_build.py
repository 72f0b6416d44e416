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
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Sequence

import torch

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# guards every wrapper's `LAUNCHES += 1`: replica threads launch kernels
# concurrently, and an unguarded read-add-write on a module global can
# lose counts
COUNT_LOCK = threading.Lock()

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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
        """Build output, named by the source's content hash so an edited
        source never loads a stale library."""
        digest = hashlib.sha1(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
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
        `device` (appended last), then raise if it returned a CUDA error:
        a refused launch never runs, and a later synchronize would not
        report it."""
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
