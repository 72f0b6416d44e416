"""The CUDA tile kernel's wrapper: build, bind, validate, launch.

`csrc/fused_tile.cu` is compiled with nvcc for sm_90a into a shared
library with a plain C entry point, on first use, into
``build/repro_torch/`` at the repository root, and bound with ctypes.
Nothing is built or loaded when this module is imported: the CPU tests
import it without a CUDA toolkit.

`fused_tile_call` takes CUDA tensors only and raises on anything the
kernel does not take; the plain PyTorch version of the same function is
`matrix.matrix_tile_conv`.  `LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import torch

from repro_torch.core import transforms
from repro_torch.core.sharedbuf import SharedBufferPlan
from repro_torch.kernels.fused_tile.matrix import basis

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

# per-block opt-in shared memory of sm_90 (H100): the aliased buffer's cap
MAX_SMEM_BYTES = 232_448
_MAX_EP_OPS = 16  # the epilogue rides in one 64-bit word, 4 bits per op
_RELU = 15

SOURCE = pathlib.Path(__file__).parent / "csrc" / "fused_tile.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# `fused_tile_launch`'s C signature, in order
ARGTYPES = (
    [ctypes.c_void_p] * 6  # xp, rhs, fwd, inv, biases, out
    + [ctypes.c_int] * 12  # batch, h_pad, w_pad, c_in, c_out, t, t_out,
    #                        planes, s_mix, groups, r, n_ops
    + [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p]  # ep_code, smem, stream
)

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(pathlib.Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path() -> pathlib.Path:
    """Build output, named by the source's content hash so an edited
    source never loads a stale library."""
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfused_tile-{digest.hexdigest()[:12]}.so"


def build() -> pathlib.Path:
    """Compile the kernel (once per source version); returns the .so.
    Writes to a temporary name and renames, so concurrent builds never
    load a half-written library."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.fused_tile_launch
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def buffer_bytes(spec: transforms.TileKernelSpec, r: int, c_in: int, c_out: int) -> int:
    """Shared memory of one block: the (S+1, R, P*max(C, C')) f32 aliased
    buffer, priced by the same `sharedbuf` accounting the planner uses."""
    return SharedBufferPlan(
        r=r, c_in=c_in, c_out=c_out, t2=spec.s_mix, elem_bytes=4 * spec.planes
    ).bytes


def fit_r(spec: transforms.TileKernelSpec, r: int, c_in: int, c_out: int) -> int:
    """The largest R <= `r` whose buffer fits one block's shared memory.
    R only groups independent tiles into a task, so lowering it never
    changes the output.  Raises when even R=1 does not fit."""
    r = max(1, r)
    while r > 1 and buffer_bytes(spec, r, c_in, c_out) > MAX_SMEM_BYTES:
        r -= 1
    if buffer_bytes(spec, r, c_in, c_out) > MAX_SMEM_BYTES:
        raise ValueError(
            f"{spec.family} T={spec.t} tile buffer for {c_in}->{c_out} "
            f"channels needs {buffer_bytes(spec, 1, c_in, c_out)} B of "
            f"shared memory at R=1, over the {MAX_SMEM_BYTES} B a block has"
        )
    return r


def encode_epilogue(ep_ops: Tuple, n_bias: int) -> Tuple[int, int]:
    """`ElementwiseOps.kernel_form` tags -> (n_ops, 64-bit op word): 4
    bits per op, in order; ``_RELU`` for relu, else the bias row."""
    if len(ep_ops) > _MAX_EP_OPS:
        raise ValueError(f"epilogue of {len(ep_ops)} ops > {_MAX_EP_OPS}")
    word = 0
    for i, op in enumerate(ep_ops):
        if op[0] == "relu":
            code = _RELU
        elif op[0] == "bias" and 0 <= int(op[1]) < min(n_bias, _RELU):
            code = int(op[1])
        else:
            raise ValueError(f"epilogue op {op!r} not expressible in the kernel")
        word |= code << (4 * i)
    return len(ep_ops), word


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")


def fused_tile_call(
    xp: torch.Tensor,
    rhs: torch.Tensor,
    biases: torch.Tensor,
    *,
    spec: transforms.TileKernelSpec,
    n_tiles_h: int,
    n_tiles_w: int,
    r: int,
    groups: int = 1,
    ep_ops: tuple = (),
) -> torch.Tensor:
    """Launch the CUDA tile kernel on the current stream.

    xp:  (B, H_pad, W_pad, C) f32 padded input, H_pad = nH*T' + K - 1,
         W_pad = nW*T' + K - 1, nW divisible by r.
    rhs: (S, g, P*C/g, P*C'/g) f32 packed right-hand matrices
         (`TileKernelSpec.pack_rhs`).
    biases: (n_bias, C') f32 rows referenced by ("bias", idx) epilogue
         ops (pass one zero row when unused).
    returns: (B, nH*T', nW*T', C') assembled output tiles.
    """
    global LAUNCHES
    b, h_pad, w_pad, c_in = xp.shape
    t, t_out, p, s = spec.t, spec.t_out, spec.planes, spec.s_mix
    if groups < 1 or c_in % groups or rhs.ndim != 4:
        raise ValueError(f"bad groups {groups} / rhs {tuple(rhs.shape)}")
    c_out = rhs.shape[1] * rhs.shape[3] // p
    if r < 1 or n_tiles_w % r:
        raise ValueError(f"n_tiles_w {n_tiles_w} not divisible by r {r}")
    _check("xp", xp, (b, n_tiles_h * t_out + spec.k - 1,
                      n_tiles_w * t_out + spec.k - 1, c_in))
    _check("rhs", rhs, (s, groups, p * c_in // groups, p * c_out // groups))
    _check("biases", biases, (biases.shape[0], c_out))
    if not (xp.device == rhs.device == biases.device):
        raise ValueError("xp, rhs and biases must be on one device")
    n_ops, word = encode_epilogue(ep_ops, biases.shape[0])
    smem = buffer_bytes(spec, r, c_in, c_out)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"R={r} needs {smem} B of shared memory; use fit_r")
    kf, ki = basis(spec, xp.device)
    out = torch.empty(
        (b, n_tiles_h * t_out, n_tiles_w * t_out, c_out),
        dtype=torch.float32, device=xp.device,
    )
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _load().fused_tile_launch(
            xp.data_ptr(), rhs.data_ptr(), kf.data_ptr(), ki.data_ptr(),
            biases.data_ptr(), out.data_ptr(),
            b, h_pad, w_pad, c_in, c_out, t, t_out, p, s, groups, r,
            n_ops, word, smem, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_tile kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
