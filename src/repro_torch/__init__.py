"""repro_torch -- the PyTorch/CUDA port of the L3-fusion system.

Mirrors `repro`'s layout (`core/`, `kernels/`, `convserve/`, `configs/`)
so each module's counterpart is found by path.  Imports torch, never
jax, and nothing of the `repro` package.
"""
