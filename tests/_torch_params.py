"""Seeded values for the reference's constant-drawn leaves, shared by the
port's parity tests.

The reference draws zamba2's `lora_*_b` as zeros (a fresh LoRA adds
nothing and its `lora_*_a` get no gradient), the three `lora_*_a` from
one key (equal), and mamba's `A_log`, `dt_bias` and `D` as constants.
`nontrivial` gives them seeded non-trivial values in the numpy tree that
is then fed to both packages, so that a parity test sees them at work.
"""

import numpy as np


def nontrivial(tree, seed=0):
    """A copy of the reference's numpy tree with its constant-drawn leaves
    replaced by seeded values."""
    rng = np.random.default_rng(seed)
    draw = {
        "lora_b": lambda a: rng.standard_normal(a.shape) * 0.1,
        "lora_a": lambda a: a + rng.standard_normal(a.shape) * 0.05,
        "A_log": lambda a: rng.uniform(-0.5, 0.5, a.shape),
        "dt_bias": lambda a: rng.uniform(-1.0, 0.5, a.shape),
        "D": lambda a: 1.0 + rng.standard_normal(a.shape) * 0.3,
    }

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                kind = f"lora_{k[-1]}" if k.startswith("lora_") else k
                out[k] = draw[kind](v).astype(v.dtype) if kind in draw else walk(v)
            return out
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(tree)
