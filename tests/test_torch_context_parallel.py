"""Context-parallel attention (`models.attention.cp_attention`) on meshes
of CPU entries, against the whole attention and the reference.

Under `attention_cp_axis` and a device mesh put in effect by
`distributed.sharding.use_mesh` (the counterpart of the reference's
``with mesh:``), q's sequence is cut into M contiguous stripes (M the
mesh's axis of that name), the batch over ``data``, each stripe run by
`chunked_attention` with a whole copy of K, V and their positions; the
outputs come back in order.  A stripe's rows are computed as the whole
call computes them, so the split equals the whole within rel 1e-6 (a
smaller einsum may block its sums otherwise); a reduced gemma3-1b's
prefill under it is held to the reference's prefill under its chunked
attention at rel 1e-5, fp32.
"""

import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import init_lm as jax_init_lm
from repro.models import lm_prefill as jax_prefill
from repro.models import runtime_flags as jax_flags
from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import Mesh, current_mesh, use_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import from_jax, lm_prefill
from repro_torch.models import runtime_flags as port_flags

from _torch_params import nontrivial  # the seeded constant-drawn leaves

SPLIT_REL = 1e-6
PREFILL_REL = 1e-5


def _rel(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


def _cpu_mesh(shape):
    return Mesh(shape, devices=["cpu"] * math.prod(shape.values()))


@pytest.fixture
def stripes(monkeypatch):
    """Every `chunked_attention` call's q rows and positions."""
    calls = []
    real = attn_mod.chunked_attention

    def chunked(q, k, v, q_pos, kv_pos, **kw):
        calls.append((tuple(q.shape), q_pos.clone(), tuple(k.shape)))
        return real(q, k, v, q_pos, kv_pos, **kw)

    monkeypatch.setattr(attn_mod, "chunked_attention", chunked)
    return calls


def _qkv(b=2, s=37, hq=4, hkv=2, hd=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, hd, generator=g) for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("shape,blocks", [({"data": 1, "model": 4}, 1),
                                          ({"data": 2, "model": 4}, 2),
                                          ({"data": 3, "model": 4}, 1)])
@pytest.mark.parametrize("window", [0, 8])
def test_full_attention_runs_q_stripes_under_a_mesh(stripes, shape, blocks, window):
    """4 `chunked_attention` calls a batch block on contiguous `q_pos`
    stripes covering 0..S-1, each with the whole K / V; the batch splits
    over data only where it divides (2 rows over 3 do not); the output
    equals the whole call's."""
    q, k, v = _qkv()
    with port_flags.overrides(attention_cp_axis="model"):
        whole = attn_mod.full_attention(q, k, v, window=window)
        assert len(stripes) == 1
        stripes.clear()
        with use_mesh(_cpu_mesh(shape)) as mesh:
            assert current_mesh() is mesh
            y = attn_mod.full_attention(q, k, v, window=window)
    assert current_mesh() is None
    assert len(stripes) == 4 * blocks
    for i in range(blocks):
        calls = stripes[4 * i:4 * i + 4]
        pos = torch.cat([c[1] for c in calls], dim=1)
        assert torch.equal(pos, torch.arange(37, dtype=torch.int32).expand(2 // blocks, 37))
        assert [c[0][1] for c in calls] == [10, 9, 9, 9]
        assert all(c[2] == (2 // blocks, 37, 2, 16) for c in calls)
    assert y.shape == whole.shape
    assert _rel(y.numpy(), whole.numpy()) <= SPLIT_REL


def test_attention_runs_whole_without_a_device_mesh(stripes):
    """No mesh in effect, a logical mesh, a model axis of 1, or no CP axis:
    one whole call."""
    q, k, v = _qkv()
    with port_flags.overrides(attention_cp_axis="model"):
        attn_mod.full_attention(q, k, v)
        with use_mesh(Mesh({"data": 16, "model": 16}, logical=True)):
            attn_mod.full_attention(q, k, v)
        with use_mesh(_cpu_mesh({"data": 4, "model": 1})):
            attn_mod.full_attention(q, k, v)
    with use_mesh(_cpu_mesh({"data": 1, "model": 4})):
        with port_flags.overrides(attention_impl="chunked"):
            attn_mod.full_attention(q, k, v)
    assert [c[0][1] for c in stripes] == [37] * 4


@contextlib.contextmanager
def _reference_chunked():
    old = dataclasses.asdict(jax_flags.FLAGS)
    try:
        jax_flags.FLAGS.attention_impl = "chunked"
        yield
    finally:
        for key, val in old.items():
            setattr(jax_flags.FLAGS, key, val)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-14b"])
def test_cp_prefill_matches_the_reference_chunked_prefill(stripes, arch):
    """A reduced config's `lm_prefill` with q stripes over a 4-entry
    model axis, against the reference's prefill under
    ``attention_impl="chunked"`` at the same numpy weights and tokens."""
    cfg = jax_get_arch(arch).reduced()
    tree = nontrivial(jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), cfg)))
    model = from_jax(tree, get_arch(arch).reduced(), device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    with _reference_chunked():
        ref, _ = jax.jit(lambda p, t: jax_prefill(p, cfg, t, 40))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(toks))
    with port_flags.overrides(attention_cp_axis="model"), use_mesh(
            _cpu_mesh({"data": 1, "model": 4})):
        y, _ = lm_prefill(model, torch.from_numpy(toks).long(), 40)
    assert len(stripes) == 4 * cfg.n_layers
    assert _rel(y.numpy(), ref) < PREFILL_REL
