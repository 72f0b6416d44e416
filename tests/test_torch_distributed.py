"""The port's sharding rule engine (`repro_torch.distributed.sharding`)
against the reference's.  The reference's rules need a jax mesh of 8
devices, so they run once in a subprocess with
``--xla_force_host_platform_device_count=8`` (as `tests/test_distributed.py`
runs them); each of its `PartitionSpec`s, taken as a tuple, must equal
the port's spec for the same path, shape and mesh."""

import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.distributed.sharding import (
    Mesh,
    _tp_only_spec,
    batch_spec,
    cache_spec,
    param_spec,
)

_ROOT = os.path.join(os.path.dirname(__file__), "..")

MESHES = {
    "data2-model4": {"data": 2, "model": 4},
    "data8": {"data": 8},
    "model8": {"model": 8},
    "pod2-data2-model2": {"pod": 2, "data": 2, "model": 2},
}

# (rule, path, shape): the reference test's cases and the rules' edges
CASES = [
    ("param", "stack/0/layers/0/attn/wq", (4, 1024, 512)),
    ("param", "a/wk", (10, 6)),
    ("param", "stack/0/layers/0/moe/w1", (8, 64, 32)),
    ("param", "stack/0/layers/0/ln1", (4, 1024)),
    ("param", "embed", (32000, 512)),
    ("param", "lm_head", (512, 32000)),
    ("param", "stack/0/layers/0/attn/wo", (4, 512, 1024)),
    ("param", "stack/0/layers/0/mlp/w2", (2048, 512)),
    ("param", "stack/0/layers/0/mlp/w1", (4, 6, 512, 2048)),
    ("param", "stack/0/layers/0/mamba/in_proj", (512, 4352)),
    ("param", "stack/0/layers/0/mamba/A_log", (64,)),
    ("param", "stack/0/layers/0/mamba/conv_w", (4, 4352)),
    ("param", "blocks/0/shared_attn/lora_a", (512, 16)),
    ("param", "mtp/proj", (1024, 512)),
    ("param", "tiny/wq", (8, 12)),
    ("param", "odd/wv", (7, 9, 3)),
    ("cache", "groups/0/0/self/k", (4, 8, 128, 4, 64)),
    ("cache", "groups/0/0/self/k", (4, 8, 128, 1, 64)),
    ("cache", "groups/0/0/self/v", (4, 6, 128, 3, 64)),
    ("cache", "groups/0/0/self/pos", (4, 8, 128)),
    ("cache", "groups/0/0/mla/c_kv", (4, 8, 128, 512)),
    ("cache", "groups/0/0/mla/k_rope", (4, 8, 128, 64)),
    ("cache", "groups/0/0/mamba/conv", (4, 8, 3, 4352)),
    ("cache", "groups/0/0/mamba/ssm", (4, 8, 64, 64, 128)),
    ("cache", "flat/k", (8, 16)),
    ("batch", "tokens", (3, 128)),
    ("batch", "tokens", (8, 128)),
    ("batch", "tokens", (4, 128)),
    ("batch", "scalar", ()),
    ("tp_only", "stack/0/layers/0/attn/wq", (4, 1024, 512)),
    ("tp_only", "stack/0/layers/0/moe/w3", (8, 64, 32)),
    ("tp_only", "stack/0/layers/0/ln2", (4, 1024)),
]

PORT_RULES = {"param": param_spec, "cache": cache_spec, "batch": batch_spec,
              "tp_only": _tp_only_spec}


def _as_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def reference_specs():
    """Every case under every mesh, computed by the reference in one
    8-device subprocess: {mesh: [spec as a JSON list, ...]}."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = textwrap.dedent(f"""
        import json
        import jax
        from repro.distributed.sharding import (
            param_spec, cache_spec, batch_spec, _tp_only_spec)
        rules = {{"param": param_spec, "cache": cache_spec,
                  "batch": batch_spec, "tp_only": _tp_only_spec}}
        meshes = {json.dumps(MESHES)}
        cases = {json.dumps(CASES)}
        out = {{}}
        for name, shape in meshes.items():
            mesh = jax.make_mesh(tuple(shape.values()), tuple(shape))
            out[name] = [
                [list(e) if isinstance(e, tuple) else e
                 for e in tuple(rules[r](p, tuple(s), mesh))]
                for r, p, s in cases
            ]
        print(json.dumps(out))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{r}:{p}:{'x'.join(map(str, s)) or 'scalar'}"
                              for r, p, s in CASES])
def test_rule_engine_matches_reference(reference_specs, mesh_name, case):
    shape = MESHES[mesh_name]
    mesh = Mesh(shape, devices=["cpu"] * math.prod(shape.values()))
    rule, path, dims = CASES[case]
    spec = PORT_RULES[rule](path, dims, mesh)
    assert isinstance(spec, tuple) and len(spec) == len(dims)
    assert _as_json(spec) == reference_specs[mesh_name][case]


def test_reference_test_claims_hold_on_the_port():
    """`tests/test_distributed.py::test_sharding_rules_engine`'s claims,
    on the port's tuples."""
    mesh = Mesh({"data": 2, "model": 4}, devices=["cpu"] * 8)
    wq = param_spec("stack/0/layers/0/attn/wq", (4, 1024, 512), mesh)
    assert "model" in wq and "data" in wq
    assert "model" not in param_spec("a/wk", (10, 6), mesh)
    assert param_spec("stack/0/layers/0/moe/w1", (8, 64, 32), mesh)[0] == "model"
    norm = param_spec("stack/0/layers/0/ln1", (4, 1024), mesh)
    assert "model" not in norm and "data" not in norm
    kv = cache_spec("groups/0/0/self/k", (4, 8, 128, 4, 64), mesh)
    assert "data" in kv and "model" in kv
    kv_cp = cache_spec("groups/0/0/self/k", (4, 8, 128, 1, 64), mesh)
    assert kv_cp.index("model") > kv_cp.index("data")  # seq dim, not head dim
    assert batch_spec("tokens", (3, 128), mesh) == (None, None)
    assert batch_spec("tokens", (8, 128), mesh) == ("data", None)


def test_mesh_counts_its_devices():
    mesh = Mesh({"data": 2, "model": 4}, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "model": 4}
    assert len(mesh.devices) == 8 and mesh.devices[0] == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 8 devices"):
        Mesh({"data": 2, "model": 4}, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="size >= 1"):
        Mesh({"data": 0}, devices=[])


def test_mesh_defaults_to_the_cards():
    """Without `devices` a mesh lies on the cards, and without a card it
    raises: nothing quietly falls back to the CPU."""
    if torch.cuda.is_available():
        assert Mesh({"data": 1}).devices == (torch.device("cuda:0"),)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh({"data": 1})
