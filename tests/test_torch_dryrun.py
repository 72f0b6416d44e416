"""The port's dry run (`repro_torch.launch`: `specs`, `mesh`,
`hlo_analysis`, `dryrun`, `inspect_cell`; the sharding builders of
`repro_torch.distributed.sharding`; `init_decode_state`; the kernels'
meta branches and `cost`s) against the reference's.

Everything the port builds here lives on the meta device: the tests
assert that every tensor is on ``meta`` (nothing is allocated).  The
reference's shapes come from `jax.eval_shape` at full size in this
process; its sharding builders need a mesh of 256 devices, so they run
once in a subprocess with ``--xla_force_host_platform_device_count=256``
(`repro.launch.dryrun` and `repro.launch.inspect_cell` are never
imported here: they set `XLA_FLAGS` at import).  Tolerances: shapes,
dtypes, specs and per-card bytes exactly; model FLOPs rel 1e-12; the op
counter's FLOPs within 5 % of the reference's `hlo_cost` on a reduced
train cell (the remainder is the reference's whole-tile attention count,
checked to 1 %); decode logits rel 1e-6.
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import cell_is_defined as ref_cell_is_defined
from repro.configs.base import get_arch as ref_get_arch
from repro.launch import hlo_analysis as ref_hlo
from repro.launch import specs as ref_specs
from repro.models import lm as ref_lm
from repro.models.blocks import build_stack_plan as ref_stack_plan
from repro_torch.configs import SHAPES, ShapeConfig, cell_is_defined, get_arch, list_archs
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import meta as kernel_meta
from repro_torch.launch import dryrun, hlo_analysis, inspect_cell, mesh
from repro_torch.launch import specs as S
from repro_torch.models import init_decode_state, init_lm, lm_decode_step, lm_prefill

_ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = list_archs()
SHARDED_ARCHS = ("gemma3-1b", "moonshot-v1-16b-a3b", "deepseek-v3-671b")
MESHES = {"data4-model2": {"data": 4, "model": 2}, "16x16": {"data": 16, "model": 16}}


def _path(path) -> str:
    parts = []
    for p in path:
        parts.append(str(getattr(p, "key", getattr(p, "idx", p))))
    return "/".join(parts)


def _ref_leaves(tree) -> dict:
    return {_path(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _slots(cfg, role="decoder"):
    """flat layer index -> (group, repeat, position, repeats), the
    reference's stacking order (as `from_jax` unstacks it)."""
    out = []
    for g, gs in enumerate(ref_stack_plan(cfg, role)):
        for r in range(gs.n_repeat):
            for i in range(len(gs.layers)):
                out.append((g, r, i, gs.n_repeat))
    return out


def _port_name_to_ref(name: str, cfg):
    """A port parameter's dotted name -> (reference path, repeats)."""
    parts = name.split(".")
    pre = ["encoder"] if parts[0] == "encoder" and parts[1] == "layers" else []
    if parts[len(pre)] != "layers":
        return "/".join(parts), 0
    g, _, i, n = _slots(cfg, "encoder" if pre else "decoder")[int(parts[len(pre) + 1])]
    return "/".join([*pre, "stack", str(g), "layers", str(i), *parts[len(pre) + 2:]]), n


def _check_named(named: dict, ref: dict, cfg, what: str):
    """Every port leaf (per layer) against the reference's (stacked) leaf
    of the same name, and every reference leaf covered."""
    covered = set()
    for name, t in named.items():
        assert t.device.type == "meta", (what, name)
        path, n = _port_name_to_ref(name, cfg)
        assert path in ref, (what, name, path)
        shape, dtype = ref[path]
        want = shape[1:] if n else shape
        assert (tuple(t.shape), _dtype(t)) == (want, dtype), (what, name)
        if n:
            assert shape[0] == n, (what, name)
        covered.add(path)
    assert covered == set(ref), (what, sorted(set(ref) - covered)[:5])


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("shape", sorted(REF_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_cells_equal_the_reference(arch, shape):
    ref = REF_SHAPES[shape]
    got = SHAPES[shape]
    assert (got.name, got.seq_len, got.global_batch, got.kind) == (
        ref.name, ref.seq_len, ref.global_batch, ref.kind)
    assert cell_is_defined(get_arch(arch), got) == ref_cell_is_defined(ref_get_arch(arch), ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    assert hlo_analysis.active_param_count(cfg) == pytest.approx(
        ref_hlo.active_param_count(rcfg), rel=1e-12)
    for name in SHAPES:
        shape, rshape = SHAPES[name], REF_SHAPES[name]
        assert hlo_analysis.model_flops_train(cfg, shape) == pytest.approx(
            ref_hlo.model_flops_train(rcfg, rshape), rel=1e-12)
        for decode in (False, True):
            assert hlo_analysis.model_flops_infer(cfg, shape, decode=decode) == pytest.approx(
                ref_hlo.model_flops_infer(rcfg, rshape, decode=decode), rel=1e-12)


# ---------------------------------------------------------------- specs


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference_eval_shape(arch):
    """Params, the train state (moments by `train_config_for`), the
    decode state and the batch / prefill / decode specs at full size,
    leaf for leaf, all on meta."""
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    tcfg, rtcfg = S.train_config_for(cfg), ref_specs.train_config_for(rcfg)
    assert tcfg.optimizer.moment_dtype == rtcfg.optimizer.moment_dtype
    assert tcfg.remat == rtcfg.remat
    ref_state = ref_specs.train_state_shapes(rcfg, rtcfg)
    state = S.train_state_shapes(cfg, tcfg)
    named = dict(state["params"].named_parameters())
    _check_named(named, _ref_leaves(ref_state["params"]), cfg, "params")
    moment = tcfg.optimizer.moment_dtype
    for key in ("m", "v"):
        ref_m = _ref_leaves(ref_state["opt"][key])
        if moment != "int8":
            _check_named(state["opt"][key], ref_m, cfg, key)
            continue
        # int8: the port encodes each layer's moment in blocks of 256, the
        # reference a group's stacked moment: the same blocks where a
        # layer's size is a multiple of 256
        for name, enc in state["opt"][key].items():
            path, n = _port_name_to_ref(name, cfg)
            numel = math.prod(named[name].shape)
            blocks = -(-numel // 256)
            assert (tuple(enc["q"].shape), _dtype(enc["q"])) == ((blocks, 256), "int8")
            assert (tuple(enc["scale"].shape), _dtype(enc["scale"])) == ((blocks,), "float32")
            rq, rdt = ref_m[path + "/q"]
            assert rdt == "int8" and rq == (-(-max(n, 1) * numel // 256), 256), name
    for key, ref_t in (("count", ref_state["opt"]["count"]),):
        assert tuple(state["opt"][key].shape) == ref_t.shape
        assert _dtype(state["opt"][key]) == str(ref_t.dtype)
    assert (tuple(state["step"].shape), _dtype(state["step"])) == (
        ref_state["step"].shape, str(ref_state["step"].dtype))

    shape = SHAPES["decode_32k"]
    ref_dec = ref_specs.decode_state_shapes(rcfg, REF_SHAPES["decode_32k"])
    dec = S.decode_state_shapes(cfg, shape)
    slots = _slots(rcfg)
    assert len(dec["layers"]) == len(slots)
    for (g, _, i, n), cache in zip(slots, dec["layers"]):
        ref_c = ref_dec["groups"][g][i]["self"]
        assert sorted(cache) == sorted(ref_c)
        for k, t in cache.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dtype(t)) == (ref_c[k].shape[1:], str(ref_c[k].dtype))
            assert ref_c[k].shape[0] == n
    for k in ("cross_x", "cross_pos"):
        assert (k in dec) == (k in ref_dec)
        if k in dec:
            assert (tuple(dec[k].shape), _dtype(dec[k])) == (ref_dec[k].shape,
                                                             str(ref_dec[k].dtype))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        for fn, rfn in ((S.batch_specs, ref_specs.batch_specs),
                        (S.prefill_specs, ref_specs.prefill_specs),
                        (S.decode_specs, ref_specs.decode_specs)):
            got, want = fn(cfg, SHAPES[name]), rfn(rcfg, REF_SHAPES[name])
            assert {k: (tuple(v.shape), _dtype(v)) for k, v in got.items()} == {
                k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
            assert all(v.device.type == "meta" for v in got.values())


# ---------------------------------------------------------------- decode state


DECODE_ARCHS = ("gemma3-1b", "mamba2-1.3b", "zamba2-7b", "deepseek-v3-671b",
                "seamless-m4t-medium")


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_init_decode_state_takes_a_prefill(arch):
    """Empty caches filled with a prefill's give its decode logits, and
    match the reference's `init_decode_state` leaf for leaf."""
    cfg = get_arch(arch).reduced()
    model = init_lm(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(3)
    b, s, max_len, src = 2, 10, 24, 12
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    kw = {}
    if cfg.is_encoder_decoder:
        kw["src_embeds"] = torch.from_numpy(
            rng.standard_normal((b, src, cfg.d_model)).astype(np.float32))
    logits, filled = lm_prefill(model, toks, max_len, **kw)
    empty = init_decode_state(cfg, b, max_len, src_len=src, device="cpu")
    assert sorted(empty) == sorted(filled)
    with torch.no_grad():
        for c0, c1 in zip(empty["layers"], filled["layers"]):
            assert sorted(c0) == sorted(c1)
            for k in c0:
                assert (c0[k].shape, c0[k].dtype) == (c1[k].shape, c1[k].dtype), k
                c0[k].copy_(c1[k])
        for k in ("cross_x", "cross_pos"):
            if k in empty:
                assert (empty[k].shape, empty[k].dtype) == (filled[k].shape, filled[k].dtype)
                empty[k] = filled[k]
    tok = logits.argmax(-1)
    want, _ = lm_decode_step(model, tok, s, filled)
    got, _ = lm_decode_step(model, tok, s, empty)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-6, rel

    rcfg = ref_get_arch(arch).reduced()
    ref = jax.eval_shape(lambda: ref_lm.init_decode_state(rcfg, b, max_len, src_len=src))
    for (g, _, i, _), cache in zip(_slots(rcfg), empty["layers"]):
        ref_c = ref["groups"][g][i]["self"]
        for k, t in cache.items():
            assert (tuple(t.shape), _dtype(t)) == (ref_c[k].shape[1:], str(ref_c[k].dtype))
    meta = init_decode_state(cfg, b, max_len, src_len=src, device="meta")
    assert all(t.device.type == "meta" for c in meta["layers"] for t in c.values())


# ---------------------------------------------------------------- builders


@pytest.fixture(scope="module")
def reference_shardings():
    """The reference builders' specs and shard shapes for
    `SHARDED_ARCHS` on `MESHES`, in one 256-device subprocess:
    {arch: {mesh: {builder: {path: [spec, shard shape]}}}}."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = textwrap.dedent(f"""
        import json
        import jax
        from repro.configs.base import SHAPES, get_arch
        from repro.distributed import sharding as shd
        from repro.launch import specs as S

        def spec_list(spec):
            return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]

        def rows(tree, shardings):
            out = {{}}
            for (p, x), (_, s) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                      jax.tree_util.tree_flatten_with_path(shardings)[0]):
                key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
                out[key] = [spec_list(s.spec), list(s.shard_shape(x.shape))]
            return out

        out = {{}}
        for arch in {list(SHARDED_ARCHS)!r}:
            cfg = get_arch(arch)
            params = S.param_shapes(cfg)
            dec = S.decode_state_shapes(cfg, SHAPES["decode_32k"])
            batch = S.batch_specs(cfg, SHAPES["train_4k"])
            out[arch] = {{}}
            for name, shape in {json.dumps(MESHES)}.items():
                m = jax.make_mesh(tuple(shape.values()), tuple(shape))
                out[arch][name] = {{
                    "params": rows(params, shd.shard_params(params, m)),
                    "inference": rows(params, shd.shard_params_for_inference(params, m)),
                    "cache": rows(dec, shd.shard_cache(dec, m)),
                    "batch": rows(batch, shd.shard_batch(batch, m)),
                    "replicated": rows(batch, shd.replicated(batch, m)),
                }}
        print(json.dumps(out))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_builders_match_the_reference(reference_shardings, arch, mesh_name):
    """Each builder's per-leaf spec equals the reference's
    `PartitionSpec` and its per-card shape the reference's shard shape,
    on the reference's stacked layout of the port's meta leaves."""
    cfg = get_arch(arch)
    m = shd.Mesh(MESHES[mesh_name], logical=True)
    model = S.param_shapes(cfg)
    params = S.reference_layout(dict(model.named_parameters()), cfg)
    dec = S.reference_cache_layout(S.decode_state_shapes(cfg, SHAPES["decode_32k"]), cfg)
    batch = S.batch_specs(cfg, SHAPES["train_4k"])
    got = {"params": shd.shard_params(params, m),
           "inference": shd.shard_params_for_inference(params, m),
           "cache": shd.shard_cache(dec, m), "batch": shd.shard_batch(batch, m),
           "replicated": shd.replicated(batch, m)}
    ref = reference_shardings[arch][mesh_name]
    for builder, shards in got.items():
        want = ref[builder]
        assert sorted(shards) == sorted(want), builder
        total = 0
        for path, leaf in shards.items():
            assert [_spec_json(leaf.spec), list(leaf.card_shape)] == want[path], (builder, path)
            total += math.prod(want[path][1]) * leaf.itemsize
        assert shd.tree_bytes_per_card(shards) == total


def test_meshes():
    prod = mesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256 and prod.logical
    assert mesh.make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    host = mesh.make_host_mesh(2, devices=["cpu"] * 4)
    assert host.shape == {"data": 2, "model": 2} and len(host.devices) == 4
    with pytest.raises(ValueError):
        mesh.make_host_mesh(3, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mesh.make_host_mesh(1)
    assert shd.FSDP_MIN_TREE_BYTES == 3 << 30


# ---------------------------------------------------------------- the counter


def test_op_counter_flops_against_the_reference_hlo_cost(capsys):
    """gemma3-1b `.reduced()`, 4 x 16 tokens: the counter's FLOPs within
    5 % of the reference's `hlo_cost` of its compiled train step on one
    CPU device; without attention (the kernels' band-pair counts, the
    reference's whole 512-tiles), within 1 %.  Flash forward twice
    (remat) and its backward once a layer."""
    rcfg = ref_get_arch("gemma3-1b").reduced()
    from repro.configs.base import ShapeConfig as RefShape

    b, s = 4, 16
    rtcfg = ref_specs.train_config_for(rcfg)
    txt = (jax.jit(ref_specs.train_fn(rcfg, rtcfg))
           .lower(ref_specs.train_state_shapes(rcfg, rtcfg),
                  ref_specs.batch_specs(rcfg, RefShape("t", s, b, "train")))
           .compile().as_text())
    ref = ref_hlo.hlo_cost(txt)
    cfg = get_arch("gemma3-1b").reduced()
    rec, counter = dryrun.run_cell(cfg, ShapeConfig("tiny_train", s, b, "train"))
    assert rec["status"] == "ok" and rec["fits"]
    calls = rec["kernel_calls"]
    assert calls == {"flash_attention": 2 * cfg.n_layers,
                     "flash_attention_bwd": cfg.n_layers}
    with capsys.disabled():
        print(f"\n[dryrun] gemma3-1b reduced 4x16 train: counter {counter.flops:.6e} FLOPs "
              f"{counter.bytes:.6e} bytes; reference hlo_cost {ref.flops:.6e} FLOPs "
              f"{ref.bytes:.6e} bytes")
    assert abs(counter.flops - ref.flops) <= 0.05 * ref.flops
    hd, h = cfg.resolved_head_dim, cfg.n_heads
    ref_attn = cfg.n_layers * (2 * 2 * 2 * hd + 2 * 5 * hd) * b * h * s * s  # one tile
    kern = sum(st.flops for st in counter.kernels.values())
    assert abs((counter.flops - kern) - (ref.flops - ref_attn)) <= 0.01 * (ref.flops - ref_attn)


def test_op_counter_counts_conv1d_per_mamba_layer():
    cfg = get_arch("mamba2-1.3b").reduced()
    rec = dryrun.lower_cell(cfg, ShapeConfig("tiny_train", 32, 2, "train"))
    assert rec["kernel_calls"] == {"conv1d_fused": 2 * cfg.n_layers,
                                   "conv1d_fused_bwd": cfg.n_layers}
    rec = dryrun.lower_cell(cfg, ShapeConfig("tiny_prefill", 32, 2, "prefill"))
    assert rec["kernel_calls"] == {"conv1d_fused": cfg.n_layers}


def test_dryrun_cli(tmp_path, capsys):
    """gemma3-1b's four cells and stablelm-3b's skipped long cell at full
    size on meta; `--impl baseline` refused with the decision named."""
    assert dryrun.main(["--arch", "gemma3-1b", "--out", str(tmp_path)]) == 0
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert len(recs) == 4 and all(r["status"] == "ok" for r in recs.values())
    train = recs["gemma3-1b__train_4k__1.json"]
    assert train["kernel_calls"] == {"flash_attention": 52, "flash_attention_bwd": 26}
    assert train["fits"] and train["roofline"]["t_collective_s"] is None
    assert train["roofline"]["peak_flops"] == 989e12
    assert dryrun.main(["--arch", "stablelm-3b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    skip = json.loads((tmp_path / "stablelm-3b__long_500k__1.json").read_text())
    ok, reason = ref_cell_is_defined(ref_get_arch("stablelm-3b"), REF_SHAPES["long_500k"])
    assert skip["status"] == "skipped" and skip["reason"] == reason and not ok
    assert dryrun.main(["--impl", "baseline", "--out", str(tmp_path)]) == 2
    assert "runtime_flags" in capsys.readouterr().err


def test_inspect_cell_prints_top_ops(tmp_path, capsys):
    ops = tmp_path / "ops.json"
    assert inspect_cell.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--top", "5",
                              "--save-ops", str(ops)]) == 0
    out = capsys.readouterr().out
    assert "=== top FLOPs" in out and "=== top bytes" in out and "kernel:decode_mlp" in out
    rows = json.loads(ops.read_text())
    assert any(r["op"] == "decode_mlp" and r["calls"] == 26 for r in rows)


# ---------------------------------------------------------------- kernels


def test_meta_branches_launch_nothing():
    """On meta each wrapper returns empty outputs in the kernel's shapes
    and layouts, reports one call with its `cost`, and neither launches
    (LAUNCHES unchanged) nor runs its plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.conv1d_fused import backward as cbwd
    from repro_torch.kernels.conv1d_fused import conv1d_fused
    from repro_torch.kernels.conv1d_fused import cost as conv1d_cost
    from repro_torch.kernels.conv1d_fused import kernel as ckern
    from repro_torch.kernels.decode_mlp import cost as decode_mlp_cost
    from repro_torch.kernels.decode_mlp import decode_mlp
    from repro_torch.kernels.decode_mlp import kernel as dkern
    from repro_torch.kernels.flash_attention import backward as fbwd
    from repro_torch.kernels.flash_attention import kernel as fkern
    from repro_torch.models.flash_attention import flash_attention as model_flash

    before = (fkern.LAUNCHES, fbwd.LAUNCHES, ckern.LAUNCHES, cbwd.LAUNCHES, dkern.LAUNCHES)
    heard = []
    meta = dict(device="meta", dtype=torch.bfloat16)
    with kernel_meta.listen(lambda *a: heard.append(a)):
        q = torch.empty((2, 30, 8, 64), **meta).transpose(1, 2).requires_grad_(True)
        k = torch.empty((2, 30, 2, 64), **meta).transpose(1, 2).requires_grad_(True)
        v = torch.empty((2, 30, 2, 64), **meta).transpose(1, 2).requires_grad_(True)
        o = model_flash(q, k, v, causal=True, window=0)
        assert o.shape == (2, 8, 30, 64) and o.stride() == q.stride()
        o.sum().backward()
        assert q.grad.shape == q.shape and k.grad.shape == k.shape
        x = torch.empty((2, 40, 96), **meta).requires_grad_(True)
        w = torch.empty((4, 96), **meta).requires_grad_(True)
        bias = torch.empty((96,), **meta).requires_grad_(True)
        y = conv1d_fused(x, w, bias)
        y.sum().backward()
        assert y.shape == x.shape and x.grad.shape == x.shape
        xm = torch.empty((3, 64), **meta)
        out = decode_mlp(xm, torch.empty((64, 80), **meta), torch.empty((64, 80), **meta),
                         torch.empty((80, 64), **meta))
        assert out.shape == (3, 64) and out.device.type == "meta"
    names = [h[0] for h in heard]
    assert names == ["flash_attention", "flash_attention_bwd", "conv1d_fused",
                     "conv1d_fused_bwd", "decode_mlp"]
    shape = dict(b=2, hq=8, hkv=2, sq=30, sk=30, hd=64, vd=64, causal=True, window=0,
                 itemsize=2)
    assert heard[0][1:] == fa.cost(**shape, lse=True)
    assert heard[1][1:] == fbwd.cost(**shape)
    assert heard[2][1:] == conv1d_cost(2, 40, 96, 4, 2)
    assert heard[3][1:] == cbwd.cost(2, 40, 96, 4, 2)
    assert heard[4][1:] == decode_mlp_cost(3, 64, 80, 2)
    after = (fkern.LAUNCHES, fbwd.LAUNCHES, ckern.LAUNCHES, cbwd.LAUNCHES, dkern.LAUNCHES)
    assert after == before


def _band(sq, sk, causal, window):
    qp = np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= qp - kp < window
    return int(ok.sum())


# the kernel table's shapes (PERF.md; chip_smoke.py's phases 9, 13, 17, 18)
FLASH_SHAPES = [
    (4, 4, 1, 700, 700, 256, 256, True, 0), (4, 4, 1, 700, 700, 256, 256, True, 512),
    (4, 32, 32, 700, 700, 80, 80, True, 0), (4, 16, 16, 700, 700, 128, 128, True, 0),
    (4, 128, 128, 700, 700, 192, 128, True, 0), (4, 128, 128, 1023, 1023, 56, 56, True, 0),
    (4, 16, 16, 1024, 1024, 64, 64, False, 0), (4, 16, 16, 1, 1024, 64, 64, False, 0),
    (4, 4, 1, 1024, 1024, 256, 256, True, 0), (4, 4, 1, 1024, 1024, 256, 256, True, 512),
    (1, 2, 1, 200, 50, 64, 64, True, 40),
]


@pytest.mark.parametrize("itemsize", (4, 2))
def test_kernel_costs_equal_the_bounds_they_replace(itemsize):
    """Each package's `cost` equals the count `chip_smoke.py` computed
    inline before it moved (so PERF.md's bounds do not move)."""
    from repro_torch.kernels import conv1d_fused, decode_mlp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_tile
    from repro_torch.kernels.conv1d_fused import backward as cbwd
    from repro_torch.kernels.flash_attention import backward as fbwd
    from repro_torch.core import tiling, transforms

    for b, hq, hkv, sq, sk, hd, vd, causal, window in FLASH_SHAPES:
        pairs = _band(sq, sk, causal, window)
        q, k, v, o = b * hq * sq * hd, b * hkv * sk * hd, b * hkv * sk * vd, b * hq * sq * vd
        kw = dict(b=b, hq=hq, hkv=hkv, sq=sq, sk=sk, hd=hd, vd=vd, causal=causal,
                  window=window, itemsize=itemsize)
        assert fa.cost(**kw) == (2 * (hd + vd) * pairs * b * hq, itemsize * (q + k + v + o))
        lse = b * hq * sq
        assert fbwd.cost(**kw) == (
            2 * (3 * hd + 2 * vd) * b * hq * pairs,
            itemsize * (2 * q + 2 * (k + v) + 2 * o) + 4 * lse)
    for b, length, d, kk in ((4, 768, 4352, 4), (2, 129, 4352, 4), (4, 768, 7296, 4),
                             (2, 777, 100, 4), (4, 1024, 4352, 4)):
        n = b * length * d
        assert conv1d_fused.cost(b, length, d, kk, itemsize) == (
            2 * kk * b * length * d, itemsize * (2 * b * length * d + kk * d + d))
        assert cbwd.cost(b, length, d, kk, itemsize) == (
            (4 * kk + 10) * n, itemsize * (3 * n + 2 * kk * d + 2 * d))
    for b, d, f in ((4, 1152, 6912), (4, 3584, 14336), (4, 1024, 4096), (11, 200, 700)):
        assert decode_mlp.cost(b, d, f, itemsize) == (
            2 * b * 3 * d * f, itemsize * (3 * d * f + 2 * b * d))
    for tr, b, h, c_in, c_out, groups in (
            (transforms.WinogradTransform(m=5, k=3), 8, 64, 64, 64, 1),
            (transforms.FFTTransform(t=16, k=3), 8, 64, 8, 8, 1),
            (transforms.FFTTransform(t=16, k=3), 2, 32, 8, 8, 2)):
        spec = tr.kernel_spec()
        plan = tiling.TilePlan.build(h, h, tr.k, 1, tr.t)
        xp = b * (plan.n_tiles_h * spec.t_out + spec.k - 1) ** 2 * c_in
        rhs = 1000
        out = b * plan.h_out * plan.w_out * c_out
        n_tiles = b * plan.n_tiles_h * plan.n_tiles_w
        assert fused_tile.cost(spec, plan.n_tiles_h, plan.n_tiles_w, b, c_in, c_out, groups,
                               xp, rhs, out, itemsize) == (
            2 * spec.macs_per_tile(c_in, c_out, groups) * n_tiles,
            itemsize * (xp + rhs + out))
    assert jnp is not None
