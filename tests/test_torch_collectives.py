"""The port's compressed all-reduce (`repro_torch.distributed.collectives`)
against the reference's (`repro.distributed.collectives`), on the CPU.

The port runs over `torch.distributed` with the gloo backend: 8 ranks,
forked from one subprocess, sharing a `FileStore`.  The reference runs
`make_compressed_allreduce` on 8 forced XLA host devices in a subprocess
of its own, as `tests/test_distributed.py` runs it.  Both take the same
seeded (8, N) gradients, row r being rank r's, for 3 steps of error
feedback (each step's residual feeds the next).  The int8 payload each
rank sends (the int32 input of the SUM all-reduce; the reference's is
captured at its `psum`) must be bitwise equal, or the test names the
(rank, step, block)s that differ.  The mean and every rank's residual
are held within rel 1e-6 of the reference's, and the mean within the
reference's own 0.05 of the exact f32 mean.  `_one_process`, every
rank's reduction in one process written here from plain torch ops, is
held bitwise against the gloo run.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.distributed import collectives as jax_coll
from repro_torch.distributed import collectives as coll

_ROOT = os.path.join(os.path.dirname(__file__), "..")
RANKS = 8
STEPS = 3
WIDTHS = (64, 1000)
REL_TOL = 1e-6
REFERENCE_BOUND = 0.05  # the reference's own test's bound against the exact mean


def _rel(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


def _grads():
    """{width: (STEPS, RANKS, width) f32}: step t's gradient of rank r."""
    return {n: np.random.default_rng(n).standard_normal((STEPS, RANKS, n)).astype(np.float32)
            for n in WIDTHS}


def _one_process(grads, residuals):
    """Every rank's (mean, new residual) of one compressed all-reduce step,
    rank i's input being (grads[i], residuals[i]): the scale per 256-block
    from the ranks' joint |max|, the int8 payloads summed as int32."""
    gs = [g.float() + r for g, r in zip(grads, residuals)]
    size, shape = gs[0].numel(), gs[0].shape
    blocks = [F.pad(g.reshape(-1), (0, (-size) % 256)).reshape(-1, 256) for g in gs]
    amax = torch.stack([b.abs().amax(dim=1) for b in blocks]).amax(dim=0)
    scale = torch.clamp(amax / 127.0, min=1e-20)[:, None]
    qs = [torch.round(b / scale).to(torch.int8) for b in blocks]
    qsum = torch.stack([q.to(torch.int32) for q in qs]).sum(dim=0, dtype=torch.int32)
    mean = ((qsum.float() / float(len(gs))) * scale).reshape(-1)[:size].reshape(shape)
    return [(mean, g - (q.float() * scale).reshape(-1)[:size].reshape(shape))
            for g, q in zip(gs, qs)]


def _run(code: str, env: dict) -> None:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs on the same gradients: {"port", "ref"} ->
    {width: {"out", "res": (STEPS, RANKS, width), "payload": (STEPS,
    RANKS, blocks, 256) int32}}."""
    tmp = tmp_path_factory.mktemp("collectives")
    grads = _grads()
    np.savez(tmp / "grads.npz", **{str(n): g for n, g in grads.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"), JAX_PLATFORMS="cpu")
    _run(f"""
        import multiprocessing as mp
        import os
        import numpy as np
        import torch
        import torch.distributed as dist
        from repro_torch.distributed import collectives as coll

        TMP, RANKS, STEPS = {str(tmp)!r}, {RANKS}, {STEPS}

        def rank_main(r):
            torch.set_num_threads(1)
            store = dist.FileStore(os.path.join(TMP, "store"), RANKS)
            dist.init_process_group("gloo", store=store, rank=r, world_size=RANKS)
            sent = []
            real = dist.all_reduce

            def all_reduce(t, op=dist.ReduceOp.SUM, group=None):
                if t.dtype == torch.int32:
                    sent.append(t.clone())
                return real(t, op=op, group=group)

            dist.all_reduce = all_reduce
            grads = np.load(os.path.join(TMP, "grads.npz"))
            allreduce = coll.make_compressed_allreduce()
            out = {{}}
            for n in grads.files:
                g_all = grads[n]
                res = coll.init_residuals({{"g": torch.zeros((1, int(n)))}})
                outs, ress = [], []
                for t in range(STEPS):
                    mean, res = allreduce({{"g": torch.from_numpy(g_all[t, r:r + 1])}}, res)
                    outs.append(mean["g"][0].numpy())
                    ress.append(res["g"][0].numpy())
                out[n + "/out"] = np.stack(outs)
                out[n + "/res"] = np.stack(ress)
                out[n + "/payload"] = torch.stack(sent[-STEPS:]).numpy()
            np.savez(os.path.join(TMP, f"port{{r}}.npz"), **out)
            dist.destroy_process_group()

        ctx = mp.get_context("fork")
        procs = [ctx.Process(target=rank_main, args=(r,)) for r in range(RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(240)
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    """, env)
    _run(f"""
        import numpy as np
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.distributed import collectives as C

        TMP, RANKS, STEPS = {str(tmp)!r}, {RANKS}, {STEPS}
        sent = []
        psum = jax.lax.psum

        def recording_psum(x, axis_name):
            if x.dtype == jnp.int32:  # the int8 payload, summed as int32
                jax.debug.callback(lambda i, v: sent.append((int(i), np.asarray(v))),
                                   jax.lax.axis_index(axis_name), x)
            return psum(x, axis_name)

        jax.lax.psum = recording_psum
        mesh = jax.make_mesh((RANKS,), ("data",))
        put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("data", None)))
        ar = C.make_compressed_allreduce(mesh, "data")
        grads = np.load(TMP + "/grads.npz")
        out = {{}}
        for n in grads.files:
            g_all = grads[n]
            res = put(np.zeros(g_all.shape[1:], np.float32))
            outs, ress, pays = [], [], []
            for t in range(STEPS):
                sent.clear()
                gs, rs = ar({{"g": put(g_all[t])}}, {{"g": res}})
                res = rs["g"]
                jax.effects_barrier()
                outs.append(np.asarray(gs["g"]))
                ress.append(np.asarray(res))
                by_rank = dict(sent)
                assert sorted(by_rank) == list(range(RANKS)), sorted(by_rank)
                pays.append(np.stack([by_rank[r] for r in range(RANKS)]))
            out[n + "/out"] = np.stack(outs)
            out[n + "/res"] = np.stack(ress)
            out[n + "/payload"] = np.stack(pays)
        np.savez(TMP + "/ref.npz", **out)
    """, dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count={RANKS}"))
    port = [np.load(tmp / f"port{r}.npz") for r in range(RANKS)]
    ref = np.load(tmp / "ref.npz")
    out = {"port": {}, "ref": {}, "grads": grads}
    for n in WIDTHS:
        out["port"][n] = {k: np.stack([p[f"{n}/{k}"] for p in port], axis=1)
                          for k in ("out", "res", "payload")}
        out["ref"][n] = {k: ref[f"{n}/{k}"] for k in ("out", "res", "payload")}
    return out


@pytest.mark.parametrize("n", WIDTHS)
def test_int8_payload_is_the_reference_s(runs, n):
    port, ref = runs["port"][n]["payload"], runs["ref"][n]["payload"]
    assert port.shape == ref.shape == (STEPS, RANKS, -(-n // 256), 256)
    assert np.abs(port).max() <= 127
    differ = [(r, t, blk) for t, r, blk in zip(*np.nonzero((port != ref).any(-1)))]
    assert not differ, f"(rank, step, block)s whose payload differs: {differ}"


@pytest.mark.parametrize("n", WIDTHS)
def test_mean_and_residuals_match_the_reference(runs, n):
    port, ref, grads = runs["port"][n], runs["ref"][n], runs["grads"][n]
    for t in range(STEPS):
        # every rank holds the same mean, the reference's within 1e-6
        assert all(np.array_equal(port["out"][t, r], port["out"][t, 0]) for r in range(RANKS))
        assert _rel(port["out"][t], ref["out"][t]) < REL_TOL, t
        assert _rel(port["res"][t], ref["res"][t]) < REL_TOL, t
        # and, as the reference's own test demands, near the exact mean of
        # the step's gradients plus the residuals carried into it
        carried = grads[t] + (port["res"][t - 1] if t else 0.0)
        want = carried.astype(np.float64).mean(0)
        assert np.abs(port["out"][t, 0] - want).max() / np.abs(want).max() < REFERENCE_BOUND
        # error feedback: the residual is each rank's own quantisation error
        assert np.abs(port["res"][t]).max() <= np.abs(carried).max() / 127.0 * 0.5 * (1 + 1e-6)


@pytest.mark.parametrize("n", WIDTHS)
def test_one_process_simulation_is_the_gloo_run(runs, n):
    """`_one_process` over the 8 ranks' inputs gives every rank's mean and
    residual bitwise as the gloo run did."""
    grads, port = runs["grads"][n], runs["port"][n]
    res = [torch.zeros((1, n)) for _ in range(RANKS)]
    for t in range(STEPS):
        step = _one_process(
            [torch.from_numpy(grads[t, r:r + 1]) for r in range(RANKS)], res)
        res = [r for _, r in step]
        for r, (mean, new_res) in enumerate(step):
            assert np.array_equal(mean[0].numpy(), port["out"][t, r]), (t, r)
            assert np.array_equal(new_res[0].numpy(), port["res"][t, r]), (t, r)


@pytest.mark.parametrize("shape", [(3, 100), (256,), (7, 9, 11)])
def test_quantize_roundtrip_is_the_reference_s(shape):
    """`_quantize` / `_dequantize` / `_requant_roundtrip` on one tensor:
    the payload and scales bitwise, the round trip within 1e-6 (the
    multiply by the scale, summed in another order)."""
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32) * 3.0
    q, scale = coll._quantize(torch.from_numpy(x))
    rq, rscale = jax_coll._quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(scale.numpy(), np.asarray(rscale))
    back = coll._dequantize(q, scale, x.shape, x.size).numpy()
    assert np.array_equal(back, coll._requant_roundtrip(torch.from_numpy(x)).numpy())
    assert _rel(back, np.asarray(jax_coll._requant_roundtrip(jnp.asarray(x)))) < REL_TOL
    assert np.abs(back - x).max() <= np.abs(x).max() / 127.0 * 0.5 * (1 + 1e-6)


def test_trees_and_residuals_keep_their_structure():
    """`init_residuals` and `make_compressed_allreduce` keep a nested
    tree's structure, shapes and device; `compressed_psum` at world 1 is
    the round trip of grad + residual, in a one-rank gloo group."""
    code = textwrap.dedent("""
        import os, tempfile, torch, torch.distributed as dist
        from repro_torch.distributed import collectives as coll
        store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "s"), 1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
        g = {"a": torch.randn(3, 5, generator=torch.Generator().manual_seed(0)),
             "b": [torch.ones(300), {"c": torch.full((2,), -2.0)}]}
        res = coll.init_residuals(g)
        assert res["b"][1]["c"].dtype == torch.float32 and not res["a"].any()
        mean, new = coll.make_compressed_allreduce()(g, res)
        assert isinstance(mean["b"], list) and mean["b"][1]["c"].shape == (2,)
        assert torch.equal(mean["a"], coll._requant_roundtrip(g["a"]))
        assert torch.equal(new["a"], g["a"] - mean["a"])
        assert torch.equal(mean["b"][0], torch.ones(300))
        dist.destroy_process_group()
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
