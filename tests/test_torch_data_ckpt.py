"""The port's data stream and checkpoints against the reference.

`TokenStream` batches must be bitwise the reference's numpy arrays
(over seeds, steps and host shardings, synthetic and file-backed); the
`Prefetcher` hands them out in order.  Checkpoints keep the reference's
layout (``step_N/host_0.npz``, ``meta.json``, ``step_N.done``), atomic
rename and keep-k, with the train state's flat names as leaf keys.
"""

import json

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenStream as JaxTokenStream
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, Prefetcher, TokenStream
from repro_torch.optim import AdamWConfig
from repro_torch.train.step import TrainConfig, init_train_state


@pytest.mark.parametrize("seed", [0, 3, 1234])
@pytest.mark.parametrize("step", [0, 1, 17, 999])
@pytest.mark.parametrize("host_id,num_hosts", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_stream_batches_bitwise_the_reference(seed, step, host_id, num_hosts):
    args = dict(vocab_size=1000, seq_len=32, global_batch=8, seed=seed,
                host_id=host_id, num_hosts=num_hosts)
    ours = TokenStream(DataConfig(**args)).batch_at(step)
    ref = JaxTokenStream(JaxDataConfig(**args)).batch_at(step)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape
        np.testing.assert_array_equal(ours[k], ref[k])


def test_file_backed_stream_bitwise_the_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 5000, 4096).astype(np.int32).tofile(path)
    args = dict(vocab_size=3000, seq_len=24, global_batch=4, seed=2, path=str(path))
    for step in (0, 5):
        ours = TokenStream(DataConfig(**args)).batch_at(step)
        ref = JaxTokenStream(JaxDataConfig(**args)).batch_at(step)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])


def test_prefetcher_orders_batches():
    s = TokenStream(DataConfig(1000, 16, 4))
    pf = Prefetcher(s, start_step=5)
    try:
        for want in (5, 6, 7, 8):
            step, batch = pf.next()
            assert step == want
            np.testing.assert_array_equal(batch["tokens"], s.batch_at(want)["tokens"])
    finally:
        pf.close()


def _state(moment_dtype="float32", seed=0):
    cfg = get_arch("gemma3-1b").reduced()
    tcfg = TrainConfig(optimizer=AdamWConfig(moment_dtype=moment_dtype))
    return init_train_state(cfg, tcfg, seed=seed, device="cpu")


def _flat(tree):
    return {k: v.detach().clone() for k, v in ckpt_io._leaves(tree)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_roundtrip_layout_and_names(tmp_path, moment_dtype):
    state = _state(moment_dtype)
    state["step"] += 7
    want = _flat(state)
    ckpt_io.save(tmp_path, 7, state)
    assert (tmp_path / "step_7" / "host_0.npz").exists()
    assert (tmp_path / "step_7.done").exists()
    meta = json.loads((tmp_path / "step_7" / "meta.json").read_text())
    assert meta["step"] == 7
    assert "params.layers.0.attn.wq" in meta["leaves"] and "step" in meta["leaves"]
    assert "opt.count" in meta["leaves"]
    if moment_dtype == "int8":
        assert "opt.m.embed.q" in meta["leaves"] and "opt.v.embed.scale" in meta["leaves"]
    else:
        assert "opt.m.embed" in meta["leaves"]
    assert set(meta["leaves"]) == set(want)

    like = _state(moment_dtype, seed=1)  # other weights: all must be overwritten
    got, step = ckpt_io.restore(tmp_path, None, like)
    assert step == 7
    assert got["params"] is like["params"]  # the module is restored in place
    flat = _flat(got)
    assert set(flat) == set(want)
    for k, v in want.items():
        assert flat[k].dtype == v.dtype, k
        assert torch.equal(flat[k], v), k


def test_zamba2_train_state_roundtrip_keeps_the_shared_leaves(tmp_path):
    """A zamba2 train state (its model-level shared attention + MLP and
    each invocation's LoRA) saves under dotted names -- the shared
    leaves and their moments included -- and restores bitwise into a state
    drawn from another seed."""
    cfg = get_arch("zamba2-7b").reduced()
    tcfg = TrainConfig(optimizer=AdamWConfig())
    state = init_train_state(cfg, tcfg, seed=0, device="cpu")
    want = _flat(state)
    ckpt_io.save(tmp_path, 3, state)
    leaves = json.loads((tmp_path / "step_3" / "meta.json").read_text())["leaves"]
    for name in ("params.shared.attn.wq", "params.shared.mlp.w2", "opt.m.shared.attn.wo",
                 "opt.v.shared.mlp.w1", "params.layers.0.lora_q_a", "params.layers.0.lora_v_b",
                 "params.layers.1.mamba.conv_w"):
        assert name in leaves, name
    assert set(leaves) == set(want)
    like = init_train_state(cfg, tcfg, seed=1, device="cpu")
    assert not torch.equal(like["params"].shared_block["attn"]["wq"], state["params"].shared_block["attn"]["wq"])
    got, step = ckpt_io.restore(tmp_path, None, like)
    assert step == 3
    flat = _flat(got)
    assert set(flat) == set(want)
    assert all(torch.equal(flat[k], v) for k, v in want.items())


def test_keep_k_gc(tmp_path):
    state = {"params": {"w": torch.zeros(3)}, "step": torch.tensor(0, dtype=torch.int32)}
    for s in range(6):
        ckpt_io.save(tmp_path, s, state, keep=2)
    assert ckpt_io.latest_step(tmp_path) == 5
    assert sorted(p.name for p in tmp_path.glob("step_*.done")) == ["step_4.done", "step_5.done"]
    assert not (tmp_path / "step_3").exists()


def test_async_save_unaffected_by_a_later_in_place_update(tmp_path):
    w = torch.arange(6, dtype=torch.float32)
    state = {"params": {"w": w}, "b": torch.ones(2, dtype=torch.bfloat16)}
    ck = ckpt_io.AsyncCheckpointer(str(tmp_path), keep=3)
    ck.save(1, state)
    w.mul_(-1.0)  # the optimizer updates in place right after the save
    state["b"].add_(5)
    ck.wait()
    got, _ = ckpt_io.restore(tmp_path, 1, state)
    assert torch.equal(got["params"]["w"], torch.arange(6, dtype=torch.float32))
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"], torch.ones(2, dtype=torch.bfloat16))


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt_io.restore(tmp_path, None, {"w": torch.zeros(2)})
    ckpt_io.save(tmp_path, 0, {"w": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf x"):
        ckpt_io.restore(tmp_path, 0, {"w": torch.zeros(2), "x": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        ckpt_io.restore(tmp_path, 3, {"w": torch.zeros(2)})


def test_restore_onto_a_named_device(tmp_path):
    state = _state()
    ckpt_io.save(tmp_path, 2, state)
    like = _state(seed=4)
    got, _ = ckpt_io.restore(tmp_path, 2, like, device="cpu")
    for k, v in ckpt_io._leaves(got):
        assert v.device.type == "cpu", k
    assert torch.equal(got["params"].embed, state["params"].embed)
    assert torch.equal(got["opt"]["v"]["final_norm"], state["opt"]["v"]["final_norm"])
