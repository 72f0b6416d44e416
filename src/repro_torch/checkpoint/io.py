"""Checkpointing: atomic, async, keep-k, resumable -- the port of
`src/repro/checkpoint/io.py`, with the reference's layout:

    <dir>/step_<N>/host_<i>.npz     flattened leaves
    <dir>/step_<N>/meta.json        step, leaf names/shapes/dtypes
    <dir>/step_<N>.done             commit marker (atomic rename)

A state is a tree of mappings whose leaves are tensors or `nn.Module`s
(the train state's model).  A leaf's key is its flat name: the mapping
keys down to it and, inside a module, the parameter's name, joined by
dots (``params.layers.0.attn.wq``, ``opt.m.embed``, ``step``).  npz has
no bfloat16, so bf16 leaves are stored as f32 and cast back on restore.

`restore(..., device=)` stands in for the reference's ``shardings=``: it
puts every leaf on that device (by default each leaf's own in `like`).
Where the reference builds a new pytree, a module in `like` is restored
in place (moved to `device` first when one is named); every other leaf is
a new tensor.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike

Tree = Any


def _leaves(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(flat name, leaf) in the tree's order."""
    if isinstance(tree, torch.nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + name, p
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _host(leaf) -> np.ndarray:
    """A host copy of `leaf` that no later in-place update can reach."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:  # npz has no bf16: store f32
            t = t.float()
        return t.numpy()
    return np.array(leaf, copy=True)


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    return {k: _host(v) for k, v in _leaves(tree)}


def save(
    ckpt_dir: str | os.PathLike,
    step: int,
    tree: Tree,
    *,
    host_id: int = 0,
    keep: int = 3,
) -> pathlib.Path:
    """Synchronous atomic save."""
    root = pathlib.Path(ckpt_dir)
    tmp = root / f"step_{step}.tmp"
    final = root / f"step_{step}"
    tmp.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    np.savez(tmp / f"host_{host_id}.npz", **flat)
    meta = {
        "step": int(step),
        "leaves": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in flat.items()
        },
    }
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    (root / f"step_{step}.done").touch()
    _gc(root, keep)
    return final


class AsyncCheckpointer:
    """Overlap checkpoint I/O with training: save() returns once the state
    is copied to host memory; the previous save is joined before a new one
    starts (one in flight).  The copy is taken on the caller's thread: the
    port's optimizer updates tensors in place, so a tensor that the writer
    thread read later would hold a later step."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3, host_id: int = 0):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.host_id = host_id
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Tree) -> None:
        self.wait()
        host_tree = _flatten(tree)  # copies, on the caller's thread

        def run():
            try:
                save(
                    self.ckpt_dir, step, host_tree,
                    host_id=self.host_id, keep=self.keep,
                )
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def latest_step(ckpt_dir: str | os.PathLike) -> Optional[int]:
    root = pathlib.Path(ckpt_dir)
    if not root.exists():
        return None
    steps = [
        int(p.stem.split("_")[1])
        for p in root.glob("step_*.done")
    ]
    return max(steps) if steps else None


def _restore(node: Tree, data, prefix: str, device: Optional[torch.device]) -> Tree:
    def array(key: str) -> np.ndarray:
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        return data[key]

    if isinstance(node, torch.nn.Module):
        if device is not None:
            node.to(device)
        with torch.no_grad():
            for name, p in node.named_parameters():
                p.copy_(torch.from_numpy(array(prefix + name)))
        return node
    if isinstance(node, Mapping):
        return {k: _restore(v, data, f"{prefix}{k}.", device) for k, v in node.items()}
    key = prefix[:-1]
    if isinstance(node, torch.Tensor):
        dev = device if device is not None else node.device
        return torch.from_numpy(array(key)).to(device=dev, dtype=node.dtype)
    return array(key)


def restore(
    ckpt_dir: str | os.PathLike,
    step: Optional[int],
    like: Tree,
    *,
    device: DeviceLike = None,
    host_id: int = 0,
) -> Tuple[Tree, int]:
    """Restore into the structure of `like`, each leaf on `device` (by
    default its own).  Returns (tree, step)."""
    root = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    with np.load(root / f"step_{step}" / f"host_{host_id}.npz") as data:
        tree = _restore(like, data, "", None if device is None else torch.device(device))
    return tree, step


def _gc(root: pathlib.Path, keep: int) -> None:
    steps = sorted(
        int(p.stem.split("_")[1]) for p in root.glob("step_*.done")
    )
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(root / f"step_{s}", ignore_errors=True)
        (root / f"step_{s}.done").unlink(missing_ok=True)
