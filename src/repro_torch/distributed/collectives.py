"""Compressed gradient collectives with error feedback, over
`torch.distributed`.

int8 block-quantised mean all-reduce: each worker adds its residual to
its local gradient, the workers agree on one f32 scale per block of 256
elements (an all-reduce MAX of each block's |max|, little traffic), each
quantises to int8 against the shared scale, the int8 payload is summed
as int32 (exactly), divided by the group's size and dequantised; each
worker keeps its own quantisation error as the residual it adds to the
next step's gradient (error feedback).  The payload is ~4x smaller than
f32's.

It runs on whatever tensors and process group the caller gives it: NCCL
on `cuda` tensors, gloo on the CPU (or on `cuda` tensors, which gloo
stages through the host itself).  Nothing here moves a tensor to
another device.  `_quantize` / `_dequantize` / `_requant_roundtrip` are
the reference's one-worker quantisation, against the block's own |max|.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

Pytree = Any

_BLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """x flattened, zero-padded to whole blocks: (n_blocks, _BLOCK)."""
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % _BLOCK)).reshape(-1, _BLOCK)


def _payload(blocks: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, f32 scale per block) of `blocks` against the blocks'
    |max| `amax` (the group's, for the all-reduce)."""
    scale = torch.clamp(amax / 127.0, min=1e-20)
    return torch.round(blocks / scale[:, None]).to(torch.int8), scale


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, f32 scale per block) of `x` against each block's own
    |max|; an all-zero block's scale is 0."""
    blocks = _blocks(x)
    amax = blocks.abs().amax(dim=1)
    return _payload(blocks, amax)[0], amax / 127.0


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape, size: int) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:size].reshape(shape)


def _requant_roundtrip(g: torch.Tensor) -> torch.Tensor:
    q, scale = _quantize(g)
    return _dequantize(q, scale, g.shape, g.numel())


def _finish(g, q, qsum, scale, n: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean gradient, this worker's new residual) from its own payload
    `q` and the group's int32 sum `qsum`."""
    red = (qsum.float() / n) * scale[:, None]
    g_red = red.reshape(-1)[: g.numel()].reshape(g.shape)
    new_residual = g - _dequantize(q, scale, g.shape, g.numel())
    return g_red, new_residual


def compressed_psum(grad: torch.Tensor, residual: torch.Tensor,
                    group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tensor's int8 mean all-reduce with error feedback over `group`
    (the default group when None): one all-reduce MAX of the per-block
    f32 |max|, one all-reduce SUM of the int8 payload as int32.  Returns
    (mean gradient, new residual), both f32 on the gradient's device."""
    g = grad.float() + residual
    blocks = _blocks(g)
    amax = blocks.abs().amax(dim=1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    q, scale = _payload(blocks, amax)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    return _finish(g, q, qsum, scale, float(dist.get_world_size(group)))


def _flatten(tree: Pytree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, Mapping):
        return [kv for k, v in tree.items() for kv in _flatten(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _unflatten(like: Pytree, leaves: dict, prefix: str = "") -> Pytree:
    if isinstance(like, Mapping):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, f"{prefix}/{i}") for i, v in enumerate(like))
    return leaves[prefix]


def make_compressed_allreduce(group=None):
    """Tree-level compressed mean all-reduce over `group`: each worker
    passes its local gradient tree (nested mappings / sequences of
    tensors) and its residual tree of the same structure; every worker
    gets the compressed mean and its own new residuals, leaf by leaf."""

    def allreduce(grads: Pytree, residuals: Pytree) -> Tuple[Pytree, Pytree]:
        res = dict(_flatten(residuals))
        out_g, out_r = {}, {}
        for path, g in _flatten(grads):
            out_g[path], out_r[path] = compressed_psum(g, res[path], group)
        return _unflatten(grads, out_g), _unflatten(grads, out_r)

    return allreduce


def init_residuals(params: Pytree) -> Pytree:
    """Zero f32 residuals shaped as `params`, each on its leaf's device."""
    return _unflatten(params, {path: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                               for path, p in _flatten(params)})
