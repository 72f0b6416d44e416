"""Path-based sharding rule engine.

One rule set covers all 10 heterogeneous architectures: each param / cache /
batch leaf gets a partition spec derived from its key path and shape, with a
divisibility fallback (a dim that does not divide its mesh axis is
replicated instead of erroring) -- the property that lets e.g. 8 KV heads
coexist with a 16-way model axis.

Parallelism mapping:
  model axis   TP: attention heads / MLP hidden / experts (EP) / vocab
  data axis    DP for batch; FSDP for params+optimizer
  pod axis     joins FSDP for params and optimizer state (hierarchical
               reduction); joins DP for batch

A spec is a plain tuple with one entry per tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names (one dim split over
several axes) -- the entries of the reference's `PartitionSpec`.  A
`Mesh` is axis name -> size over its `torch.device`s, or a logical mesh
(``logical=True``) that holds no device: the dry run's production meshes
exist only for per-card accounting and place no tensor.

The builders (`shard_params`, `shard_params_for_inference`,
`shard_cache`, `shard_batch`, `replicated`) turn a tree of shapes -- a
nested mapping of tensors (meta ones in the dry run) -- into one
`LeafShard` per leaf: its spec and its per-card shape, with the
reference's choices.  No collective is ported: the compressed all-reduce
and the placement of shards on several cards wait for a multi-card mesh
(ROADMAP §1).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# adaptive FSDP: parameter trees smaller than this are replicated over the
# data axes (TP only) -- the reference's default `fsdp_min_tree_bytes`
FSDP_MIN_TREE_BYTES = 3 << 30
# inference: TP only while the TP-sharded tree is at most this per card
INFERENCE_TP_BYTES = 6 << 30

# leaf-name -> index (from the leaf's trailing dims) of the tensor-parallel
# dim.  Negative indices count from the end, so stacked leading repeat dims
# need no special-casing.
_TP_DIM_RULES: Tuple[Tuple[str, int], ...] = (
    # embeddings / heads: vocab dim
    (r"\bembed$", -2),
    (r"\blm_head$", -1),
    # attention projections: head dim outward
    (r"\bwq$", -1), (r"\bwk$", -1), (r"\bwv$", -1), (r"\bwo$", -2),
    (r"\bbq$", -1), (r"\bbk$", -1), (r"\bbv$", -1),
    # MLA
    (r"\bwq_a$", -1), (r"\bwq_b$", -1),
    (r"\bwkv_a$", -1), (r"\bwk_b$", -1), (r"\bwv_b$", -1),
    # dense MLP
    (r"\bw1$", -1), (r"\bw3$", -1), (r"\bw2$", -2),
    (r"\bshared_w1$", -1), (r"\bshared_w3$", -1), (r"\bshared_w2$", -2),
    # mamba
    (r"\bin_proj$", -1), (r"\bout_proj$", -2), (r"\bconv_w$", -1),
    (r"\bconv_b$", -1),
    # MTP projection
    (r"\bproj$", -1),
)

# leaves that must stay replicated (small / f32-critical)
_REPLICATED = re.compile(
    r"(norm|ln1|ln2|ln_cross|router|dt_bias|A_log|\bD$|scale|lora_|count)"
)

# FSDP: shard the largest remaining dim over data (and pod, if present)
_FSDP_MIN_SIZE = 2**16  # don't bother sharding tiny tensors


class Mesh:
    """A logical device mesh: axis name -> size (in order) over
    `devices`, row-major.  `shape` reads like the reference mesh's.  A
    `logical` mesh holds no device: it exists for per-card accounting."""

    def __init__(self, shape: Mapping[str, int],
                 devices: Optional[Sequence] = None, *, logical: bool = False):
        self.shape = {str(k): int(v) for k, v in shape.items()}
        if any(v < 1 for v in self.shape.values()):
            raise ValueError(f"mesh axes must have size >= 1: {self.shape}")
        n = math.prod(self.shape.values())
        self.logical = logical
        if logical:  # accounting only: no device, none needed
            self.devices = ()
            return
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device available: pass devices= to build a "
                    "mesh off the card"
                )
            devices = [f"cuda:{i}" for i in range(n)]
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.devices) != n:
            raise ValueError(
                f"mesh {self.shape} needs {n} devices, got {len(self.devices)}"
            )

    @property
    def size(self) -> int:
        """The number of cards the mesh spans."""
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        if self.logical:
            return f"Mesh({self.shape}, logical)"
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name]


def _fsdp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _tp_spec(path: str, shape: Tuple[int, ...], model: int) -> list:
    """The tensor-parallel pass shared by `param_spec` and
    `_tp_only_spec`: the rule's dim (or, for MoE expert tables, the
    expert dim) over `model` when it divides."""
    spec = [None] * len(shape)
    if _REPLICATED.search(path):
        return spec
    for pat, dim in _TP_DIM_RULES:
        if re.search(pat, path):
            d = dim % len(shape) if dim < 0 else dim
            if len(shape) > d >= 0 and shape[d] % model == 0 and model > 1:
                spec[d] = "model"
            break
    # MoE expert tables: expert dim is the first non-stacked dim
    if re.search(r"moe/(w1|w3|w2)$", path) or (
        re.search(r"\b(w1|w3|w2)$", path) and len(shape) >= 3
    ):
        # (..., E, D, F): put model on E instead (EP)
        e_dim = len(shape) - 3
        if shape[e_dim] % model == 0 and model > 1:
            spec = [None] * len(shape)
            spec[e_dim] = "model"
    return spec


def param_spec(path: str, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """Partition spec for a parameter leaf."""
    model = _axis_size(mesh, "model") if "model" in mesh.shape else 1
    spec = _tp_spec(path, shape, model)
    # FSDP over (pod, data) on the largest remaining dim
    fsdp = _fsdp_axes(mesh)
    if fsdp and math.prod(shape) >= _FSDP_MIN_SIZE:
        fsdp_size = math.prod(_axis_size(mesh, a) for a in fsdp)
        dims = sorted(range(len(shape)), key=lambda i: -shape[i])
        for d in dims:
            if spec[d] is None and shape[d] % fsdp_size == 0:
                spec[d] = fsdp if len(fsdp) > 1 else fsdp[0]
                break
    return tuple(spec)


def cache_spec(path: str, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """Partition spec for a decode-cache leaf.

    Layouts (with a leading stacked repeat dim):
      kv      (rep, B, len, Hkv, hd)   B->data; Hkv->model else len->model
      pos     (rep, B, len)
      mla     (rep, B, len, rank)      B->data; len->model
      conv    (rep, B, K-1, d_xbc)     B->data; d_xbc->model
      ssm     (rep, B, H, P, N)        B->data; H->model
    """
    spec = [None] * len(shape)
    model = _axis_size(mesh, "model") if "model" in mesh.shape else 1
    data_axes = _fsdp_axes(mesh)
    data_size = (
        math.prod(_axis_size(mesh, a) for a in data_axes) if data_axes else 1
    )

    # batch dim: index 1 when stacked (rep leading), else 0
    b_dim = 1 if len(shape) >= 3 else 0
    if data_axes and shape[b_dim] % data_size == 0:
        spec[b_dim] = data_axes if len(data_axes) > 1 else data_axes[0]
    elif "data" in mesh.shape and shape[b_dim] % _axis_size(mesh, "data") == 0:
        spec[b_dim] = "data"

    if model > 1:
        if path.endswith("/k") or path.endswith("/v"):
            h_dim, len_dim = len(shape) - 2, len(shape) - 3
            if shape[h_dim] % model == 0:
                spec[h_dim] = "model"
            elif shape[len_dim] % model == 0:
                spec[len_dim] = "model"  # context parallelism
        elif path.endswith("/pos"):
            pass  # positions stay replicated along model
        elif path.endswith("/c_kv") or path.endswith("/k_rope"):
            len_dim = len(shape) - 2
            if shape[len_dim] % model == 0:
                spec[len_dim] = "model"
        elif path.endswith("/conv"):
            if shape[-1] % model == 0:
                spec[-1] = "model"
        elif path.endswith("/ssm"):
            h_dim = len(shape) - 3
            if shape[h_dim] % model == 0:
                spec[h_dim] = "model"
    return tuple(spec)


def batch_spec(path: str, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """Input batch: batch dim over (pod, data) when divisible."""
    if not shape:
        return ()
    spec = [None] * len(shape)
    axes = _fsdp_axes(mesh)
    size = math.prod(_axis_size(mesh, a) for a in axes) if axes else 1
    if axes and shape[0] % size == 0:
        spec[0] = axes if len(axes) > 1 else axes[0]
    elif "data" in mesh.shape and shape[0] % _axis_size(mesh, "data") == 0:
        spec[0] = "data"
    return tuple(spec)


def _tp_only_spec(path: str, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """param_spec without the FSDP pass (TP sharding only)."""
    model = _axis_size(mesh, "model") if "model" in mesh.shape else 1
    return tuple(_tp_spec(path, shape, model))


# ---------------------------------------------------------------------------
# builders: a tree of shapes -> a spec and a per-card shape per leaf
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """One leaf's placement: its spec, its global and per-card shapes, and
    its per-card bytes."""

    spec: Spec
    shape: Tuple[int, ...]
    card_shape: Tuple[int, ...]
    itemsize: int

    @property
    def card_bytes(self) -> int:
        return math.prod(self.card_shape) * self.itemsize


def _entry_size(entry, mesh: Mesh) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in names)


def card_shape(shape: Tuple[int, ...], spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """The per-card shape of a leaf: each sharded dim divided by its axes'
    size (the rules shard only dims that divide); dims past the spec's
    end are replicated."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // _entry_size(e, mesh) for d, e in zip(shape, spec))


def leaves(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested mapping / sequence of tensors -> {"a/b/0/c": leaf}: the
    reference's key paths (`_path_str`), list items by their index."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _tree_shardings(tree: Any, mesh: Mesh, spec_fn) -> Dict[str, LeafShard]:
    out = {}
    for path, x in leaves(tree).items():
        shape = tuple(x.shape)
        spec = spec_fn(path, shape, mesh)
        out[path] = LeafShard(spec, shape, card_shape(shape, spec, mesh), x.element_size())
    return out


def tree_bytes(tree: Any) -> int:
    """The whole tree's bytes (every leaf once)."""
    return sum(x.numel() * x.element_size() for x in leaves(tree).values())


def tree_bytes_per_card(shards: Mapping[str, LeafShard]) -> int:
    """The bytes one card holds of a built tree."""
    return sum(s.card_bytes for s in shards.values())


def shard_params(shapes: Any, mesh: Mesh) -> Dict[str, LeafShard]:
    """Adaptive FSDP: trees small enough to replicate per card skip the
    data-axis sharding entirely (TP only below `FSDP_MIN_TREE_BYTES`)."""
    if tree_bytes(shapes) < FSDP_MIN_TREE_BYTES:
        return _tree_shardings(shapes, mesh, _tp_only_spec)
    return _tree_shardings(shapes, mesh, param_spec)


def shard_params_for_inference(shapes: Any, mesh: Mesh) -> Dict[str, LeafShard]:
    """Inference: no optimizer state to amortise, so TP only whenever the
    TP-sharded tree is at most `INFERENCE_TP_BYTES` per card; 2-D (TP +
    FSDP) sharding for models that do not fit so (deepseek-v3)."""
    model = mesh.shape.get("model", 1)
    if tree_bytes(shapes) / max(model, 1) <= INFERENCE_TP_BYTES:
        return _tree_shardings(shapes, mesh, _tp_only_spec)
    return _tree_shardings(shapes, mesh, param_spec)


def shard_cache(shapes: Any, mesh: Mesh) -> Dict[str, LeafShard]:
    return _tree_shardings(shapes, mesh, cache_spec)


def shard_batch(shapes: Any, mesh: Mesh) -> Dict[str, LeafShard]:
    return _tree_shardings(shapes, mesh, batch_spec)


def replicated(tree: Any, mesh: Mesh) -> Dict[str, LeafShard]:
    """Every leaf whole on every card: the empty spec (the reference's
    ``PartitionSpec()``)."""
    return _tree_shardings(tree, mesh, lambda path, shape, mesh: ())
