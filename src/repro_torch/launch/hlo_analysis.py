"""The dry run's accounting: an op counter over a step run on the meta
device, the roofline terms it feeds, and the model-FLOP counts.

The reference reads its costs from XLA's compiled HLO (`hlo_cost`,
`hlo_top_offenders`).  The port runs eagerly, so its counterpart is
`OpCounter`, a `TorchDispatchMode` over a step whose tensors live on the
meta device (nothing is allocated, nothing runs):

* FLOPs count matrix products and convolutions only, as the reference's
  `op_flops` does (`mm`, `addmm`, `bmm`, `baddbmm`, `convolution` and
  its backward).
* Bytes count each aten op's tensor inputs plus its outputs (an output
  that is one of its inputs, written in place, counts once).  Views,
  `empty` and other ops that move no memory cost nothing.
* Every call is counted: the Python loop over layers takes the place of
  the reference's trip counts.  A composite op (`matmul`, `einsum`) is
  counted as the ops it decomposes into, as eager execution runs it.
* A hand-written kernel is one op with its own FLOPs and bytes (its
  package's `cost`): on the meta device its wrapper reports the call
  (`kernels.meta`) and returns empty outputs, so the plain version's
  intermediates -- attention's S x S scores -- never count.

Eager aten bytes exceed XLA's fused count: each elementwise op reads and
writes its tensors, where XLA fuses them.  That is the eager program's
real traffic; the dry run holds FLOPs, not bytes, against the reference.

The peaks are an H100 SXM's, from its data sheet, for the cell's dtype
(`PEAK_FLOPS`, `HBM_BW`), never a TPU's.  No collective is ported, so
`t_collective` is None.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import meta as kernel_meta

# H100 SXM, dense, from the data sheet (the constants of PERF.md's kernel table)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12  # bytes/s, HBM3
CARD_BYTES = 80 * 2**30  # an H100 SXM's memory, where no card is present

aten = torch.ops.aten

# ops that move no memory (views are found by their schema)
_FREE = {
    aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
    aten.detach.default, aten.alias.default, aten.lift_fresh.default,
    aten._unsafe_view.default, aten.new_empty.default, aten.new_empty_strided.default,
}


def _numel(shape) -> int:
    return math.prod(int(d) for d in shape)


def _mm_flops(a, b) -> int:
    return 2 * _numel(a.shape) * b.shape[-1]


def _conv_flops(x, w, out, transposed: bool) -> int:
    """2 x output elements x (input channels a group x kernel taps)."""
    per = _numel(w.shape[1:])  # (C_out, C_in / groups, *k)
    if transposed:
        return 2 * _numel(x.shape) * per
    return 2 * _numel(out.shape) * per


def op_flops(func, args, out) -> int:
    """FLOPs of one aten call: matrix products and convolutions only."""
    if func is aten.mm.default:
        return _mm_flops(args[0], args[1])
    if func is aten.addmm.default:
        return _mm_flops(args[1], args[2])
    if func is aten.bmm.default:
        return _mm_flops(args[0], args[1])
    if func is aten.baddbmm.default:
        return _mm_flops(args[1], args[2])
    if func is aten.convolution.default:
        return _conv_flops(args[0], args[1], out, bool(args[6]))
    if func is aten.convolution_backward.default:
        grad_out, x, w = args[0], args[1], args[2]
        one = _conv_flops(x, w, grad_out, bool(args[7]))
        mask = args[-1]
        return one * (int(mask[0]) + int(mask[1]))
    return 0


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _signature(func, args) -> str:
    shapes = ", ".join(
        f"{'x'.join(map(str, t.shape)) or 'scalar'} {str(t.dtype).removeprefix('torch.')}"
        for t in _tensors(args))
    return f"{func}({shapes})"


@dataclasses.dataclass
class OpStat:
    calls: int = 0
    flops: int = 0
    bytes: int = 0


class OpCounter(TorchDispatchMode):
    """Counts every aten op and every hand-written kernel that a step on
    the meta device calls (module docstring).  `ops` maps an op's
    signature (its name and its inputs' shapes and dtypes) to its
    `OpStat`; `kernels` maps a kernel's name to its own."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, OpStat] = defaultdict(OpStat)
        self.kernels: Dict[str, OpStat] = defaultdict(OpStat)
        self._listen = None
        self._depth = 0  # `__torch_dispatch__` re-enters the mode to decompose

    def __enter__(self):
        if self._depth == 0:
            self._listen = kernel_meta.listen(self._kernel)
            self._listen.__enter__()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._listen.__exit__(*exc)

    def _kernel(self, name: str, flops: int, n_bytes: int) -> None:
        st = self.kernels[name]
        st.calls += 1
        st.flops += flops
        st.bytes += n_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # a composite op (`matmul`, `einsum`, `linear`, ...: what reaches
        # the mode under `inference_mode`) is counted as the ops it runs
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        if func in _FREE or func.is_view:
            return out
        ins = _tensors((args, kwargs))
        seen = {id(t) for t in ins}
        outs = [t for t in _tensors(out) if id(t) not in seen]
        st = self.ops[_signature(func, args)]
        st.calls += 1
        st.flops += op_flops(func, args, out)
        st.bytes += _bytes(ins) + _bytes(outs)
        return out

    @property
    def flops(self) -> int:
        return (sum(s.flops for s in self.ops.values())
                + sum(s.flops for s in self.kernels.values()))

    @property
    def bytes(self) -> int:
        return (sum(s.bytes for s in self.ops.values())
                + sum(s.bytes for s in self.kernels.values()))

    def kernel_calls(self) -> Dict[str, int]:
        return {k: s.calls for k, s in sorted(self.kernels.items())}

    def top(self, k: int = 15) -> Dict[str, List[Tuple[str, OpStat]]]:
        """The `k` costliest ops (kernels among them, as "kernel:<name>")
        by FLOPs and by bytes: the dry run's profile."""
        rows = list(self.ops.items()) + [(f"kernel:{n}", s) for n, s in self.kernels.items()]
        by_flops = sorted((r for r in rows if r[1].flops), key=lambda r: -r[1].flops)
        by_bytes = sorted(rows, key=lambda r: -r[1].bytes)
        return {"flops": by_flops[:k], "bytes": by_bytes[:k]}

    def as_list(self) -> List[dict]:
        """Every op and kernel with its counts (``--save-ops``)."""
        rows = [dict(op=sig, kind="aten", **dataclasses.asdict(s))
                for sig, s in self.ops.items()]
        rows += [dict(op=n, kind="kernel", **dataclasses.asdict(s))
                 for n, s in self.kernels.items()]
        return sorted(rows, key=lambda r: (-r["flops"], -r["bytes"]))


@dataclasses.dataclass
class Roofline:
    chips: int
    hlo_flops: float  # GLOBAL (all chips): the op counter's FLOPs
    hlo_bytes: float  # GLOBAL: the op counter's bytes
    model_flops: float = 0.0
    dtype: str = "bfloat16"

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.dtype]

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> Optional[float]:
        return None  # until collectives exist (ROADMAP §1)

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: remat / redundancy waste detector."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU upper bound: useful compute time / bound time."""
        if self.t_bound <= 0:
            return 0.0
        return (self.model_flops / (self.chips * self.peak_flops)) / self.t_bound

    def as_dict(self) -> Dict[str, float]:
        return {
            "chips": self.chips,
            "dtype": self.dtype,
            "peak_flops": self.peak_flops,
            "hbm_bw": HBM_BW,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_bound_s": self.t_bound,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_train(cfg, shape) -> float:
    """6 N D (dense) / 6 N_active D (MoE) with N = active params, D = tokens."""
    n = active_param_count(cfg)
    tokens = shape.global_batch * shape.seq_len
    return 6.0 * n * tokens


def model_flops_infer(cfg, shape, *, decode: bool) -> float:
    n = active_param_count(cfg)
    tokens = shape.global_batch * (1 if decode else shape.seq_len)
    return 2.0 * n * tokens


def active_param_count(cfg) -> float:
    """Active (per-token) parameter count, estimated from the config."""
    d = cfg.d_model
    n = 0.0
    # embeddings (active at head, counted once)
    n += cfg.vocab_size * d
    per_layer = 0.0
    if cfg.family == "ssm" or cfg.ssm is not None:
        s = cfg.ssm
        d_inner = s.expand * d
        h = d_inner // s.head_dim
        d_xbc = d_inner + 2 * s.n_groups * s.d_state
        mamba = d * (d_inner + d_xbc + h) + d_inner * d
        if cfg.family == "ssm":
            per_layer = mamba
        else:  # hybrid: mamba blocks + amortised shared attn
            hd = cfg.resolved_head_dim
            attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
            mlp = 3 * d * cfg.d_ff
            per_layer = mamba + (attn + mlp) / max(cfg.shared_attn_period or 6, 1)
    else:
        if cfg.mla:
            m = cfg.mla
            qd = m.qk_nope_dim + m.qk_rope_dim
            attn = (
                d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qd
                + d * (m.kv_lora_rank + m.qk_rope_dim)
                + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
                + cfg.n_heads * m.v_head_dim * d
            )
        else:
            hd = cfg.resolved_head_dim
            attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
        if cfg.moe:
            active_e = cfg.moe.top_k + cfg.moe.n_shared
            mlp = 3 * d * cfg.d_ff * active_e
        else:
            mlp = 3 * d * cfg.d_ff
        per_layer = attn + mlp
    n += per_layer * cfg.n_layers
    if cfg.is_encoder_decoder:
        hd = cfg.resolved_head_dim
        enc = cfg.encoder_layers * (
            d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
            + cfg.n_heads * hd * d + 3 * d * cfg.d_ff
        )
        n += enc
    return n
