"""Mixture-of-Experts layer: top-k routing, capacity, shared experts --
the port of `src/repro/models/moe.py`.

Dispatch is sort-based, in the reference's fixed shapes: every (token,
choice) pair is argsorted by expert with a *stable* sort, its position
within its expert comes from the expert's segment start
(`searchsorted`), and pairs past the expert's capacity are dropped --
written to an overflow row that nothing reads.  The stable sort keeps
flat token order within an expert, so which pairs drop is the
reference's, pair for pair: a padded wave's identical pad tokens all
pick the same experts and fill them in row order.  The experts are
batched products over (E, cap, .) slots, empty ones included
(`torch.bmm`; the reference leaves its einsums to XLA, and no Pallas
kernel touches MoE).

Two properties the reference gets from XLA and the port keeps by
construction:

- no host sync on the card: no boolean-mask indexing, `.item()` or
  `nonzero()`; dropped pairs go to the overflow row instead, so a decode
  step (B tokens, capacity 8) adds no sync per layer;
- a deterministic forward: the combine gathers each pair's expert row
  back into (N, k, D) and sums over k, where the reference scatter-adds
  (`out.at[tok_of].add`).  An atomic scatter could round differently
  from run to run, and under per-super-block remat the recomputed
  forward must route exactly as the forward did.

`record_routing()` collects each call's `Routing` (for inspection: which
experts, which pairs were kept).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.common import dense_init


def init_moe(gen, cfg: ArchConfig, dtype, device) -> Dict[str, torch.Tensor]:
    """The reference's distributions: an f32 router, and `w1` / `w3` drawn
    with `dense_init`'s default fan-in, the leading axis (n_experts), as
    the reference draws them (ROADMAP §3)."""
    m: MoEConfig = cfg.moe
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init(gen, (d, m.n_experts), torch.float32, device),
        "w1": dense_init(gen, (m.n_experts, d, f), dtype, device),
        "w3": dense_init(gen, (m.n_experts, d, f), dtype, device),
        "w2": dense_init(gen, (m.n_experts, f, d), dtype, device, fan_in=f),
    }
    if m.n_shared:
        fs = f * m.n_shared
        p["shared_w1"] = dense_init(gen, (d, fs), dtype, device)
        p["shared_w3"] = dense_init(gen, (d, fs), dtype, device)
        p["shared_w2"] = dense_init(gen, (fs, d), dtype, device, fan_in=fs)
    return p


def capacity(n_tokens: int, m: MoEConfig) -> int:
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """One call's routing of N tokens to k of E experts."""

    logits: torch.Tensor  # (N, E) f32
    probs: torch.Tensor  # (N, E) softmax of the logits
    ids: torch.Tensor  # (N, k) experts, highest probability first
    gates: torch.Tensor  # (N, k) their probabilities, renormalised
    slot: torch.Tensor  # (N, k) row of the (E * cap) expert buffer; E * cap = dropped
    cap: int

    @property
    def keep(self) -> torch.Tensor:
        """(N, k) bool: the pair holds a slot (not dropped by capacity)."""
        return self.slot < self.logits.shape[-1] * self.cap


def route(p, xt: torch.Tensor, m: MoEConfig) -> Routing:
    """xt (N, D) -> its `Routing`: f32 logits, top-k with gates
    renormalised (floor 1e-9), and each pair's slot by the stable sort."""
    n = xt.shape[0]
    e, k = m.n_experts, m.top_k
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    cap = capacity(n, m)
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)  # flat token order within an expert
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=xt.device, dtype=flat_e.dtype))
    pos_in_e = torch.arange(n * k, device=xt.device) - starts[sorted_e]
    slot_sorted = torch.where(pos_in_e < cap, sorted_e * cap + pos_in_e, e * cap)
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)  # pair order
    return Routing(logits, probs, ids, gates, slot.view(n, k), cap)


_RECORDS: Optional[List[Routing]] = None


@contextlib.contextmanager
def record_routing() -> Iterator[List[Routing]]:
    """Collect the `Routing` of every `moe_forward` call made inside the
    block (detached), in call order: one per MoE layer per forward or
    decode step.  One thread at a time."""
    global _RECORDS
    prev, _RECORDS = _RECORDS, []
    try:
        yield _RECORDS
    finally:
        _RECORDS = prev


def moe_forward(
    p, x: torch.Tensor, cfg: ArchConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (out, aux losses {moe_aux, moe_z})."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    n, e, k = b * s, m.n_experts, m.top_k
    xt = x.reshape(n, d)
    r = route(p, xt, m)
    if _RECORDS is not None:
        _RECORDS.append(Routing(*(t.detach() for t in r[:5]), r.cap))

    # ---- aux losses (Switch-style load balance on the top-1 choice, z-loss)
    top1 = r.ids[:, :1] == torch.arange(e, device=x.device)  # the top-1 one-hot
    frac_tokens = top1.float().mean(dim=0)
    frac_probs = r.probs.mean(dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs) * m.aux_loss_coef
    zloss = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2) * m.z_loss_coef

    # ---- dispatch: each kept pair to its slot, dropped ones (zeroed) to
    # the overflow row E * cap
    rows = e * r.cap
    slot = r.slot.reshape(-1)
    keep = (slot < rows).to(x.dtype)
    pairs = xt[:, None, :].expand(n, k, d).reshape(n * k, d)
    buf = x.new_zeros((rows + 1, d)).index_copy(0, slot, pairs * keep[:, None])
    h_in = buf[:rows].view(e, r.cap, d)

    # ---- expert FFN, batched over experts
    h = F.silu(torch.bmm(h_in, p["w1"])) * torch.bmm(h_in, p["w3"])
    h_out = torch.bmm(h, p["w2"]).reshape(rows, d)

    # ---- combine: gather each pair's row back, weight, sum over k
    gathered = h_out[torch.clamp(slot, max=rows - 1)]
    out = (gathered * (keep * r.gates.reshape(-1).to(x.dtype))[:, None]).view(n, k, d).sum(dim=1)

    # ---- shared experts (always on)
    if "shared_w1" in p:
        sh = F.silu(xt @ p["shared_w1"]) * (xt @ p["shared_w3"])
        out = out + sh @ p["shared_w2"]

    return out.reshape(b, s, d), {"moe_aux": aux, "moe_z": zloss}
