"""ConvNet layer-graph description for the serving engine.

A net is a sequential tuple of `LayerSpec`s -- convolutions interleaved
with the pointwise/pooling glue of the VGG/ResNet-stem family.  The spec
is pure geometry: weights live beside it (`init_weights`) so the same
spec can be planned once and served with any parameter set.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.conv import conv2d_direct
from repro_torch.core.registry import ConvSpec


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer.  kind: "conv" | "bias" | "relu" | "maxpool"."""

    kind: str
    c_in: int = 0
    c_out: int = 0
    k: int = 3
    pad: int = 1
    stride: int = 1  # conv only
    groups: int = 1  # conv only (grouped / ResNeXt-style)
    window: int = 2  # maxpool only

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "LayerSpec":
        return LayerSpec(**d)


def conv(
    c_in: int, c_out: int, k: int = 3, pad: int = -1,
    stride: int = 1, groups: int = 1,
) -> LayerSpec:
    """3x3-style conv layer; pad defaults to "same" (k // 2)."""
    return LayerSpec(
        kind="conv", c_in=c_in, c_out=c_out, k=k,
        pad=(k // 2 if pad < 0 else pad), stride=stride, groups=groups,
    )


def bias(c: int) -> LayerSpec:
    """Per-channel bias add; owns a (C,) weight vector like convs own
    kernels (the classic conv+bias+relu epilogue of inference graphs)."""
    return LayerSpec(kind="bias", c_in=c, c_out=c)


def relu() -> LayerSpec:
    return LayerSpec(kind="relu")


def maxpool(window: int = 2) -> LayerSpec:
    return LayerSpec(kind="maxpool", window=window)


@dataclasses.dataclass(frozen=True)
class NetSpec:
    """A sequential ConvNet: name + layer tuple."""

    name: str
    layers: Tuple[LayerSpec, ...]

    def conv_layers(self) -> List[Tuple[int, LayerSpec]]:
        return [(i, l) for i, l in enumerate(self.layers) if l.kind == "conv"]

    def param_layers(self) -> List[Tuple[int, LayerSpec]]:
        """Layers that own weights: convs (HWIO kernels) + biases ((C,))."""
        return [
            (i, l)
            for i, l in enumerate(self.layers)
            if l.kind in ("conv", "bias")
        ]

    @property
    def pool_factor(self) -> int:
        """Product of pooling windows: input dims must divide this for the
        reshape-based pooling in the executor."""
        f = 1
        for l in self.layers:
            if l.kind == "maxpool":
                f *= l.window
        return f

    @property
    def downsample_factor(self) -> int:
        """The net's total spatial downsampling: pooling windows AND conv
        strides.  Serving buckets must survive this whole chain -- a
        stride-2 net halves extents before its pools ever see them, so
        validating against `pool_factor` alone admits buckets that break
        at runtime."""
        f = 1
        for l in self.layers:
            if l.kind == "maxpool":
                f *= l.window
            elif l.kind == "conv":
                f *= l.stride
        return f

    def infer_shapes(self, h: int, w: int, c: int) -> List[Tuple[int, int, int]]:
        """(H, W, C) after each layer; validates channel wiring."""
        shapes = []
        for i, l in enumerate(self.layers):
            if l.kind == "conv":
                if l.c_in != c:
                    raise ValueError(
                        f"layer {i}: conv expects C={l.c_in}, got {c}"
                    )
                try:
                    # ConvSpec owns conv geometry: output dims, groups
                    # divisibility, kernel-vs-padded-input validation
                    h, w = ConvSpec(
                        h=h, w=w, c_in=l.c_in, c_out=l.c_out, k=l.k,
                        pad=l.pad, stride=l.stride, groups=l.groups,
                    ).out_hw
                except ValueError as e:
                    raise ValueError(f"layer {i}: {e}") from None
                c = l.c_out
            elif l.kind == "maxpool":
                if h % l.window or w % l.window:
                    raise ValueError(
                        f"layer {i}: pool window {l.window} does not divide "
                        f"({h}, {w})"
                    )
                h, w = h // l.window, w // l.window
            elif l.kind == "bias":
                if l.c_in != c:
                    raise ValueError(
                        f"layer {i}: bias expects C={l.c_in}, got {c}"
                    )
            elif l.kind != "relu":
                raise ValueError(f"layer {i}: unknown kind {l.kind!r}")
            shapes.append((h, w, c))
        return shapes

    def out_shape(self, h: int, w: int, c: int) -> Tuple[int, int, int]:
        return self.infer_shapes(h, w, c)[-1]

    def to_dict(self) -> dict:
        return {"name": self.name, "layers": [l.to_dict() for l in self.layers]}

    @staticmethod
    def from_dict(d: dict) -> "NetSpec":
        return NetSpec(
            name=d["name"],
            layers=tuple(LayerSpec.from_dict(l) for l in d["layers"]),
        )


def init_weights(
    spec: NetSpec, seed: int = 0, dtype=torch.float32, scale: float = 0.05
) -> Dict[int, torch.Tensor]:
    """Weights for every parameter layer, keyed by layer index: HWIO
    kernels for convs, (C,) vectors for biases.  CPU tensors drawn from
    numpy's generator exactly as the reference package draws them, so
    the same seed gives the same weights bit for bit; executors move
    them to their device."""
    rng = np.random.default_rng(seed)
    ws: Dict[int, torch.Tensor] = {}
    for i, l in spec.param_layers():
        if l.kind == "bias":
            a = rng.standard_normal((l.c_in,)) * scale
        else:
            # HWIO with grouping: the kernel sees C/groups input channels
            a = rng.standard_normal((l.k, l.k, l.c_in // l.groups, l.c_out)) * scale
        ws[i] = torch.from_numpy(a).to(dtype)
    return ws


def run_direct(
    spec: NetSpec, weights: Dict[int, torch.Tensor], x: torch.Tensor
) -> torch.Tensor:
    """Reference execution with the direct convolution (cuDNN, TF32 off,
    on the GPU) everywhere, on `x`'s device.

    The single source of the net's semantics outside the planned executor:
    the oracle that examples, benchmarks, and tests compare against.
    """
    weights = {i: torch.as_tensor(w, device=x.device) for i, w in weights.items()}
    for i, layer in enumerate(spec.layers):
        if layer.kind == "conv":
            x = conv2d_direct(
                x, weights[i],
                pad=layer.pad, stride=layer.stride, groups=layer.groups,
            )
        elif layer.kind == "bias":
            x = x + weights[i]
        elif layer.kind == "relu":
            x = torch.relu(x)
        elif layer.kind == "maxpool":
            b, h, w, c = x.shape
            v = layer.window
            x = x.reshape(b, h // v, v, w // v, v, c).amax(dim=(2, 4))
        else:
            raise ValueError(f"layer {i}: unknown kind {layer.kind!r}")
    return x
