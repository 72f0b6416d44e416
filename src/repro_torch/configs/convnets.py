"""ConvNet specs for the convserve engine (VGG-style stage pipelines).

The mixed-channel nets are the paper's motivating case: early wide-image/
few-channel layers favour the L3-fused path, late many-channel layers
overflow the shared fast level and fall back to the 3-stage structure --
so a single whole-net plan exercises multiple algorithms.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.convserve.graph import NetSpec, bias, conv, maxpool, relu


def vgg_style(
    name: str,
    c_in: int,
    widths: Sequence[int],
    convs_per_stage: int = 2,
    k: int = 3,
    with_bias: bool = False,
) -> NetSpec:
    """Stages of `convs_per_stage` same-padded convs (+ optional bias)
    + ReLU, then 2x2 pool."""
    layers = []
    c = c_in
    for width in widths:
        for _ in range(convs_per_stage):
            layers.append(conv(c, width, k=k))
            if with_bias:
                layers.append(bias(width))
            layers.append(relu())
            c = width
        layers.append(maxpool(2))
    return NetSpec(name=name, layers=tuple(layers))


def vgg_mixed_channel(c_in: int = 3) -> NetSpec:
    """The demo net: 64 -> 128 -> 256 channels across three pooled stages.

    On the paper's CPU models the 64/128-channel stages plan as l3_fused
    and the 256-channel stage's 4 C C' T^2 kernel matrices overflow the
    shared level, planning as three_stage.
    """
    return vgg_style("vgg-mixed", c_in, widths=(64, 128, 256))


def tiny_testnet(c_in: int = 4) -> NetSpec:
    """Small 4-conv net for tests: two stages, channel step 8 -> 16."""
    return vgg_style("tiny-testnet", c_in, widths=(8, 16))


def resnet_downsample(c_in: int = 3) -> NetSpec:
    """ResNet-style stem: stride-2 convs downsample instead of pooling.

    The new-scenario net for the registry API: its stride-2 layers reach
    the transformed paths through tile-decimation (the planner charges the
    stride^2 decimation waste in the cost model), and on the paper's CPU
    models the 64/128-channel stages still plan fused.
    """
    layers = (
        conv(c_in, 64), relu(),
        conv(64, 64), relu(),
        conv(64, 128, stride=2), relu(),  # /2 downsample
        conv(128, 128), relu(),
        conv(128, 256, stride=2), relu(),  # /4 total
        conv(256, 256), relu(),
    )
    return NetSpec(name="resnet-downsample", layers=layers)


def resnext_grouped(c_in: int = 4, groups: int = 4) -> NetSpec:
    """Grouped-conv (ResNeXt-style) net.  Grouped layers reach the
    transformed paths through the shared tile engine's block-diagonal
    channel mix (every registered transform family handles groups); the
    planner charges the 1/groups FLOP saving in the cost model."""
    layers = (
        conv(c_in, 32), relu(),
        conv(32, 32, groups=groups), relu(),
        conv(32, 64, stride=2, groups=groups), relu(),
    )
    return NetSpec(name="resnext-grouped", layers=layers)


def fft_fewchannel(c_in: int = 4) -> NetSpec:
    """Few-channel, wide-image net where the FFT transform wins.

    Zlateski et al.'s observation, through our roofline: with few
    channels the task stream is DRAM-bound, and the FFT's larger tile
    (T=16 vs Winograd's T=7) amortizes the K-1 halo over ~4x the output
    pixels -- the alpha=2 complex FLOPs cancel out of the DRAM-bound cost
    ratio.  Three same-padded chained convs with bias+relu glue and no
    pools, so the planner can fold the whole net into one FFT-backed
    fusion group.
    """
    layers = (
        conv(c_in, 8), bias(8), relu(),
        conv(8, 8), bias(8), relu(),
        conv(8, 8), bias(8), relu(),
    )
    return NetSpec(name="fft-fewchannel", layers=layers)
