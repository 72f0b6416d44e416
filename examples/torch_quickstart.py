"""Quickstart on the PyTorch port: the algorithm registry through the
public API (the port's counterpart of `examples/quickstart.py`).

A convolution *problem* is a `ConvSpec`; each *realization* (direct,
three_stage, l3_fused, fft_fused, l3_fused_pallas) is a registered
`Algorithm` with a plan/prepare/execute lifecycle; `conv2d` is a thin
dispatcher that resolves ``algo="auto"`` through the registry's roofline
cost model and the wisdom file.  On the card the fused paths launch the
hand-written tile kernel; `--device cpu` runs their plain versions.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--size 56]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import ConvSpec, conv2d, conv2d_direct, registry  # noqa: E402
from repro_torch.core import analysis as an  # noqa: E402

REL_TOL = 1e-3  # every algorithm against the direct oracle


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=56, help="the layer's H = W")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # a ResNet conv layer (64 channels, 56x56) -- the paper's sweet spot
    rng = np.random.default_rng(0)
    s = args.size
    x = torch.tensor(rng.standard_normal((2, s, s, 64)) * 0.1, dtype=torch.float32, device=dev)
    w = torch.tensor(rng.standard_normal((3, 3, 64, 64)) * 0.1, dtype=torch.float32, device=dev)

    ref = conv2d_direct(x, w, pad=1)
    errs = {}
    # every algorithm whose domain covers this problem (the registry also
    # holds e.g. the temporal conv1d algorithm, which declines 2-D specs)
    for algo in registry.supporting(registry.ConvSpec.from_tensors(x, w, pad=1)):
        y = conv2d(x, w, pad=1, algo=algo, device=dev)
        err = float((y - ref).abs().max() / ref.abs().max())
        errs[algo] = err
        print(f"{algo:16s} out={tuple(y.shape)} rel_err_vs_direct={err:.2e}")
    assert len(errs) >= 2 and max(errs.values()) < REL_TOL, errs

    # the same problem as data: what does the registry plan for it?
    spec = ConvSpec.from_tensors(x, w, pad=1)
    plan = registry.plan_conv(spec, an.SKYLAKE_X)
    print(
        f"\nauto on SkylakeX -> {plan.algo} params={plan.params} "
        f"util~{plan.predicted_util:.2f}"
    )

    # new scenarios ride the same dispatcher: stride-2 downsampling layers
    # reach the transformed paths via tile-decimation, grouped layers fall
    # back to direct until a transformed algorithm registers grouped support
    y2 = conv2d(x, w, pad=1, stride=2, device=dev)
    wg = torch.tensor(rng.standard_normal((3, 3, 16, 64)) * 0.1, dtype=torch.float32,
                      device=dev)
    yg = conv2d(x, wg, pad=1, groups=4, device=dev)
    print(f"stride=2 out={tuple(y2.shape)}  groups=4 out={tuple(yg.shape)}")
    spec_g = ConvSpec.from_tensors(x, wg, pad=1, groups=4)
    print(f"groups=4 supported by: {registry.supporting(spec_g)}")

    # the paper's "wisdom": when does fusion win? (S5 analytical model)
    crossover = {}
    for c in (64, 128, 256, 512):
        crossover[c] = registry.plan_conv(
            ConvSpec(h=56, w=56, c_in=c, c_out=c, k=3, pad=1), an.SKYLAKE_X
        ).algo
        print(f"{c:4d} channels on SkylakeX -> {crossover[c]}")
    print("H100 SXM CMR(HBM) =", round(an.H100_SXM.cmr_dram), "(data-sheet model; "
          "SkylakeX DRAM", round(an.SKYLAKE_X.cmr_dram), ")")

    # whole nets go through the Engine: compile once (plan -> staged
    # ExecProgram with cross-layer fusion groups), then serve.  Adjacent
    # small-channel convs collapse into one resident stage -- the paper's
    # L3-residency argument lifted to the net level.
    from repro_torch.configs.convnets import vgg_mixed_channel
    from repro_torch.convserve import Engine, init_weights

    nspec = vgg_mixed_channel(c_in=3)
    net = Engine(hw=an.SKYLAKE_X, device=dev).compile(
        nspec, init_weights(nspec, seed=0), input_hw=(64, 64)
    )
    print(f"\n{nspec.name} staged program ({net.program.n_fused} fusion groups):")
    print(net.describe())
    y = net(torch.zeros((1, 64, 64, 3), dtype=torch.float32, device=dev))
    print(f"net out={tuple(y.shape)}  stats={net.stats()}")
    assert net.program.n_fused >= 1 and torch.isfinite(y).all()
    return dict(errs=errs, auto=plan.algo, crossover=crossover, n_fused=net.program.n_fused)


if __name__ == "__main__":
    main()
