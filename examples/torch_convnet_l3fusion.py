"""End-to-end ConvNet inference through the PyTorch port's convserve
Engine (the port's counterpart of `examples/convnet_l3fusion.py`): a
mixed-channel VGG-style net is roofline-planned per layer, adjacent
small-channel convs are collapsed into cross-layer fusion groups, kernels
are pre-transformed into the cache, and requests are served in
shape-bucketed batched waves.  On the card the fused layers launch the
hand-written tile kernel; `--device cpu` runs its plain version.

    PYTHONPATH=src python examples/torch_convnet_l3fusion.py [--device cpu] [--reps 5]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.convnets import resnet_downsample, vgg_mixed_channel  # noqa: E402
from repro_torch.convserve import (  # noqa: E402
    ConvServeConfig,
    ConvServer,
    Engine,
    ImageRequest,
    init_weights,
    run_direct,
)

REL_TOL = 1e-3  # the fused engine against the all-direct oracle


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5, help="timed calls per engine")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    spec = vgg_mixed_channel(c_in=3)
    engine = Engine(device=dev)  # the device's own hardware model
    ws = init_weights(spec, seed=0)
    net = engine.compile(spec, ws, input_hw=(64, 64))

    print(f"net {spec.name!r} compiled for {engine.hw.name}:")
    for p in net.plan.layers:
        s = p.spec
        stride = f"/{s.stride}" if s.stride > 1 else "  "
        print(
            f"  layer {p.layer:2d}  {s.c_in:4d}->{s.c_out:<4d}{stride} "
            f"{p.algo:12s} params={p.params} util~{p.predicted_util:.2f}"
        )
    print("staged execution program (fusion groups keep the intermediate")
    print("activation resident instead of round-tripping DRAM):")
    print("  " + net.describe().replace("\n", "\n  "))
    algos = set(net.plan.algos())
    print(f"distinct algorithms in plan: {sorted(algos)}")
    assert len(algos) >= 2, "expected a mixed-algorithm plan"
    assert net.program.n_fused >= 1, "expected >=1 cross-layer fusion group"

    srv = ConvServer(net, ConvServeConfig(max_batch=4, buckets=(32, 64)))

    rng = np.random.default_rng(0)
    imgs = [
        rng.standard_normal((s, s, 3)).astype(np.float32) * 0.1
        for s in (64, 64, 32, 64, 32)
    ]
    reqs = [ImageRequest(i, im) for i, im in enumerate(imgs)]

    t0 = time.perf_counter()
    out = srv.run(reqs)
    print(
        f"wave 1: {len(out)} requests in {time.perf_counter() - t0:.2f}s "
        f"(compiles + kernel transforms) {srv.stats()}"
    )

    # numerical agreement with the all-direct oracle
    ref = run_direct(spec, ws, torch.from_numpy(imgs[0])[None].to(dev))[0].cpu().numpy()
    rel = float(np.abs(out[0] - ref).max() / np.abs(ref).max())
    print(f"fused-engine vs direct rel err {rel:.2e}")
    assert rel < REL_TOL

    # same shapes again: transforms hit the cache, programs are reused
    t0 = time.perf_counter()
    srv.run([ImageRequest(10 + i, im) for i, im in enumerate(imgs)])
    warm = time.perf_counter() - t0
    stats = srv.stats()
    print(f"wave 2: warm {warm*1e3:.1f} ms  {stats}")
    assert stats["cache"]["hits"] > 0, "second wave should hit the cache"

    # throughput: fused program vs unfused vs all-direct on the big bucket
    x = torch.tensor(rng.standard_normal((4, 64, 64, 3)) * 0.1, dtype=torch.float32,
                     device=dev)
    unfused = engine.compile(spec, ws, input_hw=(64, 64), fuse=False)

    def vendor(x):
        return run_direct(spec, ws, x)

    times = {}
    for fn in (vendor, net, unfused):
        fn(x)
    _sync(dev)
    vendor_name = "vendor(cuDNN)" if dev.type == "cuda" else "vendor(direct)"
    for name, fn in (("fused engine", net), ("unfused engine", unfused), (vendor_name, vendor)):
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn(x)
            _sync(dev)
            ts.append(time.perf_counter() - t0)
        times[name] = sorted(ts)[len(ts) // 2] * 1e3 / 4
        print(f"{name:15s} {times[name]:8.3f} ms/img")

    # per-stage times: where does the net actually spend its time?
    print("per-stage profile:")
    for label, secs in net.profile_stages(x):
        print(f"  {label:12s} {secs * 1e3:7.2f} ms")

    # the registry makes new scenarios one compile away: a stride-2
    # ResNet-style downsampling net plans transformed paths too (tile
    # decimation), its stride-1 head still fusing into a group
    rspec = resnet_downsample(c_in=3)
    rws = init_weights(rspec, seed=1)
    rnet = engine.compile(rspec, rws, input_hw=(64, 64))
    print(f"\nnet {rspec.name!r}:")
    print("  " + rnet.describe().replace("\n", "\n  "))
    xr = torch.tensor(rng.standard_normal((2, 64, 64, 3)) * 0.1, dtype=torch.float32,
                      device=dev)
    rref = run_direct(rspec, rws, xr)
    rel2 = float((rnet(xr) - rref).abs().max() / rref.abs().max())
    print(f"stride-2 net fused-engine vs direct rel err {rel2:.2e}")
    assert rel2 < REL_TOL
    return dict(algos=sorted(algos), rel=rel, rel_stride2=rel2, ms_per_img=times)


if __name__ == "__main__":
    main()
