"""Online ConvNet serving on the PyTorch port: the runtime end to end on
Poisson traffic (the port's counterpart of `examples/serve_online.py`).

Compiles a planned convnet into a 2-replica pool (one shared
pre-transformed kernel cache), replays a seeded open-loop Poisson trace
with a 60 ms interactive SLO through the deadline-aware wave scheduler,
and prints the telemetry document -- throughput, queue/compute/e2e
percentiles, wave + admission counters, cache reuse.

The flight recorder rides along: every admit/wave/stage lands in a span
ring, incidents (SLO breach, verification error) dump it immediately,
and the whole run is written to `--trace` (default
``serve_online.trace.json``) on exit -- open it in Perfetto
(https://ui.perfetto.dev) or chrome://tracing.  On the card the fused
layers launch the hand-written tile kernel.

    PYTHONPATH=src python examples/torch_serve_online.py [--device cpu] [--requests 150]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs.convnets import tiny_testnet  # noqa: E402
from repro_torch.convserve import Engine, init_weights  # noqa: E402
from repro_torch.convserve.obs import (  # noqa: E402
    FlightRecorder,
    Tracer,
    roofline_table,
    validate_chrome_trace,
    write_trace,
)
from repro_torch.convserve.runtime import (  # noqa: E402
    INTERACTIVE,
    STANDARD,
    ReplicaPool,
    RuntimeConfig,
    ServeRuntime,
    make_images,
    poisson_trace,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=150)
    ap.add_argument("--trace", default="serve_online.trace.json", metavar="PATH")
    args = ap.parse_args(argv)

    spec = tiny_testnet(4)
    weights = init_weights(spec, seed=0)
    engine = Engine(device=args.device)

    pool = ReplicaPool.build(engine, spec, weights, n=2, input_hw=(32, 32))
    cfg = RuntimeConfig(
        max_batch=8,
        buckets=(32, 64),
        queue_depth=64,
        # interactive requests flush waves after 60 ms of slack,
        # standard ones after 200 ms
        slo_s={INTERACTIVE: 0.06, STANDARD: 0.20},
        service_est_s=0.005,
    )
    tracer = Tracer()
    prefix = os.path.join(os.path.dirname(os.path.abspath(args.trace)), "serve_online")
    recorder = FlightRecorder(tracer, path_prefix=prefix)
    rt = ServeRuntime(pool, cfg, tracer=tracer, recorder=recorder)

    # compile the max_batch program for every (bucket, replica) and
    # prepare the shared kernel transforms, so the trace measures
    # serving rather than compiles
    rt.warmup()

    trace = poisson_trace(
        rate_hz=120.0, n=args.requests, seed=7, sizes=(24, 32, 48, 64),
        priorities=(INTERACTIVE, STANDARD),
    )
    images = make_images(trace, c=4, seed=8)
    results = rt.play(trace, images)
    served = len([a for a in trace if a.rid in results])
    print(f"served {served}/{len(trace)} requests")

    doc = rt.stats(profile_bucket=32)
    e2e = doc["latency"]["e2e"]
    print(f"p50 {e2e['p50_s'] * 1e3:.1f} ms   "
          f"p95 {e2e['p95_s'] * 1e3:.1f} ms   "
          f"p99 {e2e['p99_s'] * 1e3:.1f} ms")
    print(json.dumps(
        {k: doc[k] for k in ("counters", "scheduler", "cache")},
        indent=1, sort_keys=True,
    ))
    rf = doc.get("roofline")
    if rf:
        print(roofline_table(rf["stages"], hw_name=rf["hw"]["name"]))
    rt.shutdown()

    n = write_trace(tracer, args.trace)
    with open(args.trace) as f:
        problems = validate_chrome_trace(json.load(f))
    print(f"wrote {args.trace} ({n} events) -- open in Perfetto; "
          f"recorder trips: {recorder.stats()['trips'] or 'none'}")
    assert served == len(trace), f"{len(trace) - served} requests unanswered"
    assert not problems, problems[:5]
    return dict(served=served, events=n, doc=doc)


if __name__ == "__main__":
    main()
