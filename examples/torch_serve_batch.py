"""End-to-end serving driver on the PyTorch port: batched requests,
prefill + decode engine (the port's counterpart of
`examples/serve_batch.py`).  On the card the prefill runs the flash
kernel and each decode step the decode-MLP kernel.

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)
    results = serve_main(["--arch", "gemma3-1b", "--requests", str(args.requests),
                          "--max-new", str(args.max_new), "--device", args.device])
    assert sorted(results) == list(range(args.requests)), sorted(results)
    assert all(len(v) == args.max_new for v in results.values())
    return results


if __name__ == "__main__":
    main()
