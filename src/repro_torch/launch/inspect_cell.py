"""Dry-run profiler: count one cell, print the top FLOP / byte offenders.

    PYTHONPATH=src python -m repro_torch.launch.inspect_cell --arch gemma3-1b \
        --shape train_4k [--multi-pod] [--save-ops build/cell.ops.json] [--top 15]

Prints the cell's roofline, then the `--top` costliest ops by FLOPs and by
bytes from the op counter (`hlo_analysis.OpCounter`): each aten op by its
signature -- its name and its inputs' shapes and dtypes, in place of the
reference's HLO line and trip-count multiplier -- with its call count,
and each hand-written kernel as ``kernel:<name>``.  `--save-ops` writes
every op with its counts as JSON.  `--impl baseline` exits as the dry
run's does.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--save-ops", default=None, metavar="PATH")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--impl", choices=("baseline", "optimized"), default="optimized")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import BASELINE_REFUSED, run_cell

    if args.impl == "baseline":
        print(BASELINE_REFUSED, file=sys.stderr)
        return 2
    rec, counter = run_cell(args.arch, args.shape, mesh="2x16x16" if args.multi_pod else "1")
    print(json.dumps(rec["roofline"], indent=1))
    print(f"kernel calls: {rec['kernel_calls']}")
    if args.save_ops:
        with open(args.save_ops, "w") as f:
            json.dump(counter.as_list(), f, indent=1)
    top = counter.top(args.top)
    print("\n=== top FLOPs (whole step, every call) ===")
    for sig, st in top["flops"]:
        print(f"{st.flops / 1e9:12.1f} GF  x{st.calls:5d}  {sig[:150]}")
    print("\n=== top bytes (whole step, every call) ===")
    for sig, st in top["bytes"]:
        print(f"{st.bytes / 1e9:12.2f} GB  x{st.calls:5d}  {sig[:150]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
