"""``python -m repro_torch.convserve.check``: run all three analyzers.

Default scope: the IR verifier over every benched config's fresh plan
under both hardware models the port plans for (the H100 and the paper's
SkylakeX CPU), the lock analyzer over the runtime's shared-state modules
and the kernel build/launch module, and the rule linter over all of
``src/repro_torch``.  Exit status is
1 if any analyzer reports errors (``--strict`` also fails on warnings);
``--baseline PATH`` writes the merged report as JSON for artifact
upload either way.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.convserve.check.diagnostics import CheckReport
from repro_torch.convserve.check.ir import verify_program
from repro_torch.convserve.check.locks import analyze_locks
from repro_torch.convserve.check.rules import analyze_rules

# the committed configs the bench suite serves — what "the tree's plans
# verify clean" means concretely
BENCHED_CONFIGS = (
    "vgg_mixed_channel",
    "tiny_testnet",
    "resnet_downsample",
    "resnext_grouped",
    "fft_fewchannel",
)


def _src_root() -> Path:
    # .../src/repro_torch/convserve/check/__main__.py -> .../src
    return Path(__file__).resolve().parents[3]


def run_ir() -> CheckReport:
    from repro_torch.configs import convnets
    from repro_torch.convserve.planner import plan_net
    from repro_torch.core import analysis

    merged = CheckReport(analyzer="ir")
    for hw in (analysis.H100_SXM, analysis.SKYLAKE_X):
        for name in BENCHED_CONFIGS:
            spec = getattr(convnets, name)()
            plan = plan_net(spec, 64, 64, hw=hw)
            merged.extend(verify_program(spec, plan, hw=hw))
    return merged


def run_locks(src: Path) -> CheckReport:
    convserve = src / "repro_torch" / "convserve"
    return analyze_locks([
        convserve / "runtime",
        convserve / "adapt",
        convserve / "fleet",
        convserve / "obs",
        convserve / "cache.py",
        # the fleet's fault schedule lives outside convserve but is
        # consulted from replica completion paths: same discipline
        src / "repro_torch" / "runtime" / "fault.py",
        # replica threads build, load and launch kernels concurrently
        src / "repro_torch" / "kernels" / "_build.py",
    ])


def run_rules(src: Path) -> CheckReport:
    return analyze_rules([src / "repro_torch"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.convserve.check",
        description="convcheck: IR verifier + lock discipline + "
        "clock/convention rules",
    )
    ap.add_argument(
        "--strict", action="store_true",
        help="fail (exit 1) on warnings too, not just errors",
    )
    ap.add_argument(
        "--baseline", metavar="PATH", default=None,
        help="write the merged JSON report here (written even on failure)",
    )
    ap.add_argument(
        "--only", choices=("ir", "locks", "rules"), default=None,
        help="run a single analyzer instead of all three",
    )
    args = ap.parse_args(argv)

    src = _src_root()
    reports = []
    if args.only in (None, "ir"):
        reports.append(run_ir())
    if args.only in (None, "locks"):
        reports.append(run_locks(src))
    if args.only in (None, "rules"):
        reports.append(run_rules(src))

    errors = sum(len(r.errors) for r in reports)
    warnings = sum(len(r.warnings) for r in reports)
    for r in reports:
        print(r.format())
    print(
        f"convcheck: {errors} error(s), {warnings} warning(s) across "
        f"{len(reports)} analyzer(s)"
    )

    if args.baseline:
        doc = {
            "errors": errors,
            "warnings": warnings,
            "reports": [r.to_dict() for r in reports],
        }
        Path(args.baseline).write_text(json.dumps(doc, indent=1, sort_keys=True))
        print(f"baseline written to {args.baseline}")

    failed = errors > 0 or (args.strict and warnings > 0)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
