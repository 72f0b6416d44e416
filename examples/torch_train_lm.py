"""End-to-end LM training driver on the PyTorch port: a small model, a
few hundred steps, with checkpointing + resume (the port's counterpart of
`examples/train_lm.py`; the same code path `launch/train.py` runs the
full configs on).  On the card each step runs the flash forward and
backward kernels.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

After the run, a second run resumes from the run's last checkpoint
before its end (copied into a directory of its own, so that the final
save does not hide it) and must reach the same final loss: the resume
check.  Each run checkpoints into a fresh directory under `--ckpt-dir`
(default `build/torch_train_lm`).
"""

import argparse
import math
import os
import shutil
import sys
import tempfile

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402

RESUME_TOL = 1e-4  # the resumed run's last loss against the uninterrupted run's


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--ckpt-dir", default=os.path.join(ROOT, "build", "torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="run-", dir=args.ckpt_dir)
    launch = [
        "--arch", args.arch, "--reduced",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "64", "--lr", "3e-3",
        "--ckpt-dir", ckpt_dir, "--ckpt-every", str(args.ckpt_every),
        "--device", args.device,
    ]
    _, hist = train_main(launch)
    losses = [h["loss"] for h in hist]
    print(f"[train_lm] loss {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps")
    assert len(losses) == args.steps and all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0], "the loss did not fall"

    # resume: the launcher restores the last checkpoint before the end and
    # runs the rest on the same schedule
    last_ckpt = (args.steps - 1) // args.ckpt_every * args.ckpt_every
    assert 0 < last_ckpt < args.steps - 1, "no checkpoint before the last step"
    resume_dir = tempfile.mkdtemp(prefix="resume-", dir=args.ckpt_dir)
    for name in (f"step_{last_ckpt}", f"step_{last_ckpt}.done"):
        src, dst = os.path.join(ckpt_dir, name), os.path.join(resume_dir, name)
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, dst)
    launch[launch.index("--ckpt-dir") + 1] = resume_dir
    _, again = train_main(launch)
    print(f"[train_lm] resumed at step {again[0]['step'] if again else None} "
          f"(checkpoint {last_ckpt}): last loss {again[-1]['loss']:.6f} vs "
          f"{losses[-1]:.6f} uninterrupted")
    assert again[0]["step"] == last_ckpt + 1, again[:1]
    assert abs(again[-1]["loss"] - losses[-1]) <= RESUME_TOL * abs(losses[-1])
    return dict(losses=losses, resumed_from=last_ckpt, resumed_losses=[h["loss"] for h in again])


if __name__ == "__main__":
    main()
