"""The training loop: steps + checkpoints + fault handling + watchdog --
the port of `src/repro/train/loop.py`.

The single-process core; `launch/train.py` wraps it.  Restore-on-failure
(up to `max_restarts`), resume from disk, the SIGTERM save and the
straggler alarm behave as the reference's.  A step's wall time is read
after its loss reached the host (the card runs ahead of the host
otherwise).  SIGTERM's handler is installed with `signal.signal`, which
works on the main thread only: call the loop there.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.runtime.fault import FailureInjector, StragglerWatchdog

Tree = Any


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    max_restarts: int = 5


def train_loop(
    *,
    state: Tree,
    train_step: Callable,
    next_batch: Callable[[int], Dict],
    cfg: LoopConfig,
    injector: Optional[FailureInjector] = None,
    log: Callable[[str], None] = print,
    on_step: Optional[Callable[[int, Dict, float], None]] = None,
) -> Tree:
    """Run to cfg.total_steps with restore-on-failure semantics.
    `on_step(step, metrics, seconds)` is called after every completed step
    (metrics as the step returned them)."""
    ckpt = (
        ckpt_io.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        if cfg.ckpt_dir
        else None
    )
    watchdog = StragglerWatchdog()

    # resume if a checkpoint exists
    step = 0
    if cfg.ckpt_dir:
        last = ckpt_io.latest_step(cfg.ckpt_dir)
        if last is not None:
            state, step = ckpt_io.restore(cfg.ckpt_dir, last, state)
            step += 1
            log(f"[resume] restored step {step - 1}, continuing at {step}")

    # SIGTERM (preemption) -> synchronous save + clean exit
    interrupted = {"flag": False}

    def _on_term(signum, frame):
        interrupted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _on_term)

    restarts = 0
    try:
        while step < cfg.total_steps:
            try:
                batch = next_batch(step)
                if injector is not None:
                    injector.check(step)
                t0 = time.monotonic()
                state, metrics = train_step(state, batch)
                loss = float(metrics["loss"])  # waits for the step's device work
                dt = time.monotonic() - t0
                alarm = watchdog.observe(step, dt)
                if alarm:
                    log(f"[straggler] step {step}: {dt:.3f}s vs p50 "
                        f"{alarm['p50']:.3f}s -- flagging for reassignment")
                if step % cfg.log_every == 0:
                    log(
                        f"step {step:6d} loss {loss:.4f} "
                        f"gnorm {float(metrics.get('grad_norm', 0)):.3f} "
                        f"({dt:.3f}s)"
                    )
                if on_step is not None:
                    on_step(step, metrics, dt)
                if ckpt and step > 0 and step % cfg.ckpt_every == 0:
                    ckpt.save(step, state)
                if interrupted["flag"]:
                    log(f"[preempt] SIGTERM at step {step}: saving + exiting")
                    if ckpt:
                        ckpt.wait()
                        ckpt_io.save(cfg.ckpt_dir, step, state, keep=cfg.keep)
                    return state
                step += 1
            except Exception as e:
                if ckpt is None or restarts >= cfg.max_restarts:
                    raise
                restarts += 1
                log(f"[fault] step {step}: {type(e).__name__}: {e} -- "
                    f"restoring from last checkpoint (restart {restarts})")
                ckpt.wait()
                last = ckpt_io.latest_step(cfg.ckpt_dir)
                if last is None:
                    raise
                state, restored = ckpt_io.restore(cfg.ckpt_dir, last, state)
                step = restored + 1
        if ckpt:
            ckpt.wait()
            ckpt_io.save(cfg.ckpt_dir, cfg.total_steps - 1, state, keep=cfg.keep)
    finally:
        signal.signal(signal.SIGTERM, old_handler)
    return state
