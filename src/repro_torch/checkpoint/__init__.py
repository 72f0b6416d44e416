"""Atomic, async, keep-k checkpoints (the reference's `repro.checkpoint`)."""
