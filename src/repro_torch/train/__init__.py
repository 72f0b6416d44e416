"""The train step and the training loop (the reference's `repro.train`)."""
