"""Runtime support outside the serving engine: fault injection, the
straggler watchdog and the supervised-retry loop (`runtime.fault`)."""
