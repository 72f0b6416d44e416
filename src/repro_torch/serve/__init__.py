"""Batched LM serving (`Engine`): waves of requests, prefill + decode."""

from repro_torch.serve.engine import Engine, Request, ServeConfig

__all__ = ["Engine", "Request", "ServeConfig"]
