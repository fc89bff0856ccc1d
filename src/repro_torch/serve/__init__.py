"""LM serving: batched prefill + decode (``Engine``)."""

from repro_torch.serve.engine import Engine, ServeConfig

__all__ = ["Engine", "ServeConfig"]
