"""The device an entry point creates its tensors on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``, a bare "cuda" as the current card
    ("cuda:0"), so that it compares equal to the device of the tensors made
    there.  A CUDA device on a host without a card raises (the entry points
    default to the card and never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
