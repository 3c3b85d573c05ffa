"""The port's device rule: entry points default to ``"cuda"`` and never fall
back to the CPU on their own."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise when it names CUDA and
    no CUDA device is present (pass ``device="cpu"`` to run on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        if device.index is None:  # "cuda" names the current card, as tensors record it
            device = torch.device("cuda", torch.cuda.current_device())
    return device
