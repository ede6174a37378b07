"""The command lines' device check."""

from __future__ import annotations

import torch


def require_device(script: str, device) -> None:
    """Exit with a message, before any work, when ``device`` is a CUDA
    device and CUDA is not available: the command lines run on the card
    unless ``--device cpu`` is given, and never fall back unasked."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{script}: CUDA is not available; pass --device "
                         "cpu to run on the CPU")
