"""Where a component's device state lives: the card unless the caller
asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    """`device` as a torch.device, a missing one meaning the current
    CUDA device.  Without a CUDA device the caller must ask for the CPU
    (`device="cpu"`): nothing moves there on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available; pass "
            "device=\"cpu\" to run on the CPU")
    return dev
