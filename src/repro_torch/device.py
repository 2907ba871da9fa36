"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. There is no silent fallback to the CPU: a
    caller that wants the CPU path asks for it with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch needs a CUDA device (none is available); pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
