"""The port's default device: CUDA, with no silent fall back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    """`device` if given, else 'cuda'. With no CUDA present the default
    raises; a caller that wants the plain PyTorch path passes device='cpu'."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who} runs on CUDA and no CUDA device is "
                               "available; pass device='cpu' for the plain "
                               "PyTorch path")
        device = "cuda"
    return torch.device(device)
