"""Device resolution for the port's entry points.

Every entry point takes ``device=None``: None means the current CUDA
card, and raises when there is none — the port never carries on on
the CPU by accident. Tests and CPU tooling pass ``device="cpu"``
explicitly."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None is the current CUDA
    device, and an error when CUDA is unavailable."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch "
            "path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
