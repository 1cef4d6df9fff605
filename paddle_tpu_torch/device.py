"""Device resolution for the port's entry points.

Every entry point takes ``device=None``: None means the process's
device, which ``config.init(use_gpu=False)`` sets to the CPU, and
otherwise the current CUDA card, raising when there is none — the
port never carries on on the CPU by accident. Tests and CPU tooling
pass ``device="cpu"`` or call ``init(use_gpu=False)``."""

from __future__ import annotations

from typing import Union

import torch

from paddle_tpu_torch.config import global_config

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None is the device ``init``
    recorded, else the current CUDA device, and an error when CUDA is
    unavailable."""
    if device is None:
        device = global_config().device
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch "
            "path on the CPU, or call init(use_gpu=False)")
    return torch.device("cuda", torch.cuda.current_device())
