"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The port lives beside the JAX package and imports nothing of it (nor
JAX): it mirrors the old layout (``models/decode.py``,
``serving/engine.py``, ...) so a reader finds each counterpart where
they expect it, and uses PyTorch idiom inside. The JAX package stays
the reference; ``tests/test_torch_*.py`` hold the port against it on
the CPU.

Slices ported so far: the paged-decode serving path —
``TransformerDecoder`` / ``PagedDecoder`` (models/decode.py), the
continuous-batching ``DecodeEngine`` with its prefix cache
(serving/), an engine-backed ``InferenceServer`` + JSON/HTTP front,
the ``serve --decode_config`` CLI, and the hand-written Hopper kernel
for paged window attention (csrc/paged_window_attention.cu).

Entry points run on the card unless the caller passes
``device="cpu"``; with no GPU and no device asked for they raise
(device.py).

Matmul precision: float32 products on the card run at full float32
precision (TF32 off, for matmuls and cuDNN alike) — the port's
counterpart of the JAX package's ``precision=HIGHEST`` policy.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from paddle_tpu_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
