"""Global process configuration — the port of ``paddle_tpu/config.py``.

One typed config object, read by the ops and layers at call time:

- ``compute_dtype``: the matmul dtype. Parameters stay float32 (the
  master weights); under ``"bfloat16"`` every fc multiplies bf16
  inputs with float32 accumulation and emits bf16 (ops/linear.py).
- ``seed``: the trainer's seed (initialisation draws from a
  ``torch.Generator`` seeded with it when none is given).
- ``use_flash_attention``: on a CUDA card the attention layer runs the
  hand-written flash kernels (ops/flash_attention.py); False takes the
  plain version everywhere, the JAX package's own switch.

The JAX package's device flags (``use_tpu``, ``trainer_count``,
process index/count, ``debug_nans``) have no counterpart in this
slice: device choice is each entry point's ``device`` argument
(device.py).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class GlobalConfig:
    compute_dtype: str = "float32"
    log_period: int = 100
    seed: int = 0
    use_flash_attention: bool = True
    initialized: bool = False


_g = GlobalConfig()


def init(seed: int = 0, compute_dtype: str = "float32",
         log_period: int = 100, use_flash_attention: bool = True,
         **kwargs) -> GlobalConfig:
    """paddle.v2.init counterpart. Device-selection arguments of the
    JAX package (``use_tpu``, ``use_gpu``, ``trainer_count``) are
    accepted for source compatibility and ignored: the port's entry
    points take ``device`` instead."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype!r}")
    _g.seed = seed
    _g.compute_dtype = compute_dtype
    _g.log_period = log_period
    _g.use_flash_attention = bool(use_flash_attention)
    _g.initialized = True
    return _g


def global_config() -> GlobalConfig:
    return _g
