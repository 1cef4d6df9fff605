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
- ``device``: the process's device when an entry point is given none.
  ``init(use_gpu=False)`` (or ``use_tpu=False``) sets the CPU — v2's
  own meaning of the flag, the JAX package's ``config.py`` reads the
  same arguments; left unset (None or True) the entry points take the
  current CUDA card and raise without one (device.py).
- ``debug_nans``: the FPE-trap discipline. The JAX package sets
  ``jax_debug_nans``; here ``SGD`` checks the step's cost, metrics and
  layer state after the forward and every gradient after the backward,
  and raises ``FloatingPointError`` at the first non-finite value,
  before the update writes anything.

- ``trainer_count``: data parallelism without an explicit mesh, the
  v2 contract. ``SGD(mesh=None)`` with ``trainer_count > 1`` trains on
  a dp mesh over the initialized process group
  (``parallel.init_distributed``), one rank per trainer; with no group,
  or one of a single rank, it warns and trains on one device, as the
  JAX package does when it sees one device. A group smaller than the
  count gives dp = its size (with a warning); a larger one raises.
- ``process_index`` / ``process_count``: this rank and the world size,
  recorded by ``parallel.init_distributed`` (0 and 1 without a group).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class GlobalConfig:
    compute_dtype: str = "float32"
    log_period: int = 100
    seed: int = 0
    use_flash_attention: bool = True
    device: Optional[str] = None
    debug_nans: bool = False
    trainer_count: int = 1
    process_index: int = 0
    process_count: int = 1
    initialized: bool = False


_g = GlobalConfig()


def init(use_tpu: Optional[bool] = None, use_gpu: Optional[bool] = None,
         trainer_count: int = 1, seed: int = 0,
         compute_dtype: str = "float32", log_period: int = 100,
         use_flash_attention: bool = True, debug_nans: bool = False,
         **kwargs) -> GlobalConfig:
    """paddle.v2.init counterpart. ``use_tpu`` (or, when it is None,
    ``use_gpu``) False asks for the CPU; None or True for the card.
    ``trainer_count`` > 1 makes ``SGD`` train data-parallel over the
    process group (the module docstring). ``debug_nans`` is set and
    cleared by each call, as the JAX package's is."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype!r}")
    accel = use_tpu if use_tpu is not None else use_gpu
    _g.device = "cpu" if accel is False else None
    _g.seed = seed
    _g.compute_dtype = compute_dtype
    _g.log_period = log_period
    _g.use_flash_attention = bool(use_flash_attention)
    _g.debug_nans = bool(debug_nans)
    _g.trainer_count = int(trainer_count)
    _g.initialized = True
    return _g


def global_config() -> GlobalConfig:
    return _g
