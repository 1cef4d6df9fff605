"""paddle.v2.attr-compatible attribute classes — the port of
``paddle_tpu/attr.py``: ``Param`` / ``ParameterAttribute`` build the
port's ``core/registry.ParamAttr``; ``ExtraLayerAttribute`` (``Extra``,
``ExtraAttr``) and ``HookAttribute`` carry their fields as the JAX
package's do. The layers that read them say what they support."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.core.registry import ParamAttr


class HookAttribute:
    """Parameter update hook: type='pruning' with sparsity_ratio — the
    optimizers keep a mask of the largest-|w| weights, applied after
    every update (``Optimizer.refresh_hooks``)."""

    def __init__(self, type: str, sparsity_ratio: Optional[float] = None):
        assert type in ("pruning",), f"unsupported hook type {type!r}"
        self.type = type
        self.sparsity_ratio = 0.6 if sparsity_ratio is None else \
            float(sparsity_ratio)
        if self.type == "pruning":
            assert 0.0 <= self.sparsity_ratio <= 1.0


def Param(name: Optional[str] = None, learning_rate: float = 1.0,
          l1_rate: Optional[float] = None, l2_rate: Optional[float] = None,
          initial_std: Optional[float] = None, initial_mean: float = 0.0,
          is_static: bool = False, sparse_update: bool = False,
          gradient_clipping_threshold: Optional[float] = None,
          initializer=None, update_hooks=None, **kwargs) -> ParamAttr:
    return ParamAttr(name=name, learning_rate=learning_rate,
                     l1_rate=l1_rate, l2_rate=l2_rate,
                     initial_std=initial_std, initial_mean=initial_mean,
                     is_static=is_static, sparse=sparse_update,
                     gradient_clipping_threshold=gradient_clipping_threshold,
                     initializer=initializer, update_hooks=update_hooks)


ParameterAttribute = Param


class ExtraLayerAttribute:
    """Extra layer attributes: drop_rate, device (accepted and ignored)
    and error clipping."""

    def __init__(self, drop_rate: Optional[float] = None,
                 device: Optional[int] = None,
                 error_clipping_threshold: Optional[float] = None):
        self.drop_rate = drop_rate
        self.device = device
        self.error_clipping_threshold = error_clipping_threshold


Extra = ExtraLayerAttribute
ExtraAttr = ExtraLayerAttribute
