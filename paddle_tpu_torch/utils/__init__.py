"""Host utilities of the port (``paddle_tpu/utils/``): logging,
scoped stat timers and counters, the model diagram and the torch
``state_dict`` import."""

from paddle_tpu_torch.utils import stats

__all__ = ["stats"]
