"""Optimizers of the port (optimizer/optimizers.py)."""

from paddle_tpu_torch.optimizer.optimizers import (SGD, Adam,
                                                   L1Regularization,
                                                   L2Regularization,
                                                   Momentum, Optimizer)

__all__ = ["Adam", "L1Regularization", "L2Regularization", "Momentum",
           "Optimizer", "SGD"]
