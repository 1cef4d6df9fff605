"""Optimizers of the port (optimizer/optimizers.py) and their
learning-rate schedules (optimizer/schedules.py)."""

from paddle_tpu_torch.optimizer import schedules
from paddle_tpu_torch.optimizer.optimizers import (
    SGD, AdaDelta, AdaGrad, Adam, Adamax, DecayedAdaGrad, L1Regularization,
    L2Regularization, ModelAverage, Momentum, Optimizer, RmsProp)

__all__ = ["AdaDelta", "AdaGrad", "Adam", "Adamax", "DecayedAdaGrad",
           "L1Regularization", "L2Regularization", "ModelAverage",
           "Momentum", "Optimizer", "RmsProp", "SGD", "schedules"]
