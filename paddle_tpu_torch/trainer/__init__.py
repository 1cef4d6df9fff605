"""Training of the port: Parameters, the DataFeeder, events and the SGD
trainer (trainer/trainer.py)."""

from paddle_tpu_torch.trainer import event
from paddle_tpu_torch.trainer.data_feeder import DataFeeder
from paddle_tpu_torch.trainer.parameters import Parameters, create
from paddle_tpu_torch.trainer.trainer import SGD

__all__ = ["DataFeeder", "Parameters", "SGD", "create", "event"]
