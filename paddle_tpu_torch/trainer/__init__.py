"""Training and inference of the port: Parameters, the DataFeeder,
events, the SGD trainer (trainer/trainer.py) and Inference / infer
(trainer/inference.py)."""

from paddle_tpu_torch.trainer import event
from paddle_tpu_torch.trainer.data_feeder import DataFeeder
from paddle_tpu_torch.trainer.inference import Inference, infer
from paddle_tpu_torch.trainer.parameters import Parameters, create
from paddle_tpu_torch.trainer.trainer import SGD

__all__ = ["DataFeeder", "Inference", "Parameters", "SGD", "create",
           "event", "infer"]
