"""Training and inference of the port: Parameters, the DataFeeder,
events, the SGD trainer (trainer/trainer.py) and Inference / infer
and the inference artifact (trainer/inference.py)."""

from paddle_tpu_torch.trainer import event
from paddle_tpu_torch.trainer.data_feeder import DataFeeder
from paddle_tpu_torch.trainer.inference import (Inference, infer,
                                                 load_inference_model,
                                                 save_inference_model)
from paddle_tpu_torch.trainer.parameters import Parameters, create
from paddle_tpu_torch.trainer.trainer import SGD

__all__ = ["DataFeeder", "Inference", "Parameters", "SGD", "create",
           "event", "infer", "load_inference_model", "save_inference_model"]
