"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The port lives beside the JAX package and imports nothing of it (nor
JAX): it mirrors the old layout (``models/decode.py``,
``serving/engine.py``, ...) so a reader finds each counterpart where
they expect it, and uses PyTorch idiom inside. The JAX package stays
the reference; ``tests/test_torch_*.py`` hold the port against it on
the CPU.

Slices ported so far:

- the paged-decode serving path — ``TransformerDecoder`` /
  ``PagedDecoder`` (models/decode.py), the continuous-batching
  ``DecodeEngine`` with its prefix cache (serving/), an engine-backed
  ``InferenceServer`` + JSON/HTTP front, the ``serve --decode_config``
  CLI, and the hand-written Hopper kernel for paged window attention
  (csrc/paged_window_attention.cu);
- the training path of ``transformer_lm`` — the layer DSL and the
  ``Topology`` executor (core/, layers/), ``models.transformer_lm``,
  ``Adam`` / ``Momentum`` (optimizer/), ``Parameters`` and the
  ``SGD`` trainer (trainer/), with hand-written Hopper kernels for
  flash attention forward, dq and dk/dv (bfloat16 on the tensor cores,
  csrc/flash_{fwd,dq,dkv}_sm90.cu; float32 as three TF32 passes,
  csrc/flash_{fwd,dq,dkv}_tf32_sm90.cu);
- the sequence slice — the recurrent layers (lstmemory, grumemory,
  recurrent), sequence pooling, concat, the linear-chain CRF, the
  recurrent stacks of networks.py, ``models.stacked_lstm_net`` /
  ``bidi_lstm_net`` (models/text.py), ``models.rnn_crf_tagger``
  (models/tagger.py) and ``trainer.infer`` / ``Inference``, with
  hand-written Hopper kernels for the fused LSTM forward and backward
  and the GRU forward (the LSTM's products on the tensor cores: in
  bfloat16 lstm_fwd_sm90.cu and lstm_bwd_sm90.cu, in float32 both as
  three bf16 passes, lstm_fwd_bf16x3_sm90.cu and
  lstm_bwd_bf16x3_sm90.cu; the GRU's batch rows split
  across thread-block clusters, gru_fwd_sm90.cu, and at wide h the
  cooperative gru_fwd.cu);
- the serving engine's remaining options — int8 KV pages (the int8
  path of csrc/paged_window_attention.cu), the host spill tier
  (serving/spill.py), speculative decoding with ``DraftDecoder``, and
  the dense ``decode_attention`` op with its hand-written Hopper
  kernel (csrc/decode_attention.cu).

- the v2 API around the MNIST main path — the ``paddle.v2``-shaped
  namespace below (``import paddle_tpu_torch as paddle``), readers
  (reader/), the MNIST and CoNLL-05 datasets with their synthetic
  fallback (dataset/), the evaluators (evaluator/), every optimizer
  and schedule of the JAX package with model averaging, and
  ``SGD.save_pass``. ``model`` is not ported yet.
- the image path — conv, pool, batch norm, LRN, space_to_depth and
  dropout (ops/conv.py, ops/pool.py, ops/norm.py, ops/fused.py,
  layers/conv_layers.py), the image stacks of networks.py and
  models/image.py (ResNet, VGG-16, AlexNet, smallnet, the MNIST MLP),
  with the UCI digits of the convergence run (dataset/digits.py). The
  JAX package computes these outside Pallas, so they run on cuDNN and
  plain PyTorch ops: no kernel of this slice is hand-written.
- the CTR path — row-sparse embedding tables (ops/embedding.py's row
  ops, ``Topology.sparse_tables``, the optimizers' prefetch with
  catch-up and row-scatter update, the trainer's sparse step), pruning
  hooks, sparse feeds, the regression and ranking costs and
  ``cos_sim``, models/recommender.py (Wide&Deep, the MovieLens
  regression) and dataset/movielens.py. The JAX package computes the
  row path with XLA outside Pallas, so it runs on PyTorch's sort,
  searchsorted, gathers and index copies.
- the layer families — the element-wise, projection and selection
  layer types, ``mixed`` and the projections, ``op`` (the LayerOutput
  operators), ``models.convolution_net`` / ``ngram_lm`` /
  ``crf_tagger`` / ``googlenet`` and ``dataset.imdb``. The JAX package
  computes them outside Pallas: plain PyTorch ops, and cuDNN for
  GoogleNet's convs.
- the 3-D, image-transform and OCR/speech types with CTC, and the SSD
  detection types with ``nce`` (ops/detection.py,
  layers/detection_layers.py): every layer type of the JAX package.
  With them the rest of the v2 datasets, ``image.py`` and the
  gradient printer. Plain PyTorch ops and cuDNN again: the JAX package
  computes them outside Pallas.

Entry points run on the card unless the caller passes
``device="cpu"`` or called ``init(use_gpu=False)``; with no GPU and no
device asked for they raise (device.py).

Matmul precision: float32 products on the card run at full float32
precision (TF32 off, for matmuls and cuDNN alike) — the port's
counterpart of the JAX package's ``precision=HIGHEST`` policy. Under
``compute_dtype="bfloat16"`` the JAX package multiplies bf16 inputs
with float32 accumulation (``preferred_element_type=float32``), so
cuBLAS's reduced-precision (bf16) reductions are turned off too.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

# the v2 namespace, as paddle_tpu/__init__.py exports it. Importing the
# layers fills the layer registry: Topology.deserialize needs it in any
# process. Cheap: no CUDA call and no kernel build happens at import.
from paddle_tpu_torch import config as _config  # noqa: E402,F401
from paddle_tpu_torch.config import init  # noqa: E402
from paddle_tpu_torch.device import resolve_device  # noqa: E402
from paddle_tpu_torch import layers as layer  # noqa: E402
from paddle_tpu_torch import optimizer  # noqa: E402
from paddle_tpu_torch import trainer  # noqa: E402
from paddle_tpu_torch.trainer import event  # noqa: E402
from paddle_tpu_torch.trainer.parameters import (  # noqa: E402
    Parameters, create as create_parameters)
from paddle_tpu_torch.trainer.trainer import SGD  # noqa: E402
from paddle_tpu_torch.trainer.inference import Inference, infer  # noqa: E402
from paddle_tpu_torch import reader  # noqa: E402
from paddle_tpu_torch import dataset  # noqa: E402
from paddle_tpu_torch.core.topology import Topology  # noqa: E402
from paddle_tpu_torch.core import data_type  # noqa: E402
from paddle_tpu_torch import activation  # noqa: E402
from paddle_tpu_torch import attr  # noqa: E402
from paddle_tpu_torch import pooling  # noqa: E402
from paddle_tpu_torch import evaluator  # noqa: E402
from paddle_tpu_torch import op  # noqa: E402  (installs the operators)

__all__ = [
    "init",
    "layer",
    "optimizer",
    "trainer",
    "event",
    "Parameters",
    "create_parameters",
    "SGD",
    "infer",
    "Inference",
    "reader",
    "dataset",
    "Topology",
    "data_type",
    "activation",
    "attr",
    "pooling",
    "evaluator",
    "op",
    "resolve_device",
]
