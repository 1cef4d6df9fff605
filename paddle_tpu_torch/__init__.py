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
  flash attention forward, dq and dk/dv (csrc/flash_attention_*.cu);
- the sequence slice — the recurrent layers (lstmemory, grumemory,
  recurrent), sequence pooling, concat, the linear-chain CRF, the
  recurrent stacks of networks.py, ``models.stacked_lstm_net`` /
  ``bidi_lstm_net`` (models/text.py), ``models.rnn_crf_tagger``
  (models/tagger.py) and ``trainer.infer`` / ``Inference``, with
  hand-written Hopper kernels for the fused LSTM forward and backward
  and the GRU forward (csrc/lstm_fwd.cu, lstm_bwd.cu, gru_fwd.cu);
- the serving engine's remaining options — int8 KV pages (the int8
  path of csrc/paged_window_attention.cu), the host spill tier
  (serving/spill.py), speculative decoding with ``DraftDecoder``, and
  the dense ``decode_attention`` op with its hand-written Hopper
  kernel (csrc/decode_attention.cu).

Entry points run on the card unless the caller passes
``device="cpu"``; with no GPU and no device asked for they raise
(device.py).

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

from paddle_tpu_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
