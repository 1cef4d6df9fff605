"""Model code of the port: the transformer LM's builder
(models/transformer.py) and its dense and paged decoders
(models/decode.py)."""

from paddle_tpu_torch.models.decode import (PagedDecoder,
                                            TransformerDecoder)
from paddle_tpu_torch.models.transformer import ModelSpec, transformer_lm

__all__ = ["ModelSpec", "PagedDecoder", "TransformerDecoder",
           "transformer_lm"]
