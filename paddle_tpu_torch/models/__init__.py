"""Model code of the port (models/decode.py: the transformer LM's
dense and paged decoders)."""

from paddle_tpu_torch.models.decode import (PagedDecoder,
                                            TransformerDecoder)

__all__ = ["PagedDecoder", "TransformerDecoder"]
