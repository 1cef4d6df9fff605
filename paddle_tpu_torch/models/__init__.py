"""Model code of the port: the transformer LM's builder
(models/transformer.py) and its dense and paged decoders
(models/decode.py); the IMDB stacked-LSTM classifier and its
bidirectional variant (models/text.py); the GRU-CRF tagger
(models/tagger.py)."""

from paddle_tpu_torch.models.decode import (PagedDecoder,
                                            TransformerDecoder)
from paddle_tpu_torch.models.tagger import rnn_crf_tagger
from paddle_tpu_torch.models.text import bidi_lstm_net, stacked_lstm_net
from paddle_tpu_torch.models.transformer import ModelSpec, transformer_lm

__all__ = ["ModelSpec", "PagedDecoder", "TransformerDecoder",
           "bidi_lstm_net", "rnn_crf_tagger", "stacked_lstm_net",
           "transformer_lm"]
