"""Model code of the port: the transformer family's builders — the LM
(with its MoE and residual-dropout options), the masked-LM encoder and
the sequence classifier (models/transformer.py) — and the LM's dense,
paged and draft decoders (models/decode.py); the IMDB stacked-LSTM
classifier and its bidirectional variant (models/text.py); the GRU-CRF
tagger (models/tagger.py); the image models (models/image.py); the attention
NMT and its beam-search generator (models/seq2seq.py); Wide&Deep CTR
and the MovieLens regression (models/recommender.py)."""

from paddle_tpu_torch.models.decode import (DraftDecoder, PagedDecoder,
                                            TransformerDecoder)
from paddle_tpu_torch.models.image import (alexnet, googlenet, mnist_mlp,
                                           resnet, resnet50, smallnet, vgg16)
from paddle_tpu_torch.models.recommender import (movielens_regression,
                                                 wide_and_deep)
from paddle_tpu_torch.models.seq2seq import nmt_attention, nmt_generator
from paddle_tpu_torch.models.tagger import rnn_crf_tagger
from paddle_tpu_torch.models.text import bidi_lstm_net, stacked_lstm_net
from paddle_tpu_torch.models.transformer import (ModelSpec,
                                                 transformer_classifier,
                                                 transformer_encoder,
                                                 transformer_lm)

__all__ = ["DraftDecoder", "ModelSpec", "PagedDecoder", "TransformerDecoder",
           "alexnet", "bidi_lstm_net", "googlenet", "mnist_mlp",
           "movielens_regression", "nmt_attention",
           "nmt_generator", "resnet",
           "resnet50", "rnn_crf_tagger", "smallnet", "stacked_lstm_net",
           "transformer_classifier", "transformer_encoder",
           "transformer_lm", "vgg16", "wide_and_deep"]
