"""Model code of the port: the transformer family's builders — the LM
(with its MoE and residual-dropout options), the masked-LM encoder and
the sequence classifier (models/transformer.py) — and the LM's dense,
paged and draft decoders (models/decode.py); the IMDB stacked-LSTM
classifier, its bidirectional variant, the quick-start text CNN and the
N-gram LM (models/text.py); the context-window and GRU CRF taggers
(models/tagger.py); the image models (models/image.py); the attention
NMT and its beam-search generator (models/seq2seq.py); Wide&Deep CTR
and the MovieLens regression (models/recommender.py)."""

from paddle_tpu_torch.models.decode import (DraftDecoder, PagedDecoder,
                                            TransformerDecoder)
from paddle_tpu_torch.models.image import (alexnet, googlenet, mnist_mlp,
                                           resnet, resnet50, smallnet, vgg16)
from paddle_tpu_torch.models.recommender import (movielens_regression,
                                                 wide_and_deep)
from paddle_tpu_torch.models.seq2seq import nmt_attention, nmt_generator
from paddle_tpu_torch.models.tagger import crf_tagger, rnn_crf_tagger
from paddle_tpu_torch.models.text import (bidi_lstm_net, convolution_net,
                                          ngram_lm, stacked_lstm_net)
from paddle_tpu_torch.models.transformer import (ModelSpec,
                                                 transformer_classifier,
                                                 transformer_encoder,
                                                 transformer_lm)

__all__ = ["DraftDecoder", "ModelSpec", "PagedDecoder", "TransformerDecoder",
           "alexnet", "bidi_lstm_net", "convolution_net", "crf_tagger",
           "googlenet", "mnist_mlp", "movielens_regression", "ngram_lm",
           "nmt_attention", "nmt_generator", "resnet",
           "resnet50", "rnn_crf_tagger", "smallnet", "stacked_lstm_net",
           "transformer_classifier", "transformer_encoder",
           "transformer_lm", "vgg16", "wide_and_deep"]
