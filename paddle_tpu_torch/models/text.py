"""Text classifiers — the port of ``stacked_lstm_net`` and
``bidi_lstm_net`` of ``paddle_tpu/models/text.py`` (``convolution_net``
and ``ngram_lm`` wait).

``stacked_lstm_net`` is the IMDB sentiment classifier of the RNN
benchmark (embedding -> N x simple_lstm -> last_seq -> softmax fc);
the forward LSTM runs the fused kernels on the card.
"""

from __future__ import annotations

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import layers as layer
from paddle_tpu_torch import networks
from paddle_tpu_torch.core.data_type import (integer_value,
                                             integer_value_sequence)
from paddle_tpu_torch.models.transformer import ModelSpec


def stacked_lstm_net(vocab_size: int = 30000, emb_size: int = 128,
                     hidden_size: int = 128, lstm_num: int = 1,
                     num_classes: int = 2) -> ModelSpec:
    """Feed contract: (word ids sequence, class label)."""
    data = layer.data("word", integer_value_sequence(vocab_size))
    lbl = layer.data("label", integer_value(num_classes))
    t = layer.embedding(data, size=emb_size, name="sln_emb")
    for i in range(lstm_num):
        t = networks.simple_lstm(t, size=hidden_size, name=f"sln_lstm{i}")
    t = layer.last_seq(t, name="sln_last")
    out = layer.fc(t, size=num_classes, act=act.Softmax(), name="sln_out")
    cost = layer.classification_cost(out, lbl, name="sln_cost")
    err = layer.classification_error(out, lbl, name="sln_error")
    return ModelSpec("stacked_lstm_net", data, lbl, out, cost, err)


def bidi_lstm_net(vocab_size: int = 30000, emb_size: int = 128,
                  hidden_size: int = 128, num_classes: int = 2) -> ModelSpec:
    """The bidirectional variant: the reverse LSTM runs the plain scan."""
    data = layer.data("word", integer_value_sequence(vocab_size))
    lbl = layer.data("label", integer_value(num_classes))
    emb = layer.embedding(data, size=emb_size, name="bln_emb")
    t = networks.bidirectional_lstm(emb, size=hidden_size, name="bln_bilstm")
    out = layer.fc(t, size=num_classes, act=act.Softmax(), name="bln_out")
    cost = layer.classification_cost(out, lbl, name="bln_cost")
    err = layer.classification_error(out, lbl, name="bln_error")
    return ModelSpec("bidi_lstm_net", data, lbl, out, cost, err)
