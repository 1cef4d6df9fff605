"""Text models — the port of ``paddle_tpu/models/text.py``: the IMDB
classifiers ``stacked_lstm_net``, ``bidi_lstm_net`` and the quick-start
text CNN ``convolution_net``, and the N-gram language model
``ngram_lm``.

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
from paddle_tpu_torch.core.registry import ParamAttr
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


def convolution_net(vocab_size: int = 30000, emb_size: int = 128,
                    hidden_size: int = 128, num_classes: int = 2) -> ModelSpec:
    """The quick-start text CNN: two context-window conv-pools (windows 3
    and 4), concat, softmax fc."""
    data = layer.data("word", integer_value_sequence(vocab_size))
    lbl = layer.data("label", integer_value(num_classes))
    emb = layer.embedding(data, size=emb_size, name="cn_emb")
    conv3 = networks.sequence_conv_pool(emb, context_len=3,
                                        hidden_size=hidden_size,
                                        name="cn_conv3")
    conv4 = networks.sequence_conv_pool(emb, context_len=4,
                                        hidden_size=hidden_size,
                                        name="cn_conv4")
    merged = layer.concat([conv3, conv4], name="cn_concat")
    out = layer.fc(merged, size=num_classes, act=act.Softmax(), name="cn_out")
    cost = layer.classification_cost(out, lbl, name="cn_cost")
    err = layer.classification_error(out, lbl, name="cn_error")
    return ModelSpec("convolution_net", data, lbl, out, cost, err)


def ngram_lm(vocab_size: int = 2000, emb_size: int = 32,
             hidden_size: int = 256, context: int = 4) -> ModelSpec:
    """The imikolov N-gram LM: ``context`` words (data layers w0..,
    one shared embedding table) -> concat -> relu fc -> softmax over
    the next word; ``spec.words`` lists the word inputs."""
    words = [layer.data(f"w{i}", integer_value(vocab_size))
             for i in range(context)]
    nxt = layer.data("next_word", integer_value(vocab_size))
    embs = [layer.embedding(w, size=emb_size, name=f"lm_emb{i}",
                            param_attr=ParamAttr(name="lm_emb_shared"))
            for i, w in enumerate(words)]
    ctx = layer.concat(embs, name="lm_concat")
    h = layer.fc(ctx, size=hidden_size, act=act.Relu(), name="lm_h")
    out = layer.fc(h, size=vocab_size, act=act.Softmax(), name="lm_out")
    cost = layer.classification_cost(out, nxt, name="lm_cost")
    err = layer.classification_error(out, nxt, name="lm_error")
    spec = ModelSpec("ngram_lm", words[0], nxt, out, cost, err)
    spec.words = words
    return spec
