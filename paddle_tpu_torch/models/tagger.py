"""CRF sequence tagging — the port of ``paddle_tpu/models/tagger.py``:
``crf_tagger`` (context-window emissions) and ``rnn_crf_tagger``.

In ``rnn_crf_tagger`` emissions come from a forward and a reverse
``simple_gru``; the CRF cost trains and ``crf_decoding`` decodes with
one shared transition parameter. The forward GRU runs the fused kernel
when no gradient is taken (decoding through ``infer``); training runs
the plain scans. ``crf_tagger`` computes its emissions with a context
projection and two fcs, and shares its transitions the same way.
"""

from __future__ import annotations

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import layers as layer
from paddle_tpu_torch import networks
from paddle_tpu_torch.core.data_type import integer_value_sequence
from paddle_tpu_torch.core.registry import ParamAttr
from paddle_tpu_torch.models.transformer import ModelSpec


def crf_tagger(vocab_size: int = 20000, num_labels: int = 45,
               emb_size: int = 128, hidden_size: int = 256,
               context_len: int = 5) -> ModelSpec:
    """Feed contract: (word ids sequence, label ids sequence);
    ``spec.decoded`` is the Viterbi path."""
    words = layer.data("words", integer_value_sequence(vocab_size))
    labels = layer.data("labels", integer_value_sequence(num_labels))
    emb = layer.embedding(words, size=emb_size, name="crf_emb")
    ctx = layer.context_projection(emb, context_len=context_len,
                                   name="crf_ctx")
    hidden = layer.fc(ctx, size=hidden_size, act=act.Tanh(), name="crf_h")
    emission = layer.fc(hidden, size=num_labels, act=None,
                        name="crf_emission")
    crf_w = ParamAttr(name="_crf_trans_w")
    cost = layer.crf(emission, labels, size=num_labels, name="crf_cost",
                     param_attr=crf_w)
    decoded = layer.crf_decoding(emission, size=num_labels,
                                 name="crf_decode", param_attr=crf_w)
    spec = ModelSpec("crf_tagger", words, labels, emission, cost, None)
    spec.decoded = decoded
    return spec


def rnn_crf_tagger(vocab_size: int = 20000, num_labels: int = 45,
                   emb_size: int = 128, hidden_size: int = 128) -> ModelSpec:
    """Feed contract: (word ids sequence, label ids sequence);
    ``spec.decoded`` is the Viterbi path."""
    words = layer.data("words", integer_value_sequence(vocab_size))
    labels = layer.data("labels", integer_value_sequence(num_labels))
    emb = layer.embedding(words, size=emb_size, name="rcrf_emb")
    fwd = networks.simple_gru(emb, size=hidden_size, name="rcrf_fw")
    bwd = networks.simple_gru(emb, size=hidden_size, name="rcrf_bw",
                              reverse=True)
    merged = layer.concat([fwd, bwd], name="rcrf_concat")
    emission = layer.fc(merged, size=num_labels, act=None,
                        name="rcrf_emission")
    crf_w = ParamAttr(name="_rcrf_trans_w")
    cost = layer.crf(emission, labels, size=num_labels, name="rcrf_cost",
                     param_attr=crf_w)
    decoded = layer.crf_decoding(emission, size=num_labels,
                                 name="rcrf_decode", param_attr=crf_w)
    spec = ModelSpec("rnn_crf_tagger", words, labels, emission, cost, None)
    spec.decoded = decoded
    return spec
