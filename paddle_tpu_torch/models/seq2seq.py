"""Attention seq2seq NMT — the port of ``paddle_tpu/models/seq2seq.py``:
a bidirectional GRU encoder and a decoder that runs ``recurrent_group``
with ``gru_step`` and ``simple_attention`` (training, teacher-forced)
or ``beam_search`` (generation). The ``ParamAttr`` names are fixed, so
the training and generation graphs share their weights."""

from __future__ import annotations

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import layers as layer
from paddle_tpu_torch import networks
from paddle_tpu_torch.core.data_type import integer_value_sequence
from paddle_tpu_torch.core.registry import LayerOutput, ParamAttr
from paddle_tpu_torch.models.transformer import ModelSpec


def _encoder(src_ids: LayerOutput, vocab: int, emb_size: int, enc_size: int,
             name: str = "enc"):
    emb = layer.embedding(src_ids, size=emb_size, name=f"{name}_emb",
                          param_attr=ParamAttr(name=f"_{name}_emb_w"))
    fwd = networks.simple_gru(emb, size=enc_size, name=f"{name}_fw")
    bwd = networks.simple_gru(emb, size=enc_size, name=f"{name}_bw",
                              reverse=True)
    enc = layer.concat([fwd, bwd], name=f"{name}_concat")       # [b,T,2h]
    proj = layer.fc(enc, size=enc_size, act=None, bias_attr=False,
                    name=f"{name}_proj", param_attr=ParamAttr(
                        name=f"_{name}_proj_w"))
    boot = layer.fc(layer.first_seq(bwd, name=f"{name}_bwd_first"),
                    size=enc_size, act=act.Tanh(), name=f"{name}_boot",
                    param_attr=ParamAttr(name=f"_{name}_boot_w"))
    return enc, proj, boot


def _decoder_step_factory(dec_size: int, trg_vocab: int, name: str = "dec",
                          boot=None):
    """step(cur_emb, enc_seq, enc_proj) for recurrent_group and
    beam_search, with fixed parameter names."""

    def step(cur_emb, enc_seq, enc_proj):
        mem = layer.memory(name=f"{name}_state", size=dec_size,
                           boot_layer=boot)
        context = networks.simple_attention(
            encoded_sequence=enc_seq, encoded_proj=enc_proj,
            decoder_state=mem, name=f"{name}_attn",
            softmax_param_attr=ParamAttr(name=f"_{name}_attn_w"))
        # only the input projection feeds gru_step: gru_step owns the
        # recurrent (h, 3h) product itself
        inputs = layer.fc(layer.concat([context, cur_emb],
                                       name=f"{name}_in_concat"),
                          size=dec_size * 3, act=None, bias_attr=False,
                          name=f"{name}_in_proj",
                          param_attr=ParamAttr(name=f"_{name}_inproj_w"))
        nxt = layer.gru_step(inputs, output_mem=mem, size=dec_size,
                             name=f"{name}_state",
                             param_attr=ParamAttr(name=f"_{name}_gru_w"),
                             bias_attr=ParamAttr(name=f"_{name}_gru_b"))
        return layer.fc(nxt, size=trg_vocab, act=act.Softmax(),
                        name=f"{name}_prob",
                        param_attr=ParamAttr(name=f"_{name}_out_w"),
                        bias_attr=ParamAttr(name=f"_{name}_out_b"))
    return step


def nmt_attention(src_vocab: int = 30000, trg_vocab: int = 30000,
                  emb_size: int = 512, enc_size: int = 512,
                  dec_size: int = 512) -> ModelSpec:
    """Training graph: the decoder teacher-forced over the target."""
    src = layer.data("source_words", integer_value_sequence(src_vocab))
    trg = layer.data("target_words", integer_value_sequence(trg_vocab))
    trg_next = layer.data("target_next_words",
                          integer_value_sequence(trg_vocab))
    enc, proj, boot = _encoder(src, src_vocab, emb_size, enc_size)

    trg_emb = layer.embedding(trg, size=emb_size, name="dec_emb",
                              param_attr=ParamAttr(name="_dec_emb_w"))
    step = _decoder_step_factory(dec_size, trg_vocab, boot=boot)

    def group_step(cur_emb, enc_seq, enc_proj):
        return step(cur_emb, enc_seq, enc_proj)

    probs = layer.recurrent_group(
        step=group_step,
        input=[trg_emb,
               layer.StaticInput(enc, is_seq=True),
               layer.StaticInput(proj, is_seq=True)],
        name="decoder_group")
    cost = layer.classification_cost(probs, trg_next, name="nmt_cost")
    err = layer.classification_error(probs, trg_next, name="nmt_error")
    return ModelSpec("nmt_attention", src, trg_next, probs, cost, err)


def nmt_generator(src_vocab: int = 30000, trg_vocab: int = 30000,
                  emb_size: int = 512, enc_size: int = 512,
                  dec_size: int = 512, bos_id: int = 0, eos_id: int = 1,
                  beam_size: int = 4, max_length: int = 50) -> LayerOutput:
    """Generation graph: beam search sharing the training parameters."""
    src = layer.data("source_words", integer_value_sequence(src_vocab))
    enc, proj, boot = _encoder(src, src_vocab, emb_size, enc_size)
    step = _decoder_step_factory(dec_size, trg_vocab, boot=boot)

    def gen_step(cur_ids, enc_seq, enc_proj):
        cur_emb = layer.embedding(cur_ids, size=emb_size, name="dec_emb_gen",
                                  param_attr=ParamAttr(name="_dec_emb_w"))
        return step(cur_emb, enc_seq, enc_proj)

    return layer.beam_search(
        step=gen_step,
        input=[layer.GeneratedInput(size=trg_vocab,
                                    embedding_name="_dec_emb_w",
                                    embedding_size=emb_size),
               layer.StaticInput(enc, is_seq=True),
               layer.StaticInput(proj, is_seq=True)],
        bos_id=bos_id, eos_id=eos_id, beam_size=beam_size,
        max_length=max_length, name="nmt_beam")
