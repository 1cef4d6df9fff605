"""The transformer family — the port of
``paddle_tpu/models/transformer.py`` and of ``ModelSpec``
(``paddle_tpu/models/image.py``).

``transformer_lm``: pre-norm GPT-style blocks over learned token +
position embeddings,

    x = x + MHA(LN(x));  x = x + FFN(LN(x))

then a final layer norm, a bias-free vocabulary head emitting logits
(optionally tied to the token table) and next-token cross entropy
from logits. ``dropout > 0`` adds residual dropout after the attention
projection and after the FFN; ``moe_experts > 0`` swaps each FFN for a
top-``moe_k`` mixture of experts (layers/moe_layers.py) whose router
losses join the cross entropy as extra cost nodes.

``transformer_encoder`` (masked-LM) and ``transformer_classifier``
(mean-pooled class head) share one bidirectional trunk with the same
parameter names, so an MLM-pretrained table loads into the classifier.

The graphs, their layer names and their parameter names are the JAX
package's, so a topology serializes identically and a parameter table
moves between the packages (and into ``models/decode.py``) unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import layers as layer
from paddle_tpu_torch import pooling
from paddle_tpu_torch.core.data_type import (dense_vector_sequence,
                                             integer_value,
                                             integer_value_sequence)
from paddle_tpu_torch.core.registry import LayerOutput, ParamAttr


@dataclasses.dataclass
class ModelSpec:
    """A built model: feed via .data/.label, train on .cost.

    ``output`` is the inference head; for ``transformer_lm`` it is the
    probs side branch the cost graph skips, so inference topologies
    are built from ``output`` itself."""
    name: str
    data: LayerOutput
    label: LayerOutput
    output: LayerOutput
    cost: LayerOutput
    error: Optional[LayerOutput] = None

    def __post_init__(self):
        # tag the cost node(s) with the declared inference head so
        # Topology(spec.cost) warns when the head is a side branch
        costs = self.cost if isinstance(self.cost, (list, tuple)) \
            else [self.cost]
        for c in costs:
            c.declared_output = self.output.name

    @property
    def extra_layers(self):
        return [self.error] if self.error is not None else []


def transformer_lm(vocab_size: int = 32000, d_model: int = 512,
                   n_heads: int = 8, n_layers: int = 6,
                   d_ff: int = 2048, max_len: int = 2048,
                   moe_experts: int = 0, moe_k: int = 2,
                   moe_aux_coeff: float = 0.01,
                   moe_capacity_factor: float = 1.25,
                   dropout: float = 0.0, label_smoothing: float = 0.0,
                   tie_embeddings: bool = False, n_kv_heads=None,
                   name: str = "tfm") -> ModelSpec:
    """tokens + positions -> N pre-norm blocks -> next-token CE.

    Feed contract: (token_ids, position_ids, next_token_ids) — three
    integer sequences of equal length. ``dropout > 0`` adds residual
    dropout (train mode only). ``moe_experts > 0`` makes every FFN a
    top-``moe_k`` capacity-routed mixture of experts; ``spec.cost`` is
    then the list [cross entropy] + one ``moe_aux_cost`` a layer, which
    ``SGD`` takes as it is. ``n_kv_heads < n_heads`` is grouped-query
    attention; ``tie_embeddings`` shares the token table as the
    transposed head weight."""
    toks = layer.data(f"{name}_tokens", integer_value_sequence(vocab_size))
    pos = layer.data(f"{name}_positions", integer_value_sequence(max_len))
    nxt = layer.data(f"{name}_labels", integer_value_sequence(vocab_size))

    x = layer.addto([
        layer.embedding(toks, size=d_model, name=f"{name}_tok_emb"),
        layer.embedding(pos, size=d_model, name=f"{name}_pos_emb"),
    ], name=f"{name}_emb")
    aux_costs = []

    kv_h = n_kv_heads or n_heads
    kv_dim = (d_model // n_heads) * kv_h
    for i in range(n_layers):
        ln1 = layer.layer_norm(x, name=f"{name}_l{i}_ln1")
        q = layer.fc(ln1, size=d_model, bias_attr=False,
                     name=f"{name}_l{i}_q")
        k = layer.fc(ln1, size=kv_dim, bias_attr=False,
                     name=f"{name}_l{i}_k")
        v = layer.fc(ln1, size=kv_dim, bias_attr=False,
                     name=f"{name}_l{i}_v")
        attn = layer.dot_product_attention(q, k, v, num_heads=n_heads,
                                           num_kv_heads=n_kv_heads,
                                           causal=True,
                                           name=f"{name}_l{i}_attn")
        proj = layer.fc(attn, size=d_model, bias_attr=False,
                        name=f"{name}_l{i}_proj")
        if dropout > 0:
            proj = layer.dropout(proj, dropout, name=f"{name}_l{i}_drop1")
        x = layer.addto([x, proj], name=f"{name}_l{i}_res1")

        ln2 = layer.layer_norm(x, name=f"{name}_l{i}_ln2")
        if moe_experts > 0:
            ffn = layer.moe(ln2, expert_num=moe_experts,
                            expert_hidden=d_ff, k=moe_k,
                            capacity_factor=moe_capacity_factor,
                            name=f"{name}_l{i}_moe")
            aux_costs.append(layer.moe_aux_cost(
                ln2, ffn, coeff=moe_aux_coeff, name=f"{name}_l{i}_aux"))
        else:
            up = layer.fc(ln2, size=d_ff, act=act.Relu(),
                          name=f"{name}_l{i}_up")
            ffn = layer.fc(up, size=d_model, bias_attr=False,
                           name=f"{name}_l{i}_down")
        if dropout > 0:
            ffn = layer.dropout(ffn, dropout, name=f"{name}_l{i}_drop2")
        x = layer.addto([x, ffn], name=f"{name}_l{i}_res2")

    xf = layer.layer_norm(x, name=f"{name}_lnf")
    # logits out of the head, CE from logits; the softmax probs are a
    # paramless side branch the cost graph does not contain
    head_attr = ParamAttr(name=f"_{name}_tok_emb.w0") \
        if tie_embeddings else None
    logits = layer.fc(xf, size=vocab_size, act=None, bias_attr=False,
                      param_attr=head_attr, tied_transpose=tie_embeddings,
                      name=f"{name}_head")
    probs = layer.addto([logits], act=act.Softmax(), name=f"{name}_probs")
    cost = layer.cross_entropy_cost(logits, nxt, from_logits=True,
                                    label_smoothing=label_smoothing,
                                    name=f"{name}_cost")
    spec = ModelSpec(name="transformer_lm", data=toks, label=nxt,
                     output=probs,
                     cost=[cost] + aux_costs if aux_costs else cost)
    spec.positions = pos
    return spec


def _encoder_trunk(toks, pos, *, name, d_model, n_heads, n_layers, d_ff,
                   dropout):
    """Embeddings + N bidirectional pre-norm blocks + final layer norm —
    shared by the MLM encoder and the sequence classifier."""
    x = layer.addto([
        layer.embedding(toks, size=d_model, name=f"{name}_tok_emb"),
        layer.embedding(pos, size=d_model, name=f"{name}_pos_emb"),
    ], name=f"{name}_emb")
    for i in range(n_layers):
        ln1 = layer.layer_norm(x, name=f"{name}_l{i}_ln1")
        q = layer.fc(ln1, size=d_model, bias_attr=False,
                     name=f"{name}_l{i}_q")
        k = layer.fc(ln1, size=d_model, bias_attr=False,
                     name=f"{name}_l{i}_k")
        v = layer.fc(ln1, size=d_model, bias_attr=False,
                     name=f"{name}_l{i}_v")
        attn = layer.dot_product_attention(q, k, v, num_heads=n_heads,
                                           causal=False,
                                           name=f"{name}_l{i}_attn")
        proj = layer.fc(attn, size=d_model, bias_attr=False,
                        name=f"{name}_l{i}_proj")
        if dropout > 0:
            proj = layer.dropout(proj, dropout, name=f"{name}_l{i}_drop1")
        x = layer.addto([x, proj], name=f"{name}_l{i}_res1")

        ln2 = layer.layer_norm(x, name=f"{name}_l{i}_ln2")
        up = layer.fc(ln2, size=d_ff, act=act.Relu(),
                      name=f"{name}_l{i}_up")
        ffn = layer.fc(up, size=d_model, bias_attr=False,
                       name=f"{name}_l{i}_down")
        if dropout > 0:
            ffn = layer.dropout(ffn, dropout, name=f"{name}_l{i}_drop2")
        x = layer.addto([x, ffn], name=f"{name}_l{i}_res2")
    return layer.layer_norm(x, name=f"{name}_lnf")


def transformer_classifier(vocab_size: int = 32000, num_classes: int = 2,
                           d_model: int = 512, n_heads: int = 8,
                           n_layers: int = 6, d_ff: int = 2048,
                           max_len: int = 512, dropout: float = 0.0,
                           name: str = "enc") -> ModelSpec:
    """Sequence classification over the bidirectional trunk: mean-pool
    the final hidden states over valid positions, project to
    ``num_classes``. The default name is ``transformer_encoder``'s, so
    the trunk's parameter names are identical and an MLM-pretrained
    table loads by name (the head is fresh)."""
    toks = layer.data(f"{name}_tokens", integer_value_sequence(vocab_size))
    pos = layer.data(f"{name}_positions", integer_value_sequence(max_len))
    lbl = layer.data(f"{name}_label", integer_value(num_classes))
    xf = _encoder_trunk(toks, pos, name=name, d_model=d_model,
                        n_heads=n_heads, n_layers=n_layers, d_ff=d_ff,
                        dropout=dropout)
    pooled = layer.pooling(xf, pooling_type=pooling.Avg(),
                           name=f"{name}_pool")
    out = layer.fc(pooled, size=num_classes, act=act.Softmax(),
                   name=f"{name}_out")
    cost = layer.classification_cost(out, lbl, name=f"{name}_cost")
    err = layer.classification_error(out, lbl, name=f"{name}_error")
    spec = ModelSpec(name="transformer_classifier", data=toks, label=lbl,
                     output=out, cost=cost, error=err)
    spec.positions = pos
    return spec


def transformer_encoder(vocab_size: int = 32000, d_model: int = 512,
                        n_heads: int = 8, n_layers: int = 6,
                        d_ff: int = 2048, max_len: int = 512,
                        dropout: float = 0.0,
                        name: str = "enc") -> ModelSpec:
    """Bidirectional encoder on the masked-LM objective: the LM's
    pre-norm blocks with causal=False attention.

    Feed contract: (masked_ids, position_ids, label_ids, mlm_weight) —
    three integer sequences and a float sequence that is 1.0 exactly on
    the masked positions; the cross entropy over the vocabulary logits
    is weighted PER TOKEN by it. The data pipeline picks the mask.
    ``spec.output`` is the probs side branch, as for the LM."""
    toks = layer.data(f"{name}_tokens", integer_value_sequence(vocab_size))
    pos = layer.data(f"{name}_positions", integer_value_sequence(max_len))
    lbls = layer.data(f"{name}_labels", integer_value_sequence(vocab_size))
    mlm_w = layer.data(f"{name}_mlm_weight", dense_vector_sequence(1))

    xf = _encoder_trunk(toks, pos, name=name, d_model=d_model,
                        n_heads=n_heads, n_layers=n_layers, d_ff=d_ff,
                        dropout=dropout)
    logits = layer.fc(xf, size=vocab_size, act=None, bias_attr=False,
                      name=f"{name}_head")
    probs = layer.addto([logits], act=act.Softmax(), name=f"{name}_probs")
    cost = layer.cross_entropy_cost(logits, lbls, weight=mlm_w,
                                    from_logits=True,
                                    name=f"{name}_cost")
    spec = ModelSpec(name="transformer_encoder", data=toks, label=lbls,
                     output=probs, cost=cost)
    spec.positions = pos
    spec.mlm_weight = mlm_w
    return spec
