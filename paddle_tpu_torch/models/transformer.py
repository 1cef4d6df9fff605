"""Decoder-only transformer language model — the port of
``transformer_lm`` (``paddle_tpu/models/transformer.py``) and of
``ModelSpec`` (``paddle_tpu/models/image.py``).

Pre-norm GPT-style blocks over learned token + position embeddings:

    x = x + MHA(LN(x));  x = x + FFN(LN(x))

then a final layer norm, a bias-free vocabulary head emitting logits
(optionally tied to the token table) and next-token cross entropy
from logits. The graph, its layer names and its parameter names are
the JAX package's, so a topology serializes identically and a
parameter table moves between the packages (and into
``models/decode.py``) unchanged. The MoE feed-forward and residual
dropout are not in this slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import layers as layer
from paddle_tpu_torch.core.data_type import integer_value_sequence
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
    integer sequences of equal length. ``n_kv_heads < n_heads`` is
    grouped-query attention; ``tie_embeddings`` shares the token table
    as the transposed head weight."""
    if moe_experts > 0:
        raise NotImplementedError("the MoE feed-forward (moe_experts > 0) "
                                  "is not ported yet (ROADMAP.md queue A)")
    if dropout > 0:
        raise NotImplementedError("residual dropout (dropout > 0) is not "
                                  "ported yet (ROADMAP.md queue A)")
    toks = layer.data(f"{name}_tokens", integer_value_sequence(vocab_size))
    pos = layer.data(f"{name}_positions", integer_value_sequence(max_len))
    nxt = layer.data(f"{name}_labels", integer_value_sequence(vocab_size))

    x = layer.addto([
        layer.embedding(toks, size=d_model, name=f"{name}_tok_emb"),
        layer.embedding(pos, size=d_model, name=f"{name}_pos_emb"),
    ], name=f"{name}_emb")

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
        x = layer.addto([x, proj], name=f"{name}_l{i}_res1")

        ln2 = layer.layer_norm(x, name=f"{name}_l{i}_ln2")
        up = layer.fc(ln2, size=d_ff, act=act.Relu(),
                      name=f"{name}_l{i}_up")
        ffn = layer.fc(up, size=d_model, bias_attr=False,
                       name=f"{name}_l{i}_down")
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
                     output=probs, cost=cost)
    spec.positions = pos
    return spec
