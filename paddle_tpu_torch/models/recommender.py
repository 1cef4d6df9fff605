"""The recommenders — the port of ``paddle_tpu/models/recommender.py``:
Wide&Deep CTR over large row-sparse embedding tables (BASELINE.json's
"Wide&Deep CTR with high-dim sparse embeddings") and the MovieLens
rating regression of demo/recommendation.

The tables are ``ParamAttr(sparse=True)``: the trainer prefetches the
touched rows of each batch and updates only those
(``Topology.sparse_tables``, ``SGD``'s sparse step). The graph and its
parameter names are the JAX package's, so the two packages exchange
weight tars.
"""

from __future__ import annotations

from typing import Sequence

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import layers as layer
from paddle_tpu_torch.core.data_type import dense_vector, integer_value
from paddle_tpu_torch.core.registry import ParamAttr
from paddle_tpu_torch.models.transformer import ModelSpec


def wide_and_deep(sparse_dims: Sequence[int] = (100000, 100000, 10000),
                  dense_dim: int = 13, emb_size: int = 64,
                  hidden_sizes: Sequence[int] = (256, 128, 64)) -> ModelSpec:
    """Wide (linear over sparse ids) + Deep (embeddings -> MLP) CTR net."""
    dense = layer.data("dense_features", dense_vector(dense_dim))
    sparse_inputs = [layer.data(f"sparse_{i}", integer_value(dim))
                     for i, dim in enumerate(sparse_dims)]
    lbl = layer.data("label", integer_value(2))

    # deep: one embedding table per sparse slot
    embs = [layer.embedding(s, size=emb_size, name=f"wd_emb{i}",
                            param_attr=ParamAttr(name=f"_wd_emb{i}_w",
                                                 sparse=True))
            for i, s in enumerate(sparse_inputs)]
    deep = layer.concat(embs + [dense], name="wd_deep_concat")
    for j, h in enumerate(hidden_sizes):
        deep = layer.fc(deep, size=h, act=act.Relu(), name=f"wd_deep_fc{j}")

    # wide: direct 1-dim "linear" embeddings of the ids + dense passthrough
    wides = [layer.embedding(s, size=1, name=f"wd_wide{i}",
                             param_attr=ParamAttr(name=f"_wd_wide{i}_w",
                                                  sparse=True))
             for i, s in enumerate(sparse_inputs)]
    wide = layer.concat(wides + [dense], name="wd_wide_concat")

    merged = layer.concat([wide, deep], name="wd_merge")
    out = layer.fc(merged, size=2, act=act.Softmax(), name="wd_out")
    cost = layer.classification_cost(out, lbl, name="wd_cost")
    err = layer.classification_error(out, lbl, name="wd_error")
    spec = ModelSpec("wide_and_deep", dense, lbl, out, cost, err)
    spec.sparse_inputs = sparse_inputs
    return spec


def movielens_regression(user_dim: int = 6040, movie_dim: int = 3952,
                         emb_size: int = 64) -> ModelSpec:
    """MovieLens rating regression (demo/recommendation parity): user and
    movie towers -> cos_sim scaled to [0, 5]."""
    uid = layer.data("user_id", integer_value(user_dim))
    mid = layer.data("movie_id", integer_value(movie_dim))
    score = layer.data("score", dense_vector(1))
    uvec = layer.fc(layer.embedding(uid, size=emb_size, name="ml_uemb"),
                    size=emb_size, act=act.Relu(), name="ml_ufc")
    mvec = layer.fc(layer.embedding(mid, size=emb_size, name="ml_memb"),
                    size=emb_size, act=act.Relu(), name="ml_mfc")
    sim = layer.cos_sim(uvec, mvec, scale=5.0, name="ml_sim")
    cost = layer.square_error_cost(sim, score, name="ml_cost")
    return ModelSpec("movielens_regression", uid, score, sim, cost, None)
