"""Port parity: the bidirectional encoder family and residual dropout of
paddle_tpu_torch/models/transformer.py against paddle_tpu on the CPU, at
a small size (vocab 53, d 16, 2 heads, 2 layers, ragged T up to 12).

- ``transformer_encoder``'s per-token-weighted MLM cost and
  ``transformer_classifier``'s cost and error: the same JSON, and from
  one weight table the outputs and gradients equal JAX's at rtol 1e-4 /
  atol 1e-5 (``check_parity``).
- The two specs share the trunk's parameter names, in both packages.
- ``transformer_lm(dropout=0.1)``: test mode equals JAX (the dropout
  layers are the identity there), a rate-0 dropout layer is the
  identity in train mode, forward and gradients; in a train step the
  mask keeps about 1 - p of the entries and scales them by 1 / (1 - p)
  (the draws cannot match JAX's).
- chip_smoke.py's copy of demo/masked_lm/train.py in both packages, the
  port from the JAX run's init tars: the first MLM and fine-tune costs
  at rtol 1e-4, and the same count of loaded trunk parameters.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.core.registry import reset_name_counters as jreset
from paddle_tpu.models import transformer as jtf
from paddle_tpu_torch.core.registry import reset_name_counters as treset
from paddle_tpu_torch.models import transformer as ttf
from tests.torch_parity import RTOL, build_both, check_parity, submodule

SIZE = dict(vocab_size=53, d_model=16, n_heads=2, n_layers=2, d_ff=32,
            max_len=12)
LENGTHS = (12, 5, 9)


def _models(L):
    return jtf if L is jpaddle.layer else ttf


def _mlm_samples(seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for n in LENGTHS:
        ids = rng.randint(1, SIZE["vocab_size"], (n,)).astype(np.int32)
        mask = rng.rand(n) < 0.3
        mask[0] = True
        out.append((np.where(mask, 0, ids).astype(np.int32),
                    np.arange(n, dtype=np.int32), ids,
                    mask.astype(np.float32)[:, None]))
    return out


def test_encoder_mlm_cost_and_gradients_match_jax():
    jout, _ = check_parity(
        lambda L: _models(L).transformer_encoder(**SIZE).cost,
        _mlm_samples(), mode="train")
    assert np.all(np.isfinite(np.asarray(jout["enc_cost"])))


def test_classifier_cost_and_gradients_match_jax():
    rng = np.random.RandomState(1)
    samples = [(rng.randint(0, SIZE["vocab_size"], (n,)).astype(np.int32),
                np.arange(n, dtype=np.int32), int(rng.randint(0, 3)))
               for n in LENGTHS]

    def build(L):
        spec = _models(L).transformer_classifier(num_classes=3, **SIZE)
        return [spec.cost, spec.error]

    check_parity(build, samples, mode="train")


def test_trunk_names_match_across_the_two_specs():
    for L in (jpaddle.layer, tpaddle.layer):
        topo = (jpaddle if L is jpaddle.layer else tpaddle).Topology
        (jreset if L is jpaddle.layer else treset)()
        enc = topo(_models(L).transformer_encoder(**SIZE).cost)
        (jreset if L is jpaddle.layer else treset)()
        cls = topo(_models(L).transformer_classifier(num_classes=3,
                                                     **SIZE).cost)
        shared = set(enc.param_specs) & set(cls.param_specs)
        assert set(enc.param_specs) - shared == {"_enc_head.w0"}
        assert set(cls.param_specs) - shared == {"_enc_out.w0",
                                                 "_enc_out.wbias"}
        assert len(shared) == 2 + 11 * SIZE["n_layers"] + 2
    jt, tt = build_both(
        lambda L: _models(L).transformer_classifier(num_classes=3,
                                                    **SIZE).cost)
    assert sorted(tt.param_specs) == sorted(jt.param_specs)


def _lm_samples(seed=2):
    rng = np.random.RandomState(seed)
    out = []
    for n in LENGTHS:
        ids = rng.randint(0, SIZE["vocab_size"], (n + 1,)).astype(np.int32)
        out.append((ids[:-1], np.arange(n, dtype=np.int32), ids[1:]))
    return out


def test_dropout_lm_test_mode_matches_jax():
    """Test mode: the dropout layers pass their input through, so the
    LM's cost equals JAX's; the graph (with its drop1 / drop2 layers)
    serializes the same."""
    def build(L):
        return _models(L).transformer_lm(dropout=0.1, **SIZE).cost

    jt, _ = build_both(build)
    assert sum(l.type == "dropout" for l in jt.layers) == \
        2 * SIZE["n_layers"]
    check_parity(build, _lm_samples(), mode="test", grads=False)


def test_rate_zero_dropout_is_the_identity_in_train_mode():
    def build(L):
        dt = submodule(L, "core.data_type")
        x = L.data("x", dt.dense_vector_sequence(6))
        h = L.fc(x, size=5, name="h")
        return L.dropout(h, 0.0, name="drop")

    rng = np.random.RandomState(3)
    check_parity(build, [(rng.randn(n, 6).astype(np.float32),)
                         for n in LENGTHS], mode="train")


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_train_mode_statistics(p):
    """One train-mode forward of the LM with dropout p: at each
    residual dropout the kept share is within 5 sigma of 1 - p, every
    kept entry is its input times 1 / (1 - p), the draws differ across
    layers and steps and repeat for the same step seed."""
    treset()
    spec = ttf.transformer_lm(dropout=p, **{**SIZE, "d_model": 64,
                                            "d_ff": 64})
    topo = tpaddle.Topology(spec.cost)
    params = topo.init_params(torch.Generator().manual_seed(0))
    feed = tpaddle.trainer.DataFeeder(topo.data_type(), device="cpu")(
        _lm_samples() * 8)
    feed.pop("__batch_size__")
    names = [f"tfm_l{i}_{w}" for i in range(SIZE["n_layers"])
             for w in ("proj", "drop1", "drop2")]

    def run(rng):
        with torch.no_grad():
            outs, _ = topo.forward(params, {}, feed, mode="train", rng=rng,
                                   output_names=names)
        return outs

    outs = run(5)
    masks = []
    for i in range(SIZE["n_layers"]):
        x = outs[f"tfm_l{i}_proj"].data
        y = outs[f"tfm_l{i}_drop1"].data
        kept = y != 0
        n = kept.numel()
        share = kept.float().mean().item()
        assert abs(share - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n), share
        torch.testing.assert_close(y[kept], x[kept] / (1 - p), rtol=1e-6,
                                   atol=0)
        masks.append(kept)
        masks.append(outs[f"tfm_l{i}_drop2"].data != 0)
    assert not torch.equal(masks[0], masks[2])      # layers differ
    assert not torch.equal(masks[0], masks[1])      # drop1 vs drop2
    again = run(5)
    assert torch.equal(again["tfm_l0_drop1"].data != 0, masks[0])
    assert not torch.equal(run(6)["tfm_l0_drop1"].data != 0, masks[0])


def test_masked_lm_script_tracks_jax():
    """chip_smoke.masked_lm_demo, the copy of demo/masked_lm/train.py
    with only its imports changed, in both packages on the CPU, one pass
    of each phase (its reader draws every batch from one shared
    generator, and the JAX trainer prefetches ahead, so a cut pass would
    feed the packages different data); the port starts from the JAX
    run's encoder and classifier init tars. The first 4 MLM costs and
    the first 4 fine-tune costs at rtol 1e-4; the same loaded trunk
    count."""
    import chip_smoke
    from paddle_tpu_torch import config as tconfig

    def quiet(_):
        pass

    j = chip_smoke.masked_lm_demo(jpaddle, use_tpu=False, pretrain_passes=1,
                                  finetune_passes=1, echo=quiet)
    try:
        t = chip_smoke.masked_lm_demo(tpaddle, use_tpu=False,
                                      pretrain_passes=1, finetune_passes=1,
                                      init_tars=j["init_tars"], echo=quiet)
    finally:
        tconfig.init(seed=0)
    assert t["trainer"].device.type == "cpu"
    assert t["loaded"] == j["loaded"] == 2 + 11 * 2 + 2
    assert len(t["mlm_losses"]) == len(j["mlm_losses"]) == 20
    np.testing.assert_allclose(t["mlm_losses"][:4], j["mlm_losses"][:4],
                               rtol=RTOL)
    np.testing.assert_allclose([c for c, _ in t["cls_metrics"][:4]],
                               [c for c, _ in j["cls_metrics"][:4]],
                               rtol=RTOL)
