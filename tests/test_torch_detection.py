"""Port parity: the SSD detection types and NCE of paddle_tpu_torch
against paddle_tpu on the CPU, at rtol 1e-4 / atol 1e-5 in float32.

The ops (``ops/detection.py``) take the same seeded numpy inputs in both
packages; the layers run through ``check_parity`` (one graph built by
both DSLs, one JAX init tar, outputs and the gradients of a seeded
projection against ``jax.grad``'s). The cases the port has to get right
on purpose: two ground-truth boxes sharing one best prior (the JAX
scatter's last writer, the higher gt index, wins), tied scores (the
lower index first, as ``lax.top_k`` and the stable ``argsort``), scores
under the confidence threshold, an image with no ground truth, and
``nce`` held on the JAX package's own noise draw. Then SSD300 narrow
(``chip_smoke.ssd300_net`` at 300 x 300 so every source map keeps its
size, channels / 16, batch 2) through the JSON both ways, with its
8,732 priors, its loss and its gradients; its detection_output on the
port's own head tensors in both packages, where rows whose scores lie
within 1e-6 of each other may swap (the two softmaxes differ in the
last bit), as phase 44 of ``chip_smoke.py`` allows on the card.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.layers import detection_layers as jdet_layers
from paddle_tpu.ops import detection as jdet
from paddle_tpu_torch.core.registry import ApplyContext, fold_seed
from paddle_tpu_torch.layers import cost_layers as tcost_layers
from paddle_tpu_torch.layers import detection_layers as tdet_layers
from paddle_tpu_torch.ops import detection as tdet

from chip_smoke import (SSD_PRIORS, SSD_SOURCES, SSD_VARIANCE,
                        detection_rows_match, ssd300_net, ssd_samples)
from torch_parity import (ATOL, RTOL, build_both, check_parity, feeds_of,
                          jax_nce_draws, submodule, table_of, use_draws)

MAPS = (38, 19, 10, 5, 3, 1)       # SSD300's source maps at 300 x 300


def _close(got, want, **kw):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=kw.get("rtol", RTOL), atol=kw.get("atol", ATOL))


@pytest.mark.parametrize("src", range(len(SSD_SOURCES)))
def test_prior_boxes_of_each_ssd300_map_match_jax(src):
    _, lo, hi, ratios = SSD_SOURCES[src]
    args = (MAPS[src], MAPS[src], 300, 300, [lo], [hi], list(ratios),
            list(SSD_VARIANCE))
    got = tdet.prior_boxes(*args)
    want = jdet.prior_boxes(*args)
    assert got.shape == want.shape == (MAPS[src] ** 2 * (2 + 2 * len(ratios)),
                                       8)
    _close(got, want)
    # clipped to [0, 1] always (the layer passes no clip)
    assert float(got[:, :4].min()) >= 0.0 and float(got[:, :4].max()) <= 1.0


def test_ssd300_prior_count():
    n = sum(m * m * (2 + 2 * len(r)) for m, (_, _, _, r) in
            zip(MAPS, SSD_SOURCES))
    assert n == SSD_PRIORS == 8732


def _priors():
    return tdet.prior_boxes(4, 4, 32, 32, [8.0], [16.0], [2.0],
                            list(SSD_VARIANCE))


def test_encode_decode_round_trip_and_parity():
    rng = np.random.RandomState(0)
    priors = _priors()
    P = priors.shape[0]
    lo = rng.uniform(0.0, 0.5, (P, 2))
    gt = np.concatenate([lo, lo + rng.uniform(0.05, 0.5, (P, 2))],
                        axis=1).astype(np.float32)
    enc = tdet.encode_boxes(torch.tensor(gt), priors)
    _close(enc, jdet.encode_boxes(jnp.asarray(gt), jnp.asarray(priors)))
    _close(tdet.decode_boxes(enc, priors), gt)
    # decode's values and gradients (exp clipped at +-10 included)
    loc = (rng.randn(2, P, 4) * 3.0).astype(np.float32)
    g = rng.randn(2, P, 4).astype(np.float32)
    tl = torch.tensor(loc, requires_grad=True)
    tout = tdet.decode_boxes(tl, priors)
    (tg,) = torch.autograd.grad(tout, tl, torch.tensor(g))
    jout, vjp = jax.vjp(lambda x: jdet.decode_boxes(x, jnp.asarray(priors)),
                        jnp.asarray(loc))
    _close(tout, jout)
    _close(tg, vjp(jnp.asarray(g))[0])


def _gt_batch(rng, counts, G, priors, shared=False):
    """[b, G, 4] boxes and [b, G] validity; ``shared`` plants in image 0
    two gts whose best prior is the same (gt 1 a shifted copy of gt 0)."""
    boxes = np.zeros((len(counts), G, 4), np.float32)
    for i, n in enumerate(counts):
        lo = rng.uniform(0.0, 0.6, (n, 2))
        boxes[i, :n] = np.concatenate(
            [lo, lo + rng.uniform(0.1, 0.4, (n, 2))], axis=1)
        boxes[i, n:] = rng.uniform(0.0, 1.0, (G - n, 4))   # padding junk
    if shared:
        p = np.asarray(priors[5, :4])
        boxes[0, 0] = p
        boxes[0, 1] = p + np.float32(0.01)
    valid = np.arange(G)[None, :] < np.asarray(counts)[:, None]
    return boxes, valid


@pytest.mark.parametrize("shared", [False, True],
                         ids=["padded_gts", "shared_best_prior"])
def test_match_priors_matches_jax(shared):
    rng = np.random.RandomState(1)
    priors = _priors()
    boxes, valid = _gt_batch(rng, [3, 0, 5, 1], 6, priors, shared)
    idx, iou = tdet.batched_match_priors(priors, torch.tensor(boxes),
                                         torch.tensor(valid))
    for i in range(len(boxes)):
        jidx, jiou = jdet.match_priors(jnp.asarray(priors),
                                       jnp.asarray(boxes[i]),
                                       jnp.asarray(valid[i]))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(jidx))
        _close(iou[i], jiou)
        one, one_iou = tdet.match_priors(priors, torch.tensor(boxes[i]),
                                         torch.tensor(valid[i]))
        assert torch.equal(one, idx[i]) and torch.equal(one_iou, iou[i])
    assert int((idx[1] >= 0).sum()) == 0           # no gt, no match
    if shared:
        # both gts' best prior is 5: the higher gt index claims it
        ious = tdet.iou_matrix(priors[:, :4], torch.tensor(boxes[0, :2]))
        assert ious.argmax(0).tolist() == [5, 5]
        assert int(idx[0, 5]) == 1


def _tied_scores():
    # ties above the threshold, a tie at it, and scores under it
    return np.array([0.5, 0.7, 0.7, 0.1, 0.7, 0.005, 0.01, 0.3, 0.3, 0.0,
                     0.009, 0.7], np.float32)


def test_nms_with_tied_and_low_scores_matches_jax():
    rng = np.random.RandomState(2)
    s = _tied_scores()
    N = s.shape[0]
    lo = rng.uniform(0.0, 0.4, (N, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.2, 0.6, (N, 2))],
                           axis=1).astype(np.float32)
    boxes[4] = boxes[1] + np.float32(0.01)       # suppressed by slot 1
    for top_k in (N, 5):
        want = jdet.nms(jnp.asarray(boxes), jnp.asarray(s), top_k=top_k)
        got = tdet.nms(torch.tensor(boxes), torch.tensor(s), top_k=top_k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # lax.top_k's order among ties: the lower index first
    cand, kept, _ = tdet.nms(torch.tensor(boxes), torch.tensor(s), top_k=4,
                             iou_threshold=1.0)
    np.testing.assert_array_equal(kept.numpy(), s[[1, 2, 4, 11]])
    np.testing.assert_array_equal(cand.numpy(), boxes[[1, 2, 4, 11]])
    # the batched form on several rows at once, each its own NMS
    scores = np.stack([s, s[::-1].copy(), rng.rand(N).astype(np.float32)])
    bb = np.stack([boxes, boxes[::-1].copy(), boxes])
    cand, sc, keep = tdet.batched_nms(torch.tensor(bb), torch.tensor(scores),
                                      top_k=7)
    for r in range(3):
        want = jdet.nms(jnp.asarray(bb[r]), jnp.asarray(scores[r]), top_k=7)
        for g, w in zip((cand[r], sc[r], keep[r]), want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _det_case(keep_top_k, nms_top_k, b=2, h=3, w=3, C=4, seed=3):
    """cfg and inputs of one detection_output (one source map, 3 priors
    a cell): conf logits built from a few integer rows, so many priors
    share exact scores, and one class whose scores sit under 0.01."""
    rng = np.random.RandomState(seed)
    pb = tdet.prior_boxes(h, w, 24, 24, [8.0], [], [2.0],
                          list(SSD_VARIANCE)).numpy()
    P = pb.shape[0]
    cfg = dict(input_num=1, num_classes=C, nms_threshold=0.45,
               nms_top_k=nms_top_k, keep_top_k=keep_top_k,
               confidence_threshold=0.01, background_id=0,
               _loc_shapes=[(3 * 4, h, w)], _conf_shapes=[(3 * C, h, w)])
    base = rng.randint(-2, 3, (4, C)).astype(np.float32)
    base[:, 3] = -12.0                          # class 3: under the threshold
    conf = base[rng.randint(0, 4, (b, P))].reshape(b, h, w, 3 * C)
    loc = (rng.randn(b, h, w, 3 * 4) * 0.5).astype(np.float32)
    pbs = np.broadcast_to(pb.reshape(1, -1), (b, P * 8)).copy()
    return cfg, [pbs, loc, conf]


@pytest.mark.parametrize("keep_top_k,nms_top_k", [(200, 400), (5, 6),
                                                  (12, 4)],
                         ids=["pad_rows", "keep_fewer", "nms_top_k_cut"])
def test_detection_output_with_tied_scores_matches_jax(keep_top_k,
                                                       nms_top_k):
    cfg, vals = _det_case(keep_top_k, nms_top_k)
    tin = [torch.tensor(v, requires_grad=i > 0) for i, v in enumerate(vals)]
    got = tdet_layers.DetectionOutputLayer.apply(
        ApplyContext("test", {}), "det", dict(cfg), {}, tin)
    jfn = (lambda loc, conf: jdet_layers.DetectionOutputLayer.apply(
        None, "det", dict(cfg), {}, [jnp.asarray(vals[0]), loc, conf]))
    want, vjp = jax.vjp(jfn, jnp.asarray(vals[1]), jnp.asarray(vals[2]))
    assert got.shape == want.shape == (2, keep_top_k * 7)
    rows = got.detach().numpy().reshape(2, keep_top_k, 7)
    jrows = np.asarray(want).reshape(2, keep_top_k, 7)
    np.testing.assert_array_equal(rows[..., :2], jrows[..., :2])
    np.testing.assert_allclose(rows[..., 2:], jrows[..., 2:], rtol=RTOL,
                               atol=ATOL)
    assert detection_rows_match(rows.reshape(2, -1), jrows.reshape(2, -1)) \
        == 0
    # the planted ties reach the output, and class 3 never does
    kept = rows[rows[..., 1] >= 0]
    assert len(np.unique(kept[:, 2])) < len(kept)
    assert 3.0 not in rows[..., 1]
    g = np.random.RandomState(4).randn(*want.shape).astype(np.float32)
    tg = torch.autograd.grad(got, tin[1:], torch.tensor(g))
    for a, w in zip(tg, vjp(jnp.asarray(g))):
        _close(a, w)


def test_detection_rows_match_counts_near_tie_swaps():
    cfg, vals = _det_case(12, 8)
    rows = tdet_layers.DetectionOutputLayer.apply(
        ApplyContext("test", {}), "det", dict(cfg), {},
        [torch.tensor(v) for v in vals]).numpy()
    r = rows.reshape(2, 12, 7)
    ties = [i for i in range(11) if r[0, i, 2] == r[0, i + 1, 2]
            and r[0, i, 1] >= 0 and
            not np.array_equal(r[0, i, 1:], r[0, i + 1, 1:])]
    assert ties
    swapped = r.copy()
    i = ties[0]
    swapped[0, [i, i + 1]] = swapped[0, [i + 1, i]]
    assert detection_rows_match(swapped.reshape(2, -1), rows) == 1
    bad = r.copy()
    bad[1, 0, 3] += 1e-3                     # a box moved
    with pytest.raises(AssertionError):
        detection_rows_match(bad.reshape(2, -1), rows)


def _pkg(L):
    """The package whose layer DSL ``L`` is."""
    return importlib.import_module(L.__name__.split(".")[0])


def _det_graph(L, classes=5, with_det=False):
    dt = submodule(L, "core.data_type")
    feat = L.data("feat", dt.dense_vector(8 * 4 * 4), height=4, width=4)
    img = L.data("img", dt.dense_vector(3 * 32 * 32), height=32, width=32)
    gt = L.data("gt", dt.dense_vector_sequence(6))
    ccn = L.cross_channel_norm(L.img_conv(feat, filter_size=1, num_filters=8,
                                          num_channels=8, name="c1"),
                               name="ccn")
    srcs = [ccn, L.img_conv(ccn, filter_size=3, num_filters=8, stride=2,
                            padding=1, name="c2")]
    locs, confs, pbs = [], [], []
    for i, s in enumerate(srcs):
        locs.append(L.img_conv(s, filter_size=3, padding=1,
                               num_filters=4 * 4, name=f"loc{i}"))
        confs.append(L.img_conv(s, filter_size=3, padding=1,
                                num_filters=4 * classes, name=f"conf{i}"))
        pbs.append(L.priorbox(s, img, aspect_ratio=[2.0],
                              variance=list(SSD_VARIANCE),
                              min_size=[6.0 + 8 * i], max_size=[14.0 + 8 * i],
                              name=f"pb{i}"))
    pb = L.concat(pbs, name="pb")
    outs = [L.multibox_loss(locs, confs, pb, gt, num_classes=classes,
                            name="mbloss")]
    if with_det:
        outs.append(L.detection_output(locs, confs, pb, num_classes=classes,
                                       keep_top_k=20, name="det"))
    return outs


def _det_samples(counts, classes=5, seed=5, shared=False):
    rng = np.random.RandomState(seed)
    out = []
    for n in counts:
        lo = rng.uniform(0.0, 0.6, (n, 2))
        rows = np.concatenate([rng.randint(1, classes, (n, 1)), lo,
                               lo + rng.uniform(0.1, 0.4, (n, 2)),
                               np.zeros((n, 1))], axis=1).astype(np.float32)
        if shared and n >= 2:
            rows[1, 1:5] = rows[0, 1:5] + np.float32(0.01)
        out.append((rng.randn(8 * 16).astype(np.float32),
                    rng.randn(3 * 32 * 32).astype(np.float32), rows))
    return out


@pytest.mark.parametrize("shared", [False, True],
                         ids=["ragged", "shared_best_prior"])
def test_multibox_loss_forward_and_gradients_match_jax(shared):
    """Ragged gt counts with an image that has none; the gradients of
    every head and of the cross_channel_norm scale."""
    jout, tout = check_parity(_det_graph,
                              _det_samples([3, 0, 7, 1], shared=shared))
    loss = tout["mbloss"].detach().numpy()
    assert loss.shape == (4, 1) and np.all(np.isfinite(loss))
    # the image with no gt has no positive and so no negative: loss 0
    assert loss[1, 0] == 0.0 and np.all(loss[[0, 2, 3], 0] > 0)


def test_multibox_loss_reads_labels_as_jax_does():
    """A negative label counts from the last class (JAX's take_along_axis
    wraps it); one out of range reads NaN, in both packages."""
    for lbl, nan in ((-2.7, False), (9.0, True)):
        samples = _det_samples([2, 1], seed=7)
        samples[0][2][0, 0] = lbl
        jout, tout = check_parity(_det_graph, samples, grads=not nan)
        assert bool(np.isnan(tout["mbloss"].detach().numpy()[0, 0])) == nan


def test_detection_graph_through_priors_and_heads_matches_jax():
    check_parity(lambda L: _det_graph(L, with_det=True), _det_samples([2, 4]))


def test_cross_channel_norm_matches_jax():
    def build(L):
        dt = submodule(L, "core.data_type")
        x = L.data("x", dt.dense_vector(6 * 5 * 3), height=5, width=3)
        c = L.img_conv(x, filter_size=3, padding=1, num_filters=6,
                       num_channels=6, name="c")
        n = L.cross_channel_norm(c, name="ccn")
        return [n, L.fc(n, size=4, name="fc")]

    rng = np.random.RandomState(6)
    jout, tout = check_parity(
        build, [(rng.randn(90).astype(np.float32),) for _ in range(3)])
    # the scale starts at 20, as SSD's
    jt, _ = build_both(build)
    assert np.all(table_of(jt)[0]["_ccn.w0"] == 20.0)


def _nce_graph(L):
    dt = submodule(L, "core.data_type")
    x = L.data("x", dt.dense_vector(12))
    lbl = L.data("lbl", dt.integer_value(50))
    h = L.fc(x, size=10, name="h")
    return [L.nce(h, lbl, num_classes=50, num_neg_samples=7, name="nce"),
            L.nce_layer(x, lbl, num_classes=50, name="nce2")]


def _nce_samples(n=6, seed=8):
    rng = np.random.RandomState(seed)
    return [(rng.randn(12).astype(np.float32), int(rng.randint(0, 50)))
            for _ in range(n)]


def test_nce_on_the_jax_draw_matches_jax(monkeypatch):
    jt, _ = build_both(_nce_graph)
    use_draws(monkeypatch, jax_nce_draws(jt, 6))
    check_parity(_nce_graph, _nce_samples())
    # the op on its own: a larger class count, values and gradients
    rng = np.random.RandomState(9)
    f, w = rng.randn(5, 16), rng.randn(1000, 16) * 0.1
    b, lab = rng.randn(1000) * 0.1, rng.randint(0, 1000, 5)
    ids = rng.randint(0, 1000, (5, 20))
    args = [a.astype(np.float32) for a in (f, w, b)]
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    from paddle_tpu.ops import cost as jcost
    from paddle_tpu_torch.ops import cost as tcost
    got = tcost.nce_loss(*targs, torch.tensor(lab), torch.tensor(ids), 1000)
    want, vjp = jax.vjp(lambda *a: jcost.nce_loss(
        *a, jnp.asarray(lab), jnp.asarray(ids), 1000),
        *[jnp.asarray(a) for a in args])
    _close(got, want)
    g = rng.randn(5).astype(np.float32)
    for a, ww in zip(torch.autograd.grad(got, targs, torch.tensor(g)),
                     vjp(jnp.asarray(g))):
        _close(a, ww)


def test_nce_draws_its_own_noise(monkeypatch):
    """The port's draw: ids in range, the same under one seed, other ids
    in another step, other ids for another layer; drawn in test mode
    too."""
    jt, tt = build_both(_nce_graph)
    seen = []
    draw = tcost_layers.nce_sample_ids

    def record(ctx, name, batch, k, num_classes, device):
        ids = draw(ctx, name, batch, k, num_classes, device)
        seen.append((name, ids))
        return ids

    monkeypatch.setattr(tcost_layers, "nce_sample_ids", record)
    _, tfeed = feeds_of(jt, tt, _nce_samples(64))
    _, raw = table_of(jt)

    def draws(rng, mode="train"):
        seen.clear()
        outs, _ = tt.forward(raw, tt.init_state(), tfeed, mode=mode, rng=rng)
        assert all(torch.isfinite(v).all() for v in outs.values())
        return dict(seen)

    a, b = draws(fold_seed(0, 1)), draws(fold_seed(0, 1))
    c, t = draws(fold_seed(0, 2)), draws(None, mode="test")
    assert a["nce"].shape == (64, 7) and a["nce2"].shape == (64, 10)
    for d in (a, c, t):
        for ids in d.values():
            assert ids.dtype == torch.int64
            assert int(ids.min()) >= 0 and int(ids.max()) < 50
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["nce"], c["nce"])
    assert not torch.equal(a["nce"], a["nce2"][:, :7])
    # a uniform draw over the 50 classes: all of them turn up
    assert len(torch.unique(torch.cat([a["nce"], a["nce2"]], 1))) == 50


def test_ssd300_small_through_the_json_both_ways():
    """SSD300 at 300 x 300 with channels / 16, batch 2: each package
    deserializes the other's JSON; 8,732 priors; the cost and its
    gradients held against JAX's; detection_output held on the heads."""
    jt0, tt0 = build_both(lambda L: ssd300_net(_pkg(L), width_div=16))
    jt = jpaddle.Topology.deserialize(tt0.serialize())
    tt = tpaddle.Topology.deserialize(jt0.serialize())
    assert json.loads(jt.serialize()) == json.loads(tt.serialize())
    pb = [l for l in tt.layers if l.type == "priorbox"]
    assert sum(l.meta.size for l in pb) // 8 == SSD_PRIORS
    assert [(l.parents[0].meta.height, l.config["_n_priors"]) for l in pb] \
        == [(m, 2 + 2 * len(s[3])) for m, s in zip(MAPS, SSD_SOURCES)]
    samples = ssd_samples(2, 300, 21, seed=0)
    table, raw = table_of(jt)
    jfeed, tfeed = feeds_of(jt, tt, samples)
    jparams = {k: jnp.asarray(v) for k, v in table.items()}

    def jloss(p):
        outs, _ = jt.forward(p, jt.init_state(), jfeed, mode="train",
                             output_names=["multibox_loss"])
        return jnp.sum(outs["multibox_loss"]), outs["multibox_loss"]

    (_, jcost), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = {k: v.clone().requires_grad_() for k, v in raw.items()}
    outs, _ = tt.forward(leaves, tt.init_state(), tfeed, mode="train",
                         output_names=["multibox_loss"])
    tcost = outs["multibox_loss"]
    _close(tcost, jcost)
    names = sorted(leaves)
    tg = torch.autograd.grad(tcost.sum(), [leaves[k] for k in names])
    for k, g in zip(names, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d/d{k}")
    # detection_output: the port's heads through both packages' layer
    heads = [l for l in tt.layers if l.name.endswith(("_loc", "_conf"))]
    with torch.no_grad():
        vals, _ = tt.forward(raw, tt.init_state(), tfeed, mode="test",
                             output_names=["priorbox", "detection_output"]
                             + [l.name for l in heads])
    det = tt.by_name["detection_output"]
    inputs = [vals[p.name].numpy() for p in det.parents]
    want = jdet_layers.DetectionOutputLayer.apply(
        None, det.name, dict(det.config), {}, [jnp.asarray(v)
                                               for v in inputs])
    got = vals["detection_output"].numpy()
    assert got.shape == (2, 200 * 7)
    # the two packages' softmax differ in the last bit: near-tied scores
    # (within 1e-6) may come in the other order, nothing else may differ
    detection_rows_match(got, np.asarray(want))
    assert np.all(got.reshape(2, 200, 7)[..., 1] >= 1)
