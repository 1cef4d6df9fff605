"""Port parity of three v2 demo scripts: copies of
``demo/gan/gan_trainer.py``, ``demo/traffic_prediction/train.py`` and
``demo/model_zoo/feature_extract.py`` whose only changes are the
package they import (passed in), ``use_gpu=False``, an ``init_tar``
that replaces the seeded init with another run's, and the values they
return. Each runs one short pass in the JAX package, then in the port
from the JAX run's init tar, on the same seeded data:

- the GAN: discriminator and generator costs of 3 alternating steps
  within 1e-4 relative, and the generated samples of the last pass
  within 1e-4;
- traffic prediction: the 8 shared-weight heads' total cost of 4
  RmsProp steps within 1e-4 relative, and the per-horizon softmax
  scores on 64 fresh rows within 1e-4;
- the model zoo: the CNN's 8 Adam costs within 1e-4 relative, the tar
  round trip, and the features of the ``__fea__`` layer and the
  probabilities within 1e-4.
"""

import importlib
import io

import numpy as np

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import config as tconfig

COST_RTOL = 1e-4
OUT_ATOL = 1e-4


def _registry(paddle):
    return importlib.import_module(paddle.__name__ + ".core.registry")


def _load_init(paddle, params, init_tar):
    """The parameters of ``init_tar`` written into ``params`` through
    ``params[name] = value`` (the trainers already hold ``params``)."""
    if init_tar is None:
        return
    src = paddle.Parameters.from_tar(io.BytesIO(init_tar))
    for k in src.keys():
        params[k] = src[k]


def _tar(params):
    buf = io.BytesIO()
    params.to_tar(buf)
    return buf.getvalue()


# ------------------------------------------------------- demo/gan copy
def gan_demo(paddle, passes=1, batch_size=32, batches_per_pass=3,
             init_tar=None, echo=print):
    """demo/gan/gan_trainer.py, its imports changed to ``paddle``."""
    NZ = 10

    def _attr(name, static):
        return paddle.attr.Param(name=name, is_static=static,
                                 initial_std=0.1)

    def generator(z, static=False):
        h = paddle.layer.fc(z, size=64, act=paddle.activation.Relu(),
                            param_attr=_attr("g_h1.w", static),
                            bias_attr=_attr("g_h1.b", static))
        h = paddle.layer.fc(h, size=64, act=paddle.activation.Relu(),
                            param_attr=_attr("g_h2.w", static),
                            bias_attr=_attr("g_h2.b", static))
        return paddle.layer.fc(h, size=2, act=None,
                               param_attr=_attr("g_out.w", static),
                               bias_attr=_attr("g_out.b", static))

    def discriminator(x, static=False):
        h = paddle.layer.fc(x, size=64, act=paddle.activation.Relu(),
                            param_attr=_attr("d_h1.w", static),
                            bias_attr=_attr("d_h1.b", static))
        h = paddle.layer.fc(h, size=64, act=paddle.activation.Relu(),
                            param_attr=_attr("d_h2.w", static),
                            bias_attr=_attr("d_h2.b", static))
        return paddle.layer.fc(h, size=2, act=paddle.activation.Softmax(),
                               param_attr=_attr("d_out.w", static),
                               bias_attr=_attr("d_out.b", static))

    def build_trainers(lr=1e-3):
        _registry(paddle).reset_name_counters()
        sample = paddle.layer.data("sample",
                                   paddle.data_type.dense_vector(2))
        d_label = paddle.layer.data("label",
                                    paddle.data_type.integer_value(2))
        d_cost = paddle.layer.classification_cost(
            discriminator(sample, static=False), d_label, name="d_cost")
        noise = paddle.layer.data("noise",
                                  paddle.data_type.dense_vector(NZ))
        g_label = paddle.layer.data("glabel",
                                    paddle.data_type.integer_value(2))
        fake = generator(noise, static=False)
        g_cost = paddle.layer.classification_cost(
            discriminator(fake, static=True), g_label, name="g_cost")
        params = paddle.create_parameters(paddle.Topology(d_cost))
        d_trainer = paddle.SGD(cost=d_cost, parameters=params,
                               update_equation=paddle.optimizer.Adam(
                                   learning_rate=lr, beta1=0.5))
        g_trainer = paddle.SGD(cost=g_cost, parameters=params,
                               update_equation=paddle.optimizer.Adam(
                                   learning_rate=lr, beta1=0.5))
        return d_trainer, g_trainer, fake, params

    def real_batch(rng, n):
        return (rng.randn(n, 2) * np.array([0.5, 0.3]) +
                np.array([1.0, -1.0])).astype("float32")

    def fake_batch(g_trainer, fake_node, params, rng, n):
        z = rng.randn(n, NZ).astype("float32")
        out = paddle.infer(output_layer=fake_node, parameters=params,
                           input=[(z[i],) for i in range(n)])
        return np.asarray(out), z

    paddle.init(use_gpu=False, seed=0)
    d_trainer, g_trainer, fake_node, params = build_trainers()
    _load_init(paddle, params, init_tar)
    tar = _tar(params)
    rng = np.random.RandomState(0)
    n = batch_size
    d_hist, g_hist, costs = [], [], []
    for p in range(passes):
        for _ in range(batches_per_pass):
            fake, _ = fake_batch(g_trainer, fake_node, params, rng, n)
            real = real_batch(rng, n)
            xs = np.concatenate([real, fake])
            ys = np.array([1] * n + [0] * n, np.int32)
            order = rng.permutation(2 * n)
            d_batch = [(xs[i], int(ys[i])) for i in order]
            d_loss, _ = d_trainer.train_batch(d_batch)
            z = rng.randn(n, NZ).astype("float32")
            g_batch = [(z[i], 1) for i in range(n)]
            g_loss, _ = g_trainer.train_batch(g_batch)
            costs += [d_loss, g_loss]
        d_hist.append(d_loss)
        g_hist.append(g_loss)
        fake, _ = fake_batch(g_trainer, fake_node, params, rng, 256)
        echo(f"pass {p}: d_loss={d_loss:.4f} g_loss={g_loss:.4f} "
             f"fake_mean={fake.mean(0).round(3)} "
             f"fake_std={fake.std(0).round(3)}")
    return dict(d_hist=d_hist, g_hist=g_hist, costs=costs, fake=fake,
                init_tar=tar)


# ------------------------------------ demo/traffic_prediction copy
def traffic_demo(paddle, passes=1, batch_size=32, batches_per_pass=4,
                 init_tar=None, echo=print):
    """demo/traffic_prediction/train.py, its imports changed to
    ``paddle``."""
    TERM_NUM, FORECASTING_NUM, EMB = 24, 8, 16

    def build():
        L = paddle.layer
        link = L.data("link_encode",
                      paddle.data_type.dense_vector(TERM_NUM))
        costs, scores = [], []
        shared = paddle.attr.Param(name="_link_vec.w")
        for i in range(FORECASTING_NUM):
            vec = L.fc(link, size=EMB, param_attr=shared, bias_attr=False,
                       name=f"link_vec_{i}")
            score = L.fc(vec, size=4, act=paddle.activation.Softmax(),
                         name=f"score_{i}")
            lbl = L.data(f"label_{(i + 1) * 5}min",
                         paddle.data_type.integer_value(4))
            costs.append(L.classification_cost(
                score, lbl, name=f"cost_{(i + 1) * 5}min"))
            scores.append(score)
        return costs, scores

    def make_batch(rng, n):
        phase = rng.uniform(0, 2 * np.pi, (n, 1))
        t = np.arange(TERM_NUM + FORECASTING_NUM)[None, :]
        clean = np.sin(0.3 * t + phase)
        hist = (clean[:, :TERM_NUM] + 0.05 * rng.randn(n, TERM_NUM)) \
            .astype("float32")
        future = clean[:, TERM_NUM:]
        buckets = np.clip(((future + 1.0) / 2.0 * 4).astype("int32"), 0, 3)
        return [tuple([hist[i]] + [int(b) for b in buckets[i]])
                for i in range(n)]

    paddle.init(use_gpu=False, seed=0)
    _registry(paddle).reset_name_counters()
    costs, scores = build()
    params = paddle.create_parameters(paddle.Topology(costs))
    _load_init(paddle, params, init_tar)
    tar = _tar(params)
    trainer = paddle.SGD(cost=costs, parameters=params,
                         update_equation=paddle.optimizer.RmsProp(
                             learning_rate=1e-3))
    rng = np.random.RandomState(0)
    losses = []
    for p in range(passes):
        for _ in range(batches_per_pass):
            loss, metrics = trainer.train_batch(make_batch(rng, batch_size))
            losses.append(loss)
        echo(f"pass {p}: total={loss:.4f} "
             f"5min={metrics['cost_5min']:.3f} "
             f"{FORECASTING_NUM * 5}min="
             f"{metrics[f'cost_{FORECASTING_NUM * 5}min']:.3f}")
    rows = make_batch(rng, 64)
    hist = np.stack([r[0] for r in rows])
    outs, accs = [], []
    for i, score in enumerate(scores):
        out = np.asarray(paddle.infer(output_layer=score,
                                      parameters=params,
                                      input=[(h,) for h in hist]))
        truth = np.array([r[1 + i] for r in rows])
        accs.append(float((out.argmax(-1) == truth).mean()))
        outs.append(out)
    echo(f"per-horizon accuracy: {[round(a, 3) for a in accs]}")
    return dict(costs=losses, scores=np.stack(outs), accs=accs,
                init_tar=tar)


# --------------------------------------------- demo/model_zoo copy
def model_zoo_demo(paddle, init_tar=None, echo=print):
    """demo/model_zoo/feature_extract.py, its imports changed to
    ``paddle``."""
    def build():
        L = paddle.layer
        img = L.data("image", paddle.data_type.dense_vector(3 * 16 * 16),
                     height=16, width=16)
        c1 = L.img_conv(img, filter_size=3, num_filters=8, padding=1,
                        act=paddle.activation.Relu(), name="conv1")
        p1 = L.img_pool(c1, pool_size=2, stride=2, name="pool1")
        c2 = L.img_conv(p1, filter_size=3, num_filters=16, padding=1,
                        act=paddle.activation.Relu(), name="conv2")
        feat = L.fc(c2, size=32, act=paddle.activation.Tanh(),
                    name="__fea__")
        out = L.fc(feat, size=4, act=paddle.activation.Softmax(),
                   name="out")
        lbl = L.data("label", paddle.data_type.integer_value(4))
        return paddle.layer.classification_cost(out, lbl), img, feat, out

    paddle.init(use_gpu=False, seed=0)
    _registry(paddle).reset_name_counters()
    cost, img, feat, out = build()
    params = paddle.create_parameters(paddle.Topology(cost))
    _load_init(paddle, params, init_tar)
    tar = _tar(params)
    trainer = paddle.SGD(cost=cost, parameters=params,
                         update_equation=paddle.optimizer.Adam(
                             learning_rate=1e-3))
    rng = np.random.RandomState(0)

    def reader():
        xs = rng.randn(256, 3 * 16 * 16).astype("float32")
        ys = rng.randint(0, 4, 256)
        for i in range(256):
            yield xs[i], int(ys[i])

    costs = []

    def handler(e):
        if isinstance(e, paddle.event.EndIteration):
            costs.append(float(e.cost))

    trainer.train(paddle.reader.batch(reader, 64), num_passes=2,
                  event_handler=handler)
    buf = io.BytesIO()
    trainer.save_parameter_to_tar(buf)
    buf.seek(0)
    loaded = paddle.Parameters.from_tar(buf)
    probe = rng.randn(8, 3 * 16 * 16).astype("float32")
    feats = np.asarray(paddle.infer(output_layer=feat, parameters=loaded,
                                    input=[(x,) for x in probe]))
    probs = np.asarray(paddle.infer(output_layer=out, parameters=loaded,
                                    input=[(x,) for x in probe]))
    echo(f"feature layer '__fea__': {feats.shape} probs: {probs.shape}")
    assert feats.shape == (8, 32) and probs.shape == (8, 4)
    assert np.allclose(probs.sum(-1), 1.0, atol=1e-3)
    echo("extraction OK")
    return dict(costs=costs, feats=feats, probs=probs, init_tar=tar)


def _run_both(demo, **kw):
    quiet = lambda _: None  # noqa: E731
    try:
        j = demo(jpaddle, echo=quiet, **kw)
        lines = []
        t = demo(tpaddle, init_tar=j["init_tar"], echo=lines.append, **kw)
    finally:
        tconfig.init(seed=0)
    return j, t, lines


def test_gan_copy_tracks_jax():
    j, t, lines = _run_both(gan_demo)
    assert len(t["costs"]) == len(j["costs"]) == 6
    np.testing.assert_allclose(t["costs"], j["costs"], rtol=COST_RTOL)
    np.testing.assert_allclose(t["fake"], j["fake"], rtol=0,
                               atol=OUT_ATOL)
    assert np.isfinite(t["d_hist"]).all() and np.isfinite(t["g_hist"]).all()
    assert lines[0].startswith("pass 0: d_loss=")


def test_traffic_copy_tracks_jax():
    j, t, lines = _run_both(traffic_demo)
    assert len(t["costs"]) == len(j["costs"]) == 4
    np.testing.assert_allclose(t["costs"], j["costs"], rtol=COST_RTOL)
    assert t["scores"].shape == (8, 64, 4)
    np.testing.assert_allclose(t["scores"], j["scores"], rtol=0,
                               atol=OUT_ATOL)
    assert lines[-1].startswith("per-horizon accuracy:")


def test_model_zoo_copy_tracks_jax():
    j, t, lines = _run_both(model_zoo_demo)
    assert len(t["costs"]) == len(j["costs"]) == 8
    np.testing.assert_allclose(t["costs"], j["costs"], rtol=COST_RTOL)
    np.testing.assert_allclose(t["feats"], j["feats"], rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(t["probs"], j["probs"], rtol=0,
                               atol=OUT_ATOL)
    assert lines == ["feature layer '__fea__': (8, 32) probs: (8, 4)",
                     "extraction OK"]


def test_parameters_set_after_sgd_keeps_training_like_jax():
    """``parameters[name] = value`` on a table an SGD trainer already
    holds (the GAN copy's init path, the v2 API's ``parameters.set``):
    the JAX package trains on from the new value; so does the port,
    keeping the parameter's dtype (a float64 value lands as float32)."""
    def run(paddle):
        paddle.init(use_gpu=False, seed=0)
        _registry(paddle).reset_name_counters()
        x = paddle.layer.data("x", paddle.data_type.dense_vector(4))
        y = paddle.layer.data("y", paddle.data_type.integer_value(3))
        out = paddle.layer.fc(x, size=3, act=paddle.activation.Softmax())
        cost = paddle.layer.classification_cost(out, y)
        params = paddle.create_parameters(paddle.Topology(cost))
        trainer = paddle.SGD(cost=cost, parameters=params,
                             update_equation=paddle.optimizer.Momentum(
                                 learning_rate=0.1))
        rng = np.random.RandomState(1)
        for k in sorted(params.keys()):
            params[k] = rng.randn(*np.shape(params[k])) * 0.3
        batch = [(rng.randn(4).astype("float32"), int(rng.randint(3)))
                 for _ in range(8)]
        costs = [trainer.train_batch(batch)[0] for _ in range(3)]
        return costs, {k: np.asarray(params[k]) for k in params.keys()}

    try:
        jc, jp = run(jpaddle)
        tc, tp = run(tpaddle)
    finally:
        tconfig.init(seed=0)
    np.testing.assert_allclose(tc, jc, rtol=COST_RTOL)
    assert tc[2] < tc[0]
    for k in tp:
        assert tp[k].dtype == np.float32
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-5)
