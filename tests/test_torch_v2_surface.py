"""Port parity: the v2 surface the port lacked against the JAX package
(ROADMAP C.1a-d), on the CPU.

- C.1a: ``Parameters.names`` / ``has_key`` / ``get`` / ``set`` /
  ``get_shape`` / ``init_from_tar``, ``Topology.get_layer`` / ``proto``
  and ``registry.registered_layer_types``, each held against the JAX
  call on one fc 4 -> 3 topology and one JAX-written tar: equal names
  and shapes, values bit-equal (the tar carries float32 arrays), the
  same layer node, equal ``proto()`` text.
- C.1b: ``init(debug_nans=True)`` makes the trainer raise
  ``FloatingPointError`` at the first non-finite value, before the
  update writes anything; ``init(debug_nans=False)`` clears it. The
  JAX package's ``test_debug_nans_flag_raises_at_source`` mirrored in
  a subprocess.
- C.1c: the train step reports to the continuous profiler: an injected
  stall in the step's compute (a sleep in a patched ``_device_step``,
  at fixed steps) is journaled as a ``compute`` step regression, with
  the phase samples and a live MFU present; ``cli.py train
  --profile_every/--slo`` wire it.
- C.1d: ``DataFeeder(fixed_batch_size=)`` pads a short batch as the JAX
  feeder does (bit-equal rows and lengths), and ``PrefixIndex.summary()``
  of a port and a JAX engine on one prompt set are equal dicts; the
  flight bundle's prefix view is that summary.
"""

import io
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.core.registry import reset_name_counters as jreset
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.core.registry import reset_name_counters as treset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_state_restored():
    """Fresh port obs state before each test, and the port's process
    device and flags back to the defaults after it."""
    tobs.reset_all()
    yield
    tobs.reset_all()
    from paddle_tpu_torch import config as tconfig
    tconfig.init(seed=0)


def _fc(paddle):
    x = paddle.layer.data("x", paddle.data_type.dense_vector(4))
    y = paddle.layer.data("y", paddle.data_type.integer_value(3))
    out = paddle.layer.fc(x, size=3, act=paddle.activation.Softmax(),
                          name="out")
    return paddle.layer.classification_cost(out, y, name="cost")


def _jax_fc():
    jpaddle.init(use_tpu=False, seed=0)
    jreset()
    cost = _fc(jpaddle)
    topo = jpaddle.Topology(cost)
    return cost, topo, jpaddle.create_parameters(topo)


def _port_fc():
    tpaddle.init(use_gpu=False, seed=0)
    treset()
    cost = _fc(tpaddle)
    topo = tpaddle.Topology(cost)
    return cost, topo, tpaddle.create_parameters(topo)


def _jax_tar(jparams):
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    return buf


# ------------------------------------------------------------------- C.1a
def test_parameters_accessors_match_jax():
    _, _, jp = _jax_fc()
    _, _, tp = _port_fc()
    assert tp.names() == jp.names()
    for name in jp.names():
        assert tp.has_key(name) and jp.has_key(name)
        assert tp.get_shape(name) == jp.get_shape(name)
        assert tp.get(name).shape == jp.get(name).shape
    assert not tp.has_key("nope") and not jp.has_key("nope")
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    tp.set("_out.w0", w)
    jp.set("_out.w0", w)
    np.testing.assert_array_equal(tp.get("_out.w0"), jp.get("_out.w0"))
    with pytest.raises(ValueError, match="shape mismatch"):
        tp.set("_out.w0", np.zeros((3, 4), np.float32))


def test_init_from_tar_matches_jax_and_keeps_leaves():
    """A JAX tar loaded in place into the port's parameters and into the
    JAX package's: equal names, shapes and values (bit for bit). In a
    trainer the parameters stay float32 autograd leaves on their device
    and training goes on from the loaded values."""
    _, _, jsrc = _jax_fc()
    jsrc.set("_out.w0", np.random.RandomState(5).randn(4, 3)
             .astype(np.float32))
    blob = _jax_tar(jsrc).getvalue()
    _, _, jdst = _jax_fc()
    jdst.init_from_tar(io.BytesIO(blob))
    tcost, _, tdst = _port_fc()
    tr = tpaddle.SGD(cost=tcost, parameters=tdst, device="cpu",
                     update_equation=tpaddle.optimizer.Momentum(
                         learning_rate=0.1))
    before = {k: id(v) for k, v in tdst.raw.items()}
    tdst.init_from_tar(io.BytesIO(blob))
    assert tdst.names() == jdst.names()
    for name in jdst.names():
        assert tdst.get_shape(name) == jdst.get_shape(name)
        np.testing.assert_array_equal(tdst[name], jdst[name], err_msg=name)
        t = tdst.raw[name]
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert t.requires_grad and t.is_leaf
    assert set(before) == set(tdst.raw)
    rng = np.random.RandomState(0)
    batch = [(rng.randn(4).astype(np.float32), int(rng.randint(3)))
             for _ in range(8)]
    tr.train_batch(batch)
    assert not np.array_equal(tdst["_out.w0"], jdst["_out.w0"])


def test_topology_get_layer_proto_and_registry_match_jax():
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    _, jtopo, _ = _jax_fc()
    _, ttopo, _ = _port_fc()
    for name in ("x", "y", "out", "cost"):
        tl, jl = ttopo.get_layer(name), jtopo.get_layer(name)
        assert tl is ttopo.by_name[name]
        assert (tl.name, tl.type, [p.name for p in tl.parents]) == \
            (jl.name, jl.type, [p.name for p in jl.parents])
    with pytest.raises(ValueError, match="not in topology"):
        ttopo.get_layer("missing")
    assert ttopo.proto() == jtopo.proto()
    assert treg.registered_layer_types() == jreg.registered_layer_types()


# ------------------------------------------------------------------- C.1b
def test_debug_nans_flag_raises_at_source():
    """The port's counterpart of tests/test_trainer.py's test of the same
    name, in a fresh process: with ``debug_nans`` set, a step whose cost
    is log(0) raises FloatingPointError; cleared, it trains on."""
    script = textwrap.dedent("""\
        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch import config as cfg
        cfg.init(use_gpu=False, debug_nans=True)
        assert cfg.global_config().debug_nans
        x = paddle.layer.data("x", paddle.data_type.dense_vector(4))
        y = paddle.layer.data("y", paddle.data_type.dense_vector(2))
        h = paddle.layer.fc(x, size=2, act=paddle.activation.Log(),
                            bias_attr=False)
        cost = paddle.layer.mse_cost(h, y)
        params = paddle.create_parameters(paddle.Topology(cost))
        tr = paddle.SGD(cost=cost, parameters=params,
                        update_equation=paddle.optimizer.Momentum(0.1))
        # log(0) = -inf: the cost is not finite
        batch = [(np.zeros(4, np.float32), np.ones(2, np.float32))]
        try:
            tr.train_batch(batch)
        except FloatingPointError:
            print("TRAPPED")
        cfg.init(use_gpu=False, debug_nans=False)
        assert not cfg.global_config().debug_nans
        tr.train_batch(batch)
        print("CLEARED")
        """)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert "TRAPPED" in r.stdout and "CLEARED" in r.stdout, \
        f"nan did not trap:\n{r.stdout}\n{r.stderr}"


def _act_trainer(debug_nans, act):
    """x -> fc(act, no bias) -> mse against y, under Adam."""
    tpaddle.init(use_gpu=False, seed=0, debug_nans=debug_nans)
    treset()
    x = tpaddle.layer.data("x", tpaddle.data_type.dense_vector(4))
    y = tpaddle.layer.data("y", tpaddle.data_type.dense_vector(2))
    h = tpaddle.layer.fc(x, size=2, act=act, bias_attr=False, name="h")
    cost = tpaddle.layer.mse_cost(h, y, name="cost")
    params = tpaddle.create_parameters(tpaddle.Topology(cost))
    return tpaddle.SGD(cost=cost, parameters=params,
                       update_equation=tpaddle.optimizer.Adam(1e-2))


@pytest.mark.parametrize("via", ["train_batch", "train"])
def test_debug_nans_log0_cost_leaves_parameters(via):
    """A log(0) cost under ``debug_nans``: FloatingPointError, and the
    parameters, the optimizer's counters and slots are as they were."""
    tr = _act_trainer(True, tpaddle.activation.Log())
    # positive weights: a positive input keeps log's argument positive
    with torch.no_grad():
        tr.parameters.raw["_h.w0"].abs_()
    rng = np.random.RandomState(0)
    good = [(rng.rand(4).astype(np.float32) + 0.5,
             rng.rand(2).astype(np.float32)) for _ in range(4)]
    bad = [(np.zeros(4, np.float32), np.ones(2, np.float32))] * 4
    tr.train_batch(good)        # finite: trains
    before = {k: v.detach().clone() for k, v in tr.parameters.raw.items()}
    slots = {k: {n: s.clone() for n, s in v.items()}
             for k, v in tr.opt_state["slots"].items()}
    step = tr.opt_state["step"]
    with pytest.raises(FloatingPointError, match="forward"):
        if via == "train_batch":
            tr.train_batch(bad)
        else:
            tr.train(lambda: iter([bad]), num_passes=1,
                     event_handler=lambda e: None)
    for k, v in tr.parameters.raw.items():
        assert torch.equal(v, before[k]), k
    assert tr.opt_state["step"] == step
    for k, v in tr.opt_state["slots"].items():
        for n, s in v.items():
            assert torch.equal(s, slots[k][n]), (k, n)


def test_debug_nans_checks_gradients_and_clears():
    """A finite cost with a non-finite gradient — sqrt at 0: the cost
    (0 - 1)^2 is finite, its derivative is not — raises from the
    backward check, parameters unchanged; with the flag cleared the
    same step runs and writes NaN into the weights."""
    tr = _act_trainer(True, tpaddle.activation.Sqrt())
    rows = [(np.zeros(4, np.float32), np.ones(2, np.float32))]
    before = tr.parameters["_h.w0"].copy()
    with pytest.raises(FloatingPointError, match="backward"):
        tr.train_batch(rows)
    np.testing.assert_array_equal(tr.parameters["_h.w0"], before)
    tpaddle.init(use_gpu=False, seed=0, debug_nans=False)
    cost, _ = tr.train_batch(rows)      # no trap: the update goes in
    assert np.isfinite(cost)
    assert not np.isfinite(tr.parameters["_h.w0"]).all()


# ------------------------------------------------------------------- C.1c
def test_train_stall_journaled_as_compute_regression(monkeypatch):
    """A 0.3 s stall in the step's compute at steps 14-17 (a sleep in a
    patched ``_device_step``) is journaled as ``slo/step_regression``
    naming ``compute``; the profiler's train kind carries its phase
    samples and a live MFU (the peak forced: the CPU has none)."""
    from paddle_tpu_torch.obs.events import tail
    from paddle_tpu_torch.obs.profile import PROFILER
    from paddle_tpu_torch.obs.slo import WATCHDOG
    import torch_train_infra as infra
    tr = infra.port_trainer(tpaddle.optimizer.Adam(1e-2),
                            infra.table())
    real = tr._device_step
    stalled = []

    def device_step(*a, **kw):
        out = real(*a, **kw)
        if 14 <= tr._step_count < 18:
            stalled.append(tr._step_count)
            time.sleep(0.3)
        return out

    monkeypatch.setattr(tr, "_device_step", device_step)
    PROFILER.enable(sample_every=1)
    PROFILER.configure(peak_flops=1e9)
    WATCHDOG.configure(regression_factor=3.0, regression_steps=2,
                       min_samples=4, cooldown_s=0.0)
    try:
        infra.run(tr, infra.reader(batches=24))
    finally:
        PROFILER.disable()
    assert stalled == [14, 15, 16, 17]
    regs = [r for r in tail(500, domain="slo", kind="step_regression")
            if r["step_kind"] == "train"]
    assert regs, "the injected stall was never journaled"
    assert regs[-1]["phase"] == "compute"
    assert regs[-1]["factor"] >= 3.0
    assert regs[-1].get("run_id")           # train() set one
    snap = PROFILER.snapshot()
    train = snap["kinds"]["train"]
    assert train["steps"] == 24
    assert set(train["phases"]) == {"data_wait", "h2d", "compute",
                                    "settle"}
    assert snap["cost"]["train"]["flops"] > 0
    assert 0.0 < snap["mfu"]["train"] <= 1.0


def test_cli_train_profile_every_and_slo(tmp_path, capsys):
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.obs.profile import PROFILER
    from paddle_tpu_torch.obs.slo import WATCHDOG
    cfg = tmp_path / "cfg.py"
    cfg.write_text(textwrap.dedent("""\
        import numpy as np
        import paddle_tpu_torch as paddle
        x = paddle.layer.data("x", paddle.data_type.dense_vector(8))
        y = paddle.layer.data("y", paddle.data_type.integer_value(2))
        out = paddle.layer.fc(x, size=2, act=paddle.activation.Softmax())
        cost = paddle.layer.classification_cost(out, y)

        def train_reader():
            rng = np.random.RandomState(0)
            for _ in range(6):
                f = rng.randn(4, 8).astype("float32")
                yield [(f[i], int(rng.randint(0, 2))) for i in range(4)]
        """))
    args = cli.build_parser().parse_args(
        ["train", "--config", str(cfg), "--use_tpu=false",
         "--profile_every", "2", "--slo", "step_time_p99_ms<=60000"])
    assert args.profile_every == 2
    assert args.slo == ["step_time_p99_ms<=60000"]
    assert cli.main(["train", "--config", str(cfg), "--use_tpu=false",
                     "--profile_every", "2",
                     "--slo", "step_time_p99_ms<=60000"]) == 0
    snap = PROFILER.snapshot()
    assert not snap["enabled"]              # disabled at the job's end
    assert snap["sample_every"] == 2
    assert snap["kinds"]["train"]["steps"] == 6
    assert [o.metric for o in WATCHDOG._objectives] == ["step_time_p99_ms"]


# ------------------------------------------------------------------- C.1d
def _feeder_pair(types_fn, fixed):
    from paddle_tpu.trainer.data_feeder import DataFeeder as JFeeder
    from paddle_tpu_torch.trainer.data_feeder import DataFeeder as TFeeder
    return (JFeeder(types_fn(jpaddle.data_type), fixed_batch_size=fixed),
            TFeeder(types_fn(tpaddle.data_type), fixed_batch_size=fixed,
                    device="cpu"))


def _host(v):
    if hasattr(v, "lengths"):
        return np.asarray(v.data), np.asarray(v.lengths)
    return (np.asarray(v),)


def test_fixed_batch_padding_matches_jax():
    """tests/test_data_feeder.py's TestFixedBatchPadding in both
    packages, and every padded kind beside it: equal shapes, values
    and lengths."""
    def types(dt):
        return [("sent", dt.integer_value_sequence(50)),
                ("img", dt.dense_vector(3)),
                ("lbl", dt.integer_value(5)),
                ("sp", dt.sparse_binary_vector(6)),
                ("spf", dt.sparse_vector(6)),
                ("dseq", dt.dense_vector_sequence(2)),
                ("spseq", dt.sparse_binary_vector_sequence(6))]
    jf, tf = _feeder_pair(types, 4)
    rows = [([1, 2], [0.5, 1.0, 2.0], 3, [1, 4], ([0, 5], [0.5, 2.0]),
             [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], [[1], [2, 3]]),
            ([3], [1.5, -1.0, 0.0], 1, [2], ([3], [1.0]),
             [[7.0, 8.0]], [[0, 5]])]
    jfeed, tfeed = jf.convert(rows), tf.convert(rows)
    assert jfeed["__batch_size__"] == tfeed["__batch_size__"] == 2
    for name, _ in types(tpaddle.data_type):
        for a, b in zip(_host(jfeed[name]), _host(tfeed[name])):
            assert a.shape == b.shape and a.shape[0] == 4, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(np.asarray(tfeed["sent"].lengths),
                                  [2, 1, 0, 0])
    # a full batch is not padded, and None pads nothing
    full = rows * 2
    assert tf.convert(full)["lbl"].shape[0] == 4
    _, tnone = _feeder_pair(types, None)
    assert tnone.convert(rows)["lbl"].shape[0] == 2


def _engine_pair():
    from paddle_tpu import models as jmodels
    from paddle_tpu.serving import DecodeEngine as JEngine
    from paddle_tpu_torch.models import decode as pt_decode
    from paddle_tpu_torch.serving import DecodeEngine as TEngine
    cfg = dict(vocab_size=40, d_model=16, n_heads=2, n_layers=2, d_ff=32,
               max_len=32)
    jpaddle.init(use_tpu=False, seed=0)
    jreset()
    spec = jmodels.transformer_lm(**cfg)
    costs = spec.cost if isinstance(spec.cost, list) else [spec.cost]
    topo = jpaddle.Topology(costs, extra_outputs=[spec.output])
    params = topo.init_params(jax.random.PRNGKey(7))
    jdec = jmodels.TransformerDecoder(params, n_layers=2, n_heads=2)
    tdec = pt_decode.TransformerDecoder(
        {k: np.asarray(v) for k, v in params.items()}, n_layers=2,
        n_heads=2, device="cpu")
    kw = dict(num_slots=2, page_size=4, max_seq_len=32)
    return JEngine(jdec, **kw), TEngine(tdec, **kw)


def test_prefix_summary_matches_jax_engine():
    """One prompt set — a shared 9-token prefix (two full pages and a
    row of a third, so the second request attaches two pages and
    copies one on write), then an unrelated prompt — through a JAX and
    a port engine: equal ``summary()`` dicts, and the port's flight
    bundle carries exactly that summary as its prefix view."""
    jeng, teng = _engine_pair()
    rng = np.random.RandomState(3)
    base = rng.randint(0, 40, (9,)).astype("int32")
    prompts = [np.concatenate([base, rng.randint(0, 40, (2,))
                               .astype("int32")]) for _ in range(3)] + \
        [rng.randint(0, 40, (6,)).astype("int32")]
    for eng in (jeng, teng):
        for p in prompts:
            # one at a time: each later request finds the earlier ones'
            # pages in the trie
            eng.submit(p, 3)
            eng.run(timeout=120)
    tsum = teng.prefix.summary()
    jsum = jeng.prefix.summary()
    assert tsum == jsum
    assert tsum["hit_pages"] > 0 and tsum["cow_copies"] > 0
    assert tsum["refcount_histogram"] == teng.pool.refcount_histogram()
    bundle = tobs.FLIGHT.bundle("test")
    views = [v["prefix"] for v in bundle["state"].values()
             if isinstance(v, dict) and "prefix" in v]
    assert views == [tsum]
