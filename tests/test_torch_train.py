"""Port parity: the training core of paddle_tpu_torch (optimizers,
Parameters, DataFeeder, SGD trainer) against paddle_tpu on the CPU.

- The Adam and Momentum rules (``_apply``) on the same
  (p, g, slots, step): rtol 1e-6.
- Three ``SGD.train_batch`` steps of the CFG transformer_lm of
  tests/test_paged_decode.py in both packages from one JAX table on
  the same ragged batches. Momentum(0.9): per-step losses and final
  parameters at rtol 1e-4 / atol 1e-6. Adam: per-step losses at
  rtol 1e-4 (its g / sqrt(v) makes near-zero gradients
  sign-sensitive, so its parameters are held through ``_apply``).
- ``Parameters.to_tar`` round-trips between the packages both ways.
- A table trained in the port drives the port's TransformerDecoder
  (tied head) to the JAX TransformerDecoder's greedy tokens on that
  table (the tie rule of tests/test_torch_decode.py).
"""

import io

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import torch
from paddle_tpu import models as jmodels
from paddle_tpu.core.registry import reset_name_counters as j_reset

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.registry import reset_name_counters as t_reset
from paddle_tpu_torch.core.topology import Topology as TTopology
from paddle_tpu_torch.models import decode as pt_decode
from paddle_tpu_torch.models import transformer_lm as t_transformer_lm
from paddle_tpu_torch.trainer import SGD as TSGD
from paddle_tpu_torch.trainer import Parameters as TParameters
from paddle_tpu_torch.trainer import create as t_create

CFG = dict(vocab_size=40, d_model=16, n_heads=2, n_layers=2, d_ff=32,
           max_len=32)
RTOL_RULE = 1e-6
RTOL, ATOL = 1e-4, 1e-6


def _batches(n=3, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        rows = []
        for L in rng.randint(4, 14, size=3):
            t = rng.randint(0, CFG["vocab_size"], (L + 1,)).astype(np.int32)
            rows.append((t[:-1], np.arange(L, dtype=np.int32), t[1:]))
        out.append(rows)
    return out


def _models(tied=True):
    paddle.init(use_tpu=False, seed=0)
    j_reset()
    jspec = jmodels.transformer_lm(**CFG, tie_embeddings=tied)
    t_reset()
    tspec = t_transformer_lm(**CFG, tie_embeddings=tied)
    jtopo = paddle.Topology(jspec.cost, extra_outputs=[jspec.output])
    table = {k: np.asarray(v)
             for k, v in jtopo.init_params(jax.random.PRNGKey(3)).items()}
    return jspec, tspec, table


def _jax_trainer(jspec, table, opt):
    params = paddle.Parameters({k: jnp.asarray(v) for k, v in table.items()})
    return paddle.SGD(cost=jspec.cost, parameters=params,
                      update_equation=opt)


def _torch_trainer(tspec, table, opt):
    params = TParameters({k: torch.tensor(v) for k, v in table.items()},
                         device="cpu")
    return TSGD(cost=tspec.cost, parameters=params, update_equation=opt,
                device="cpu")


@pytest.mark.parametrize("rule", ["adam", "momentum", "sgd"])
def test_update_rules_match_jax(rule):
    rng = np.random.RandomState(11)
    p, g, m, v = (rng.randn(5, 7).astype(np.float32) for _ in range(4))
    v = np.abs(v)
    if rule == "adam":
        jo, to = paddle.optimizer.Adam(), topt.Adam()
        slot = {"m": m, "v": v}
    else:
        mom = 0.9 if rule == "momentum" else 0.0
        jo, to = (paddle.optimizer.Momentum(momentum=mom),
                  topt.Momentum(momentum=mom))
        slot = {"mom": m} if mom else {}
    for step in (1, 2, 7):
        jp, js = jo._apply(jnp.asarray(p), jnp.asarray(g),
                           {k: jnp.asarray(x) for k, x in slot.items()},
                           jnp.asarray(0.01, jnp.float32),
                           jnp.asarray(step, jnp.int32))
        tp, ts = to._apply(torch.tensor(p), torch.tensor(g),
                           {k: torch.tensor(x) for k, x in slot.items()},
                           0.01, step)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                                   rtol=RTOL_RULE)
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=RTOL_RULE, err_msg=k)


def test_adjust_grad_clip_and_regularization_match_jax():
    from paddle_tpu.core.registry import ParamAttr as JAttr
    from paddle_tpu_torch.core.registry import ParamAttr as TAttr
    rng = np.random.RandomState(2)
    p, g = (rng.randn(4, 3).astype(np.float32) for _ in range(2))
    kw = dict(gradient_clipping_threshold=0.5,
              regularization=paddle.optimizer.L2Regularization(1e-2))
    jo = paddle.optimizer.Momentum(**kw)
    to = topt.Momentum(gradient_clipping_threshold=0.5,
                       regularization=topt.L2Regularization(1e-2))
    jo.param_attrs = {"w": JAttr(l1_rate=1e-3, learning_rate=0.5)}
    to.param_attrs = {"w": TAttr(l1_rate=1e-3, learning_rate=0.5)}
    jg, jscale = jo._adjust_grad("w", jnp.asarray(p), jnp.asarray(g))
    tg, tscale = to._adjust_grad("w", torch.tensor(p), torch.tensor(g))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL_RULE)
    assert tscale == jscale == 0.5


def test_momentum_train_batch_matches_jax():
    jspec, tspec, table = _models()
    kw = dict(momentum=0.9, learning_rate=0.05)
    jtr = _jax_trainer(jspec, table, paddle.optimizer.Momentum(**kw))
    ttr = _torch_trainer(tspec, table, topt.Momentum(**kw))
    for batch in _batches():
        jl, _ = jtr.train_batch(batch)
        tl, tm = ttr.train_batch(batch)
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
        assert tm == {"tfm_cost": tl}
    assert ttr.opt_state["step"] == 3
    for k, v in jtr.parameters.raw.items():
        np.testing.assert_allclose(ttr.parameters[k], np.asarray(v),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_adam_train_batch_losses_match_jax():
    jspec, tspec, table = _models()
    jtr = _jax_trainer(jspec, table,
                       paddle.optimizer.Adam(learning_rate=1e-3))
    ttr = _torch_trainer(tspec, table, topt.Adam(learning_rate=1e-3))
    losses = []
    for batch in _batches(seed=1):
        jl, _ = jtr.train_batch(batch)
        tl, _ = ttr.train_batch(batch)
        np.testing.assert_allclose(tl, jl, rtol=RTOL)
        losses.append(tl)
    assert all(np.isfinite(losses))


def test_train_loop_events_and_test_pass():
    """train() over a reader emits the v2 event sequence with the
    per-batch costs, and test() reports the mean cost without
    touching the parameters."""
    from paddle_tpu_torch.trainer import event as tevt
    _, tspec, table = _models()
    ttr = _torch_trainer(tspec, table, topt.Momentum(learning_rate=0.01))
    batches = _batches(n=2, seed=4)
    seen = []

    def handler(e):
        seen.append(type(e).__name__)
        if isinstance(e, tevt.EndIteration):
            assert np.isfinite(e.cost) and e.metrics["tfm_cost"] == e.cost
        if isinstance(e, tevt.EndPass):
            assert set(e.metrics) == {"tfm_cost"}

    ttr.train(lambda: iter(batches), num_passes=2, event_handler=handler)
    # no evaluator: the iteration events are the lazy kind, as in the
    # JAX package
    assert seen == (["BeginPass"] + ["BeginIteration", "LazyEndIteration"]
                    * 2 + ["EndPass"]) * 2
    before = {k: ttr.parameters[k].copy() for k in ttr.parameters.keys()}
    res = ttr.test(lambda: iter(batches))
    assert np.isfinite(res.cost)
    for k, v in before.items():
        np.testing.assert_array_equal(ttr.parameters[k], v)
    # the elastic fleet's options: each accepted, each reaching the
    # coordinator path (trainer/coordinator.py)
    from paddle_tpu_torch.obs.events import tail
    from paddle_tpu_torch.trainer.coordinator import Coordinator
    reads, reshapes, steps = [], [], []

    def chunk_reader(chunk):
        reads.append(chunk)
        return iter(batches[chunk])         # the 3 samples of a batch

    coord = Coordinator([0, 1], chunks_per_task=1)
    # a peer joins after the first grant: the next one shows generation 2
    coord._grant_interceptor = \
        lambda i, g: coord.join("peer") if i == 0 else None
    ttr.train(coordinator=coord, chunk_reader=chunk_reader, batch_size=3,
              worker_id="w0", on_reshape=reshapes.append,
              idle_timeout=30.0,
              event_handler=lambda e: steps.append(e.cost)
              if isinstance(e, tevt.EndIteration) else None)
    assert coord.epoch == 1                 # coordinator: the pass ran
    assert reads == [0, 1]                  # chunk_reader
    assert len(steps) == 2                  # batch_size: 3 rows a step
    assert coord.workers() == ["peer"]      # worker_id: joined and left
    assert [r["worker_id"] for r in tail(50, domain="coordinator",
                                         kind="join")] == ["w0", "peer"]
    assert reshapes == [2]                  # on_reshape
    # idle_timeout: the only task is held elsewhere, so the pass cannot
    # end; the reader gives up after 0.4 s and train() stops
    held = Coordinator([0], chunks_per_task=1)
    assert held.get_task(0) is not None
    with pytest.warns(UserWarning, match="never completed"):
        ttr.train(coordinator=held, chunk_reader=chunk_reader,
                  idle_timeout=0.4, event_handler=lambda e: None)
    assert held.epoch == 0


def test_params_tar_round_trips_between_packages():
    _, _, table = _models()
    tparams = TParameters({k: torch.tensor(v) for k, v in table.items()},
                          state={"s": torch.ones(2)}, device="cpu")
    buf = io.BytesIO()
    tparams.to_tar(buf)
    buf.seek(0)
    jparams = paddle.Parameters.from_tar(buf)
    assert set(jparams.names()) == set(table)
    for k, v in table.items():
        np.testing.assert_array_equal(jparams[k], v)
    np.testing.assert_array_equal(np.asarray(jparams.state["s"]), np.ones(2))
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    back = TParameters.from_tar(buf, device="cpu")
    for k, v in table.items():
        np.testing.assert_array_equal(back[k], v)
    np.testing.assert_array_equal(back.state["s"].numpy(), np.ones(2))


def test_port_trained_table_decodes_like_jax():
    """Train three Adam steps in the port, save the tar, and decode the
    table greedily in both packages' TransformerDecoder (tied head)."""
    from paddle_tpu_torch.params import load_params_tar
    _, tspec, table = _models(tied=True)
    ttr = _torch_trainer(tspec, table, topt.Adam(learning_rate=1e-2))
    for batch in _batches(seed=2):
        ttr.train_batch(batch)
    buf = io.BytesIO()
    ttr.save_parameter_to_tar(buf)
    buf.seek(0)
    trained = load_params_tar(buf)
    assert "_tfm_head.w0" not in trained
    assert not np.array_equal(trained["_tfm_tok_emb.w0"],
                              table["_tfm_tok_emb.w0"])
    jdec = jmodels.TransformerDecoder(
        {k: jnp.asarray(v) for k, v in trained.items()},
        n_layers=CFG["n_layers"], n_heads=CFG["n_heads"])
    tdec = pt_decode.TransformerDecoder(trained, n_layers=CFG["n_layers"],
                                        n_heads=CFG["n_heads"], device="cpu")
    prompt = np.random.RandomState(6).randint(
        0, CFG["vocab_size"], (3, 5)).astype(np.int32)
    want = jdec.generate(prompt, max_len=16)
    got = tdec.generate(prompt, max_len=16)
    ref = tdec.prefill_logits(np.concatenate([prompt, np.asarray(want)],
                                             axis=1))
    for i in range(len(want)):
        assert pt_decode.tokens_agree(got[i], want[i], ref[i, 4:], 1e-4), i


def test_entry_points_refuse_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    t_reset()
    spec = t_transformer_lm(**CFG)
    topo = TTopology(spec.cost)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_create(topo)
    params = t_create(topo, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSGD(spec.cost, params, topt.Adam())
    with pytest.raises(RuntimeError, match="CUDA"):
        TParameters({})
