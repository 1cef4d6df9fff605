"""Port parity: the evaluator framework of paddle_tpu_torch
(paddle_tpu_torch/evaluator) against paddle_tpu's on the CPU.

- Each evaluator, fed the same numpy batches (with padding rows past
  each batch's real count), gives the JAX evaluator's result: exactly
  for counts, error rates, F1, sums and printed text; rtol 1e-6 for
  AUC and mAP.
- ``extract_chunks`` and ``edit_distance`` agree on seeded sequences
  in every chunk scheme.
- Tensor inputs: bfloat16 scores and SequenceBatch values reach the
  host evaluators as the float32 / (data, lengths) numpy the JAX
  package's ``_to_np`` gives; the trainer's one-transfer fetch returns
  every evaluator tensor unchanged.
- ``SGD(evaluators=...)`` on a small MLP from one weight tar: the
  running results in each EndIteration, the pass results in EndPass
  and the test sweep's results in TestResult equal the JAX trainer's
  (pass averages of the cost at rtol 1e-6: the JAX trainer sums them
  compensated, the port in plain floats).
- ``gradient_printer``'s values from a train step are held in
  tests/test_torch_datasets.py.
"""

import io

import numpy as np
import pytest

import paddle_tpu as jpaddle
import torch
from paddle_tpu import evaluator as jev

import paddle_tpu_torch as paddle
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch import evaluator as tev
from paddle_tpu_torch.core.registry import reset_name_counters as t_reset
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.trainer.trainer import SGD as TSGD

RTOL_AUC = 1e-6
RTOL_PASS = 1e-6


@pytest.fixture(autouse=True)
def _port_config():
    t_reset()
    yield
    tconfig.init(seed=0)


class _Node:
    """A stand-in input: evaluators read only ``name``."""

    def __init__(self, name):
        self.name = name


def _seq(rng, b, T, hi, lens=None):
    lens = rng.randint(1, T + 1, b) if lens is None else np.asarray(lens)
    ids = rng.randint(0, hi, (b, T)).astype(np.int32)
    return (ids, lens.astype(np.int32))


def _batches(kind, seed=0, n=3, b=8, n_real=6):
    """n batches of host values for evaluator ``kind`` (b rows, the
    last b - n_real of them padding)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind in ("auc", "auc2"):
            cols = 1 if kind == "auc" else 2
            score = rng.rand(b, cols).astype(np.float32)
            vals = [score, rng.randint(0, 2, b)]
        elif kind in ("classification_error", "classification_error_top2",
                      "precision_recall", "precision_recall_pos"):
            p = rng.rand(b, 5).astype(np.float32)
            vals = [p / p.sum(-1, keepdims=True), rng.randint(0, 5, b)]
        elif kind.startswith("chunk"):
            lens = rng.randint(1, 12, b)
            pred = _seq(rng, b, 12, 9, lens)
            gold = _seq(rng, b, 12, 9, lens)
            vals = [pred, gold]
        elif kind == "ctc_error":
            lens = rng.randint(1, 10, b)
            frames = rng.rand(b, 10, 5).astype(np.float32)
            vals = [(frames, lens.astype(np.int32)), _seq(rng, b, 6, 4)]
        elif kind in ("pnpair", "rank_auc"):
            vals = [rng.rand(b).astype(np.float32),
                    rng.randint(0, 3, b).astype(np.float32),
                    rng.randint(0, 3, b)]
        elif kind == "sum_evaluator":
            vals = [rng.randn(b, 4).astype(np.float32)]
        elif kind == "sum_evaluator_seq":
            lens = rng.randint(1, 7, b).astype(np.int32)
            vals = [(rng.randn(b, 7, 3).astype(np.float32), lens)]
        elif kind == "column_sum":
            vals = [rng.randn(b, 4).astype(np.float32)]
        elif kind == "detection_map":
            det = np.zeros((b, 3, 7), np.float32)
            det[:, :, 1] = rng.randint(0, 3, (b, 3))
            det[:, :, 2] = rng.rand(b, 3)
            xy = rng.rand(b, 3, 2) * 0.5
            det[:, :, 3:5] = xy
            det[:, :, 5:7] = xy + 0.2 + 0.3 * rng.rand(b, 3, 2)
            gt = np.zeros((b, 2, 6), np.float32)
            gt[:, :, 0] = rng.randint(1, 3, (b, 2))
            gxy = rng.rand(b, 2, 2) * 0.5
            gt[:, :, 1:3] = gxy
            gt[:, :, 3:5] = gxy + 0.3
            gt[:, :, 5] = rng.rand(b, 2) < 0.2
            vals = [det.reshape(b, 21), gt]
        else:
            raise KeyError(kind)
        out.append((vals, n_real))
    return out


CASES = {
    "auc": lambda m, a: m.auc(a[0], a[1], num_buckets=64),
    "auc2": lambda m, a: m.auc(a[0], a[1]),
    "classification_error": lambda m, a: m.classification_error(a[0], a[1]),
    "classification_error_top2":
        lambda m, a: m.classification_error(a[0], a[1], top_k=2),
    "precision_recall": lambda m, a: m.precision_recall(a[0], a[1]),
    "precision_recall_pos":
        lambda m, a: m.precision_recall(a[0], a[1], positive_label=2),
    "chunk_IOB": lambda m, a: m.chunk(a[0], a[1], chunk_scheme="IOB",
                                      num_chunk_types=4),
    "chunk_IOE": lambda m, a: m.chunk(a[0], a[1], chunk_scheme="IOE",
                                      num_chunk_types=4),
    "chunk_IOBES": lambda m, a: m.chunk(a[0], a[1], chunk_scheme="IOBES",
                                        num_chunk_types=2),
    "chunk_plain": lambda m, a: m.chunk(a[0], a[1], chunk_scheme="plain",
                                        num_chunk_types=8),
    "ctc_error": lambda m, a: m.ctc_error(a[0], a[1]),
    "pnpair": lambda m, a: m.pnpair(a[0], a[1], a[2]),
    "rank_auc": lambda m, a: m.rank_auc(a[0], a[1], a[2]),
    "sum_evaluator": lambda m, a: m.sum_evaluator(a[0]),
    "sum_evaluator_seq": lambda m, a: m.sum_evaluator(a[0]),
    "column_sum": lambda m, a: m.column_sum(a[0], column=2),
    "detection_map": lambda m, a: m.detection_map(a[0], a[1]),
}
APPROX = {"auc", "auc2", "rank_auc", "detection_map"}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_evaluator_matches_jax(kind):
    nodes = [_Node(f"in{i}") for i in range(3)]
    j, t = CASES[kind](jev, nodes), CASES[kind](tev, nodes)
    assert [n.name for n in t.inputs] == [n.name for n in j.inputs]
    assert t.name == j.name
    for ev in (j, t):
        ev.start()
    for vals, n_real in _batches(kind):
        j.eval_batch(vals, n_real)
        t.eval_batch(vals, n_real)
        jr, tr = j.result(), t.result()
        assert sorted(tr) == sorted(jr)
        for k in jr:
            if kind in APPROX:
                np.testing.assert_allclose(tr[k], jr[k], rtol=RTOL_AUC,
                                           err_msg=k)
            else:
                assert tr[k] == jr[k], k
    assert str(t) == str(j)
    t.start()
    assert all(v == 0.0 for v in t.result().values())


@pytest.mark.parametrize("scheme,types", [("IOB", 3), ("IOE", 3),
                                          ("IOBES", 2), ("plain", 5)])
def test_extract_chunks_and_edit_distance(scheme, types):
    rng = np.random.RandomState(7)
    tag_num = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}[scheme]
    for _ in range(50):
        ids = rng.randint(-1, types * tag_num + 2, rng.randint(0, 15))
        assert tev.extract_chunks(ids, scheme, types) == \
            jev.extract_chunks(ids, scheme, types)
        a, b = rng.randint(0, 4, rng.randint(0, 8)), rng.randint(0, 4, 5)
        assert tev.edit_distance(a, b) == jev.edit_distance(a, b)


@pytest.mark.parametrize("kind", ["value", "maxid", "seq_text",
                                  "max_frame"])
def test_printers_print_what_jax_prints(kind):
    rng = np.random.RandomState(2)
    node = _Node("x")
    if kind in ("value", "maxid"):
        vals = [rng.rand(4, 3).astype(np.float32)]
        make = (lambda m, s: m.value_printer(node, stream=s)) \
            if kind == "value" else \
            (lambda m, s: m.maxid_printer(node, stream=s))
    elif kind == "seq_text":
        vals = [(rng.randint(0, 4, (4, 5)), np.array([5, 1, 3, 2]))]
        make = (lambda m, s: m.seq_text_printer(
            node, dict_data=["a", "b", "c"], stream=s))
    else:
        vals = [(rng.rand(4, 5, 1).astype(np.float32),
                 np.array([5, 1, 3, 2]))]
        make = (lambda m, s: m.max_frame_printer(node, stream=s))
    outs = []
    for m in (jev, tev):
        s = io.StringIO()
        ev = make(m, s)
        ev.start()
        ev.eval_batch(vals, 3)
        assert ev.result() == {}
        outs.append(s.getvalue())
    assert outs[1] == outs[0] and outs[0]


def test_tensor_inputs_reach_evaluators_as_numpy():
    """bf16 scores become float32; a SequenceBatch (data, lengths)."""
    rng = np.random.RandomState(3)
    p = rng.rand(6, 4).astype(np.float32)
    bf = torch.tensor(p).to(torch.bfloat16)
    got = tev._to_np(bf)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, bf.float().numpy())
    sb = SequenceBatch(torch.tensor(rng.randint(0, 5, (3, 4))),
                       torch.tensor([4, 1, 2], dtype=torch.int32))
    data, lens = tev._to_np(sb)
    np.testing.assert_array_equal(data, sb.data.numpy())
    np.testing.assert_array_equal(lens, [4, 1, 2])
    # the trainer's fetch: one byte buffer, every tensor back unchanged
    loss = torch.tensor(1.5)
    metrics = {"a": torch.tensor(0.25), "b": torch.tensor(2.0)}
    evals = {"bf": bf, "ids": torch.arange(7, dtype=torch.int32),
             "seq": sb, "f": torch.tensor(p)}
    l, m, host = TSGD._fetch_host(loss, metrics, evals)
    assert l == 1.5 and m == {"a": 0.25, "b": 2.0}
    assert torch.equal(host["bf"], bf) and host["bf"].dtype == torch.bfloat16
    assert torch.equal(host["ids"], evals["ids"])
    assert torch.equal(host["f"], evals["f"])
    assert isinstance(host["seq"], SequenceBatch)
    assert torch.equal(host["seq"].data, sb.data)
    assert torch.equal(host["seq"].lengths, sb.lengths)
    assert TSGD._fetch_host(loss, metrics) == (1.5, {"a": 0.25, "b": 2.0},
                                               {})


def _mlp(pkg):
    x = pkg.layer.data("x", pkg.data_type.dense_vector(6))
    h = pkg.layer.fc(x, size=8, act=pkg.activation.Relu(), name="h")
    out = pkg.layer.fc(h, size=3, act=pkg.activation.Softmax(), name="out")
    lbl = pkg.layer.data("y", pkg.data_type.integer_value(3))
    cost = pkg.layer.classification_cost(out, lbl, name="cost")
    evs = [pkg.evaluator.classification_error(out, lbl, name="err"),
           pkg.evaluator.auc(out, lbl, name="auc"),
           pkg.evaluator.precision_recall(out, lbl, name="pr"),
           pkg.evaluator.column_sum(out, column=2, name="col2")]
    return cost, evs


def _run(pkg, init_tar=None):
    pkg.init(use_tpu=False, seed=3)
    cost, evs = _mlp(pkg)
    params = pkg.create_parameters(pkg.Topology(cost))
    if init_tar is not None:
        params = pkg.Parameters.from_tar(io.BytesIO(init_tar))
    buf = io.BytesIO()
    params.to_tar(buf)
    tr = pkg.SGD(cost=cost, parameters=params,
                 update_equation=pkg.optimizer.Momentum(learning_rate=0.05,
                                                        momentum=0.9),
                 evaluators=evs)
    rng = np.random.RandomState(0)
    data = [(rng.randn(6).astype(np.float32), int(rng.randint(0, 3)))
            for _ in range(30)]
    events = []

    def handler(e):
        if isinstance(e, (pkg.event.EndIteration, pkg.event.EndPass)):
            events.append((type(e).__name__, dict(e.metrics)))

    reader = pkg.reader.batch(lambda: iter(data), 8)     # last batch of 6
    tr.train(reader, num_passes=2, event_handler=handler)
    res = tr.test(pkg.reader.batch(lambda: iter(data[:20]), 8))
    return buf.getvalue(), events, res


def test_sgd_with_evaluators_matches_jax():
    tar, jevents, jres = _run(jpaddle)
    _, tevents, tres = _run(paddle, init_tar=tar)
    assert [e[0] for e in tevents] == [e[0] for e in jevents]
    assert len(tevents) == 2 * (4 + 1)
    for (kind, tm), (_, jm) in zip(tevents, jevents):
        assert sorted(tm) == sorted(jm)
        for k in jm:
            if k == "cost" or k.startswith("auc") or k.startswith("col2"):
                np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL_PASS,
                                           err_msg=(kind, k))
            else:
                assert tm[k] == jm[k], (kind, k)
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=RTOL_PASS)
    assert sorted(tres.metrics) == sorted(jres.metrics)
    for k in jres.metrics:
        np.testing.assert_allclose(tres.metrics[k], jres.metrics[k],
                                   rtol=RTOL_PASS, err_msg=k)
    assert tres.metrics["err"] == jres.metrics["err"]
