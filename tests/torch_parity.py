"""Shared helpers of the port's parity tests: build one graph in both
packages, run it from one weight table on one feed, and hold the port's
outputs and gradients against JAX's.

``build(L)`` receives a package's layer DSL (``paddle_tpu.layer`` or
``paddle_tpu_torch.layer``) and returns the graph's output nodes; the
same calls give the same names in both packages when each starts from
reset name counters. The weights are the JAX package's init, carried to
the port through a ``paddle_tpu.params.v1`` tar. Gradients are those of
the sum of every float output times a fixed seeded projection.
"""

import importlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.core.registry import reset_name_counters as jreset
from paddle_tpu.trainer.data_feeder import DataFeeder as JFeeder
from paddle_tpu_torch.core.registry import reset_name_counters as treset
from paddle_tpu_torch.trainer import Parameters as TParameters
from paddle_tpu_torch.trainer.data_feeder import DataFeeder as TFeeder

RTOL, ATOL = 1e-4, 1e-5


def submodule(L, name):
    """The module ``name`` of the package whose DSL ``L`` is (e.g.
    ``submodule(L, "core.data_type")``), so one build runs in both."""
    return importlib.import_module(L.__name__.split(".")[0] + "." + name)


def build_both(build):
    """(JAX Topology, port Topology) of ``build``; their JSON is equal."""
    jreset()
    jout = build(jpaddle.layer)
    treset()
    tout = build(tpaddle.layer)
    jt = jpaddle.Topology(list(jout) if isinstance(jout, (list, tuple))
                          else jout)
    tt = tpaddle.Topology(list(tout) if isinstance(tout, (list, tuple))
                          else tout)
    assert json.loads(tt.serialize()) == json.loads(jt.serialize())
    return jt, tt


def table_of(jtopo, seed=3):
    """(numpy table, port tensors) of the JAX init, through a tar."""
    buf = io.BytesIO()
    jpaddle.Parameters(jtopo.init_params(jax.random.PRNGKey(seed))) \
        .to_tar(buf)
    buf.seek(0)
    raw = TParameters.from_tar(buf, device="cpu").raw
    return {k: v.numpy() for k, v in raw.items()}, raw


def feeds_of(jtopo, ttopo, samples, feeding=None):
    jfeed = JFeeder(jtopo.data_type(), feeding)(samples)
    jfeed.pop("__batch_size__")
    tfeed = TFeeder(ttopo.data_type(), feeding, device="cpu")(samples)
    tfeed.pop("__batch_size__")
    return jfeed, tfeed


def parts(v):
    """The arrays of a value: payload, then lengths / segment planes."""
    if hasattr(v, "lengths"):
        out = [v.data, v.lengths]
        if getattr(v, "segment_ids", None) is not None:
            out += [v.segment_ids, v.num_segments]
        return out
    return [v]


def np_of(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_values_close(tval, jval, name, rtol=RTOL, atol=ATOL):
    tp, jp = parts(tval), parts(jval)
    assert len(tp) == len(jp), name
    for i, (a, b) in enumerate(zip(tp, jp)):
        a, b = np_of(a), np_of(b)
        assert a.shape == b.shape, (name, i, a.shape, b.shape)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"{name}[{i}]")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{name}[{i}]")


def check_parity(build, samples, *, feeding=None, grads=True, mode="test",
                 rtol=RTOL, atol=ATOL, seed=3, edit=None):
    """Build, run and compare; returns (JAX outputs, port outputs).
    ``edit(table)`` may change the numpy weight table before both runs
    (values a layer's init leaves trivial, e.g. data_norm's
    statistics)."""
    jt, tt = build_both(build)
    table, raw = table_of(jt, seed)
    if edit is not None:
        table = edit(dict(table))
        raw = {k: torch.as_tensor(v) for k, v in table.items()}
    jfeed, tfeed = feeds_of(jt, tt, samples, feeding)
    jparams = {k: jnp.asarray(v) for k, v in table.items()}
    jout, _ = jt.forward(jparams, jt.init_state(), jfeed, mode=mode)
    leaves = {k: v.clone().requires_grad_() for k, v in raw.items()}
    tout, _ = tt.forward(leaves, tt.init_state(device="cpu"), tfeed,
                         mode=mode)
    assert sorted(tout) == sorted(jout)
    for k in jout:
        assert_values_close(tout[k], jout[k], k, rtol, atol)
    if not grads or not table:
        return jout, tout
    held = [k for k in sorted(jout)
            if np.issubdtype(np.asarray(parts(jout[k])[0]).dtype,
                             np.floating)]
    rng = np.random.RandomState(9)
    proj = {k: rng.randn(*np.shape(parts(jout[k])[0])).astype(np.float32)
            for k in held}

    def jloss(p):
        outs, _ = jt.forward(p, jt.init_state(), jfeed, mode="train",
                             output_names=held)
        return sum(jnp.sum(parts(outs[k])[0] * proj[k]) for k in held)

    jg = jax.grad(jloss)(jparams)
    outs, _ = tt.forward(leaves, tt.init_state(device="cpu"), tfeed,
                         mode="train", output_names=held)
    tloss = sum((parts(outs[k])[0] * torch.as_tensor(proj[k])).sum()
                for k in held)
    names = sorted(leaves)
    tg = torch.autograd.grad(tloss, [leaves[k] for k in names],
                             allow_unused=True)
    for k, g in zip(names, tg):
        got = np.zeros_like(table[k]) if g is None else g.numpy()
        np.testing.assert_allclose(got, np.asarray(jg[k]), rtol=rtol,
                                   atol=atol, err_msg=f"d/d{k}")
    return jout, tout


def seq_rows(rng, lengths, dim, integer=False, vocab=None):
    """One ragged column: a [len, dim] float array (or [len] ids) per
    length."""
    if integer:
        return [rng.randint(0, vocab, (n,)).astype(np.int32)
                for n in lengths]
    return [rng.randn(n, dim).astype(np.float32) for n in lengths]


def nested_rows(rng, splits, dim):
    """One nested column: per sample a list of [sub_len, dim] arrays."""
    return [[rng.randn(n, dim).astype(np.float32) for n in sample]
            for sample in splits]


def jax_nce_draws(jtopo, batch, mode="test", rng=None):
    """{nce layer name: the [batch, k] ids the JAX package draws for it}
    from its own ``ApplyContext.rng_for``, as numpy."""
    from paddle_tpu.core.registry import ApplyContext
    ctx = ApplyContext(mode, rng, {})
    return {l.name: np.array(jax.random.randint(
        ctx.rng_for(l.name), (batch, l.config.get("num_neg_samples", 10)),
        0, l.config["num_classes"]))
        for l in jtopo.layers if l.type == "nce"}


def use_draws(monkeypatch, draws):
    """Make the port's ``nce`` layers sample ``draws`` (by layer name)."""
    from paddle_tpu_torch.layers import cost_layers

    def sample(ctx, name, batch, k, num_classes, device):
        ids = torch.as_tensor(draws[name], device=device)
        assert ids.shape == (batch, k)
        return ids

    monkeypatch.setattr(cost_layers, "nce_sample_ids", sample)
