"""Port parity: paddle_tpu_torch/parallel/sequence_parallel.py against
paddle_tpu's on its 8 forced CPU devices (sp8), the port as a spawned
gloo world of 4 (sp4; tests/torch_dist.py) on the same seeded q/k/v.

The counterparts of tests/test_sequence_parallel.py: ring attention
without a mask, causal, ragged, differentiable and under ``torch.no_grad`` (the
JAX test's inside-jit case); Ulysses attention without a mask and
causal-ragged, with its gradients too (gradients against ``jax.grad``
of the JAX package's plain attention, which test_sequence_parallel.py
holds the JAX ring to); and the transformer LM trained
over a dp2 x sp2 mesh (ring attention engaged by the attention layer),
its costs and parameters after two Adam steps against the JAX run on
the same mesh shape from one weight tar.

Tolerances: the JAX test's (rtol 2e-5, atol 2e-5) for outputs, 3e-4 /
3e-5 for gradients, and the JAX package's dp parity (rtol 2e-4, atol
2e-5) for training.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from paddle_tpu.parallel import SP_AXIS
from paddle_tpu.parallel import create_mesh as jmesh
from paddle_tpu.parallel import sequence_parallel as jsp
from tests import torch_dist as td
from tests.test_torch_parallel import _tar, assert_run_close, jax_run
from tests.torch_dist import run_world

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)


def _qkv(b=2, t=32, h=4, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype("float32") for _ in range(3)]


CASES = {
    "ring": dict(fn="ring", qkv=_qkv()),
    "ring_causal": dict(fn="ring", qkv=_qkv(seed=1), causal=True),
    "ring_ragged": dict(fn="ring", qkv=_qkv(seed=2), lengths=[17, 32]),
    "ring_grad": dict(fn="ring", qkv=_qkv(seed=3, t=16), causal=True,
                      grad=True),
    "ring_no_grad": dict(fn="ring", qkv=_qkv(seed=4)),
    "ulysses": dict(fn="ulysses", qkv=_qkv(t=32, h=8)),
    "ulysses_causal_ragged": dict(fn="ulysses", qkv=_qkv(t=32, h=8, seed=5),
                                  lengths=[20, 32], causal=True, grad=True),
}

LM = dict(vocab_size=50, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_len=16)


def _lm_rows(b=4, T=8):
    rng = np.random.RandomState(0)
    rows = []
    for _ in range(b):
        ids = rng.randint(0, 50, T + 1)
        rows.append(([int(v) for v in ids[:T]], list(range(T)),
                     [int(v) for v in ids[1:]]))
    return [rows]


@pytest.fixture(scope="module")
def sp_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    names = list(CASES)
    run = dict(model="lm", model_kw=LM, tar=_tar(tmp, "lm", "lm", LM),
               mesh=[("dp", 2), ("sp", 2)],
               opt=("Adam", {"learning_rate": 1e-3}), batches=_lm_rows(),
               steps=2)
    res = run_world(td.scenario, 4, tmp, [
        ("attention_cases", {"cases": [CASES[n] for n in names]}),
        ("train_run", {"run": run})])
    return [dict(zip(names, r[0])) for r in res], [r[1] for r in res], run


def _mask(case):
    """The [b, T, T] mask of a case (valid keys, causal)."""
    b, t = case["qkv"][0].shape[:2]
    lens = case.get("lengths") or [t] * b
    valid = jnp.arange(t)[None, :] < jnp.asarray(lens)[:, None]
    mask = jnp.broadcast_to(valid[:, None, :], (b, t, t))
    if case.get("causal"):
        mask = mask & jnp.tril(jnp.ones((t, t), bool))[None]
    return mask, valid


def _jax(case):
    """The JAX sharded function's output on sp8; with ``grad``, the
    gradients of sum(out ** 2) by ``jax.grad`` through the JAX package's
    plain ``attention`` (its padded query rows zeroed, the sharded
    functions' contract — test_sequence_parallel.py holds the JAX ring's
    gradients to it), which compiles in a fraction of the ring's time."""
    mesh = jmesh([(SP_AXIS, 8)])
    fn = jsp.ring_attention if case["fn"] == "ring" else \
        jsp.ulysses_attention
    q, k, v = (jnp.asarray(a) for a in case["qkv"])
    lens = None if case.get("lengths") is None else \
        jnp.asarray(case["lengths"], jnp.int32)
    out = fn(q, k, v, mesh, lengths=lens, causal=case.get("causal", False))
    grads = None
    if case.get("grad"):
        mask, valid = _mask(case)

        def loss(q, k, v):
            y = jsp.attention(q, k, v, mask=mask)
            return jnp.sum(jnp.where(valid[:, :, None, None], y, 0.0) ** 2)
        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), grads


def _check(sp_world, name, reference=None):
    ranks = sp_world[0]
    want, grads = _jax(CASES[name])
    if reference is not None:
        np.testing.assert_allclose(want, reference, **OUT_TOL)
    for rank in ranks:
        got = rank[name]
        np.testing.assert_allclose(got["out"], want, **OUT_TOL)
        if grads is not None:
            for a, b in zip(got["grads"], grads):
                np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL)


def _plain(case, mask=None):
    q, k, v = (jnp.asarray(a) for a in case["qkv"])
    return np.asarray(jsp.attention(q, k, v, mask=mask))


class TestRingAttention:
    def test_matches_full_attention(self, sp_world):
        _check(sp_world, "ring", _plain(CASES["ring"]))

    def test_causal(self, sp_world):
        b, t = CASES["ring_causal"]["qkv"][0].shape[:2]
        cm = jnp.tril(jnp.ones((t, t), bool))[None].repeat(b, 0)
        _check(sp_world, "ring_causal", _plain(CASES["ring_causal"], cm))

    def test_ragged_lengths(self, sp_world):
        _check(sp_world, "ring_ragged")

    def test_differentiable(self, sp_world):
        _check(sp_world, "ring_grad")

    def test_inside_no_grad(self, sp_world):
        _check(sp_world, "ring_no_grad", _plain(CASES["ring_no_grad"]))


class TestUlyssesAttention:
    def test_matches_full_attention(self, sp_world):
        _check(sp_world, "ulysses", _plain(CASES["ulysses"]))

    def test_causal_ragged(self, sp_world):
        _check(sp_world, "ulysses_causal_ragged")


class TestTransformerOverSpMesh:
    def test_transformer_lm_trains_on_dp_sp_mesh(self, sp_world):
        _, trained, run = sp_world
        want = jax_run(run, [("dp", 2), ("sp", 2)])
        for rank in trained:
            assert np.isfinite(rank["losses"]).all()
            assert_run_close(rank, want)
