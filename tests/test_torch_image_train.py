"""Port parity: ResNet-50 training over several steps, in bfloat16 and
in float32, against the JAX package's, on the CPU.

bench.py trains its image rows under ``compute_dtype="bfloat16"`` (its
``--dtype`` default): parameters and the optimizer stay float32, the
convolutions and products take bf16 inputs, and the activations between
layers are bf16. Single ops are held against JAX in bf16 in
test_torch_image_ops.py; this file holds their composition over a few
training steps.

One ResNet-50 (full depth, 64 x 64 as in __graft_entry__.py, 100
classes, batch 16) trains 8 steps of bench.py's Momentum on one
repeated batch in each package and dtype, from one init carried
through a ``paddle_tpu.params.v1`` tar. Training-mode batch norm
amplifies rounding layer by layer (see test_torch_image_models.py), so
the two trajectories drift apart even in float32: measured on the CPU,
the packages' float32 losses differ by up to 6.9% at a step, and their
bf16 losses by up to 6.1%. The first loss, the forward of one init,
lies 9.3e-6 apart in float32 and 0.92% in bf16. The bounds below are
about twice those (five times for the float32 forward, whose summation
order follows the thread count). A path that trained wrong (a gradient lost to bf16
rounding, an update that does not land) would leave the loss near its
start, several times as far.
"""

import io

import numpy as np
import pytest

import paddle_tpu as jpaddle
import torch
from paddle_tpu import models as jmodels
from paddle_tpu.core.registry import reset_name_counters as j_reset

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core.registry import reset_name_counters as t_reset

SIZE, BATCH, CLASSES, STEPS = 64, 16, 100, 8
FIRST_RTOL = {"float32": 5e-5, "bfloat16": 2e-2}
STEP_RTOL = 0.15       # each later loss: measured up to 6.9% (float32)
DROP_RTOL = 0.2        # the loss's fall over the 8 steps: measured 5.7%


@pytest.fixture(autouse=True)
def _restore():
    yield
    jpaddle.init(use_tpu=False, seed=0)
    tconfig.init(seed=0)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(BATCH, SIZE * SIZE * 3).astype(np.float32)
    lbl = rng.randint(0, CLASSES, BATCH)
    return [(img[i], int(lbl[i])) for i in range(BATCH)]


def _momentum(paddle):
    """bench.py:194 bench_image's optimizer at this batch."""
    return paddle.optimizer.Momentum(
        learning_rate=0.01 / BATCH, momentum=0.9,
        regularization=paddle.optimizer.L2Regularization(0.0005 * BATCH))


def _losses(paddle, models, reset, tar, batch, dtype, **where):
    reset()
    paddle.init(seed=0, compute_dtype=dtype, **where)
    spec = models.resnet50(height=SIZE, width=SIZE, num_classes=CLASSES)
    params = paddle.Parameters.from_tar(io.BytesIO(tar), **(
        {"device": "cpu"} if paddle is tpaddle else {}))
    trainer = paddle.SGD(cost=spec.cost, parameters=params,
                         update_equation=_momentum(paddle))
    return np.asarray([float(trainer.train_batch(batch)[0])
                       for _ in range(STEPS)]), trainer


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_resnet50_training_tracks_jax(dtype):
    j_reset()
    jpaddle.init(use_tpu=False, seed=0)
    spec = jmodels.resnet50(height=SIZE, width=SIZE, num_classes=CLASSES)
    buf = io.BytesIO()
    jpaddle.create_parameters(jpaddle.Topology(spec.cost)).to_tar(buf)
    tar, batch = buf.getvalue(), _batch()
    want, _ = _losses(jpaddle, jmodels, j_reset, tar, batch, dtype,
                      use_tpu=False)
    got, trainer = _losses(tpaddle, tmodels, t_reset, tar, batch, dtype,
                           use_gpu=False)
    assert trainer.device.type == "cpu"
    assert np.all(np.isfinite(got)), got
    np.testing.assert_allclose(got[0], want[0], rtol=FIRST_RTOL[dtype])
    np.testing.assert_allclose(got[1:], want[1:], rtol=STEP_RTOL)
    np.testing.assert_allclose(got[0] - got[-1], want[0] - want[-1],
                               rtol=DROP_RTOL)
    # the reference itself learns on this batch
    assert want[-1] < 0.75 * want[0], want
