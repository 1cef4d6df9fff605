"""Port parity: the port copy of demo/vae/vae_train.py against the JAX
demo on the CPU.

The copy in chip_smoke.py (``vae_v2_demo``, only its imports changed)
runs in both packages from one init tar at the JAX demo test's cut
(``--passes 6 --batches_per_pass 8``, tests/test_demos.py): the port's
batch costs track JAX's (the first 4 within 1e-4 relative, the 48 within
1e-3), and its ELBO drops as that test requires (the last pass under
0.7 of the first). The ELBO is built from the layer families'
``slope_intercept`` and ``dotmul`` with ``addto``.
"""

import numpy as np

import chip_smoke
import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import config as tconfig

PASSES, BATCHES = 6, 8


def test_vae_v2_script_tracks_jax_and_its_elbo_drops():
    quiet = lambda _: None  # noqa: E731
    try:
        j = chip_smoke.vae_v2_demo(jpaddle, use_tpu=False, passes=PASSES,
                                   batches_per_pass=BATCHES, echo=quiet)
        lines = []
        t = chip_smoke.vae_v2_demo(tpaddle, use_tpu=False, passes=PASSES,
                                   batches_per_pass=BATCHES,
                                   init_tar=j["init_tar"], echo=lines.append)
    finally:
        tconfig.init(seed=0)
    assert t["trainer"].device.type == "cpu"
    assert len(t["costs"]) == len(j["costs"]) == PASSES * BATCHES
    np.testing.assert_allclose(t["costs"][:4], j["costs"][:4], rtol=1e-4)
    np.testing.assert_allclose(t["costs"], j["costs"], rtol=1e-3)
    hist = np.asarray(t["hist"])
    assert np.isfinite(hist).all()
    assert hist[-1] < hist[0] * 0.7
    assert lines[0].startswith("pass 0: elbo_loss=")
    assert lines[-1].startswith("prior-sample abs mean:")
