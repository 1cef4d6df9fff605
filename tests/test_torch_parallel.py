"""Port parity: paddle_tpu_torch/parallel (mesh, comm, data_parallel,
tensor_parallel) and the trainer's mesh step against paddle_tpu on its
8 forced CPU devices, the port as spawned gloo worlds of 4 (8 for the
three-axis mesh) from one JAX weight tar and the same seeded batches
(tests/torch_dist.py).

The counterparts of tests/test_parallel.py:
- dp and dp x mp training of its MLP, costs and updated parameters;
- the sharding rules (spec_for, param_shardings, the shards' shapes,
  opt_state_shardings) on the names and shapes of test_param_placement;
- the five __graft_entry__ modes trained through SGD(mesh=): the tiny
  ResNet-50 under dp x mp (batch statistics over dp), the row-sparse
  table under dp x mp with Adam (global touched ids), the LM under
  dp x sp (ring attention), the MoE LM under dp x ep, and the MLP and
  the LM pipelined over dp x pp under GPipe with remat and 1F1B (the
  two schedules' losses equal, as the dryrun asserts);
- trainer_count: a dp mesh over the group, numerically the explicit
  mesh;
- dp x mp x sp composed on the LM (a world of 8);
- the island reconcile guard (in-process islands, one weight tar per
  island).
Plus the global-mean loss trap: a 6-row batch padded to 8 by the
memory executor (microbatch=4) under dp — ranks with unequal real rows.

Tolerances: the JAX package's own dp parity (rtol 2e-4, atol 2e-5) for
costs and parameters; 1e-5 between two port runs; rtol 1e-6 for the
island averages.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import paddle_tpu as jpaddle
from paddle_tpu.parallel import create_mesh as jmesh
from paddle_tpu.parallel import tensor_parallel as jtp
from tests import torch_dist as td
from tests.torch_dist import run_world

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def _port_device_restored():
    """The port's process device back to the default (the card) after
    each test: a test here that inits the CPU must not leave it to the
    next file's tests."""
    yield
    from paddle_tpu_torch import config as tconfig
    tconfig.init(seed=0)


def _tar(tmp, name, model, model_kw=None, seed=0):
    """The JAX init of ``model`` as a weight tar (its path)."""
    jpaddle.init(use_tpu=False, seed=seed)
    cost, _, extra_out = td.build(jpaddle, model, model_kw)
    params = jpaddle.create_parameters(
        jpaddle.Topology(cost, extra_outputs=extra_out))
    path = tmp / f"{name}.tar"
    with open(path, "wb") as f:
        params.to_tar(f)
    return str(path)


def jax_run(run, mesh_shape=None):
    """``run`` (tests/torch_dist.train_run's dict) through the JAX
    package on a mesh of ``mesh_shape`` (None: one device)."""
    jpaddle.init(use_tpu=False, seed=0,
                 trainer_count=run.get("trainer_count", 1))
    cost, extra, _ = td.build(jpaddle, run["model"], run.get("model_kw"))
    with open(run["tar"], "rb") as f:
        params = jpaddle.Parameters.from_tar(f)
    mesh = jmesh(mesh_shape) if mesh_shape else None
    tr = jpaddle.SGD(cost=cost, parameters=params, extra_layers=extra,
                     update_equation=td.optimizer(jpaddle, *run["opt"]),
                     mesh=mesh, **run.get("sgd", {}))
    losses = []
    batches = run["batches"]
    if run.get("steps"):
        for _ in range(run["steps"]):
            losses.append(float(tr.train_batch(list(batches[0]))[0]))
    else:
        tr.train(lambda: iter(batches), num_passes=run.get("passes", 1),
                 event_handler=lambda e: losses.append(e.cost)
                 if isinstance(e, jpaddle.event.EndIteration) else None,
                 **run.get("train_kw", {}))
    jpaddle.init(use_tpu=False, seed=0, trainer_count=1)
    return dict(losses=losses,
                params={k: np.asarray(v) for k, v in tr.parameters.raw.items()},
                state={k: np.asarray(v)
                       for k, v in tr.parameters.state.items()},
                mesh=None if tr.mesh is None else dict(tr.mesh.shape))


def assert_run_close(got, want, rtol=RTOL, atol=ATOL, state=False):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol,
                               atol=atol)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=rtol,
                                   atol=atol, err_msg=k)
    if state:
        for k, v in want["state"].items():
            np.testing.assert_allclose(got["state"][k], v, rtol=rtol,
                                       atol=atol, err_msg=k)


def _mlp_batches(n=64, seed=3):
    rng = np.random.RandomState(seed)
    feats = rng.randn(n, 32).astype("float32")
    labels = rng.randint(0, 8, n)
    return [[(feats[i], int(labels[i])) for i in range(n)]]


def _lm_batch(b, T, V, seed=0):
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(b):
        ids = rng.randint(0, V, T + 1)
        rows.append(([int(v) for v in ids[:T]], list(range(T)),
                     [int(v) for v in ids[1:]]))
    return [rows]


MOMENTUM = ("Momentum", {"learning_rate": 0.1, "momentum": 0.9})
ADAM = ("Adam", {"learning_rate": 1e-3})
LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_len=32)


# ------------------------------------------------------------ dp worlds

@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    tar = _tar(tmp, "mlp", "mlp")
    explicit = dict(model="mlp", tar=tar, mesh=[("dp", 4)], opt=MOMENTUM,
                    batches=_mlp_batches(), passes=3)
    implicit = dict(explicit, mesh=None, trainer_count=4)
    # the global-mean loss trap: 6 real rows padded to 8 (two
    # microbatches of 4), rank 1 holding 1 real row of the second
    padded = dict(model="mlp", tar=tar, mesh=[("dp", 2), ("mp", 2)],
                  opt=MOMENTUM, batches=[_mlp_batches(n=6, seed=5)[0]] * 2,
                  passes=1, train_kw={"microbatch": 4})
    runs = [explicit, implicit, padded]
    return runs, run_world(td.train_runs, 4, tmp, runs)


class TestDataParallel:
    def test_dp_matches_single_device(self, dp_world):
        runs, port = dp_world
        want = jax_run(runs[0], [("dp", 8)])
        single = jax_run(runs[0])
        np.testing.assert_allclose(want["losses"], single["losses"],
                                   rtol=RTOL, atol=ATOL)
        for rank in port:
            assert_run_close(rank[0], want)
        assert port[0][0]["mesh"] == {"dp": 4}

    def test_global_mean_loss_over_padded_rows(self, dp_world):
        """The loss and gradient are the GLOBAL masked mean: sums of the
        ranks' real rows over the global real-row count, not a mean of
        the ranks' means (rank 1 holds 1 real row of the second
        microbatch, rank 0 two)."""
        runs, port = dp_world
        want = jax_run(runs[2], [("dp", 4), ("mp", 2)])
        for rank in port:
            assert_run_close(rank[2], want)


class TestTrainerCountMesh:
    def test_trainer_count_builds_dp_mesh(self, dp_world):
        runs, port = dp_world
        want = jax_run(runs[1])
        assert want["mesh"] == {"dp": 4}
        for rank in port:
            assert rank[1]["mesh"] == {"dp": 4}
            assert np.isfinite(rank[1]["losses"]).all()
            assert_run_close(rank[1], want)

    def test_trainer_count_numerics_match_explicit_mesh(self, dp_world):
        _, port = dp_world
        for rank in port:
            np.testing.assert_allclose(rank[1]["losses"], rank[0]["losses"],
                                       rtol=1e-5)

    def test_trainer_count_without_group_warns_single_device(self):
        """No process group: the JAX package's one-device warning, and a
        trainer without a mesh."""
        import paddle_tpu_torch as tpaddle
        tpaddle.init(use_gpu=False, seed=0, trainer_count=4)
        try:
            cost, _, _ = td.build(tpaddle, "mlp")
            params = tpaddle.create_parameters(tpaddle.Topology(cost),
                                               device="cpu")
            with pytest.warns(UserWarning, match="trainer_count=4"):
                tr = tpaddle.SGD(cost=cost, parameters=params,
                                 update_equation=td.optimizer(tpaddle,
                                                              *MOMENTUM))
            assert tr.mesh is None
        finally:
            tpaddle.init(use_gpu=False, seed=0)


# ---------------------------------------------------- dp x mp, the graft

@pytest.fixture(scope="module")
def graft_world(tmp_path_factory):
    """The five __graft_entry__ modes (and the MLP under dp x mp and the
    sharding rules) in one world of 4."""
    tmp = tmp_path_factory.mktemp("graft")
    rng = np.random.RandomState(0)
    vocab = 4096
    # three steps over different row sets (the catch-up clock matters);
    # in each, rows 4-5 (dp rank 1's) repeat the ids of rows 0-1 (dp
    # rank 0's) with the other label: their row gradients are sums
    # across the dp ranks, and every mp owner updates rows of both
    sparse_batches = []
    for lo in (0, 2048, 1024):
        rows = [(int(rng.randint(lo, lo + 512)), int(rng.randint(2)))
                for _ in range(8)]
        rows[4:6] = [(i, 1 - y) for i, y in rows[0:2]]
        sparse_batches.append(rows)
    img = [[(rng.randn(32 * 32 * 3).astype("float32"), int(rng.randint(16)))
            for _ in range(4)]]
    lm_moe = dict(LM, moe_experts=4)
    runs = {
        "mlp_dp_mp": dict(model="mlp", tar=_tar(tmp, "mlp", "mlp"),
                          mesh=[("dp", 2), ("mp", 2)], opt=MOMENTUM,
                          batches=_mlp_batches(), passes=3),
        "resnet_dp_mp": dict(
            model="resnet", tar=_tar(tmp, "resnet", "resnet"),
            mesh=[("dp", 2), ("mp", 2)],
            opt=("Momentum", {"learning_rate": 1e-3, "momentum": 0.9}),
            batches=img, steps=2),
        "sparse_dp_mp": dict(
            model="sparse", model_kw={"vocab": vocab},
            tar=_tar(tmp, "sparse", "sparse", {"vocab": vocab}),
            mesh=[("dp", 2), ("mp", 2)], opt=("Adam", {"learning_rate": 1e-2}),
            batches=sparse_batches, passes=1),
        "lm_dp_sp": dict(model="lm", model_kw=LM,
                         tar=_tar(tmp, "lm", "lm", LM),
                         mesh=[("dp", 2), ("sp", 2)], opt=ADAM,
                         batches=_lm_batch(4, 16, 64), steps=2),
        "moe_dp_ep": dict(model="lm", model_kw=lm_moe,
                          tar=_tar(tmp, "moe", "lm", lm_moe),
                          mesh=[("dp", 2), ("ep", 2)], opt=ADAM,
                          batches=_lm_batch(4, 16, 64), steps=2),
        "mlp_dp_pp_gpipe": dict(
            model="pipe_mlp", tar=_tar(tmp, "pipe", "pipe_mlp"),
            mesh=[("dp", 2), ("pp", 2)],
            opt=("Momentum", {"learning_rate": 1e-2, "momentum": 0.9}),
            batches=[[(rng.randn(32).astype("float32"), int(rng.randint(4)))
                      for _ in range(16)]], passes=1,
            sgd={"pipeline_stages": [["pfc0", "pfc1"], ["pfc2", "pfc3"]],
                 "pipeline_remat": True}),
    }
    runs["convbn_dp_mp"] = dict(
        model="convbn", tar=_tar(tmp, "convbn", "convbn"),
        mesh=[("dp", 2), ("mp", 2)],
        opt=("Momentum", {"learning_rate": 1e-2, "momentum": 0.9}),
        batches=[[(rng.randn(3 * 8 * 8).astype("float32"),
                   int(rng.randint(4))) for _ in range(8)]], steps=2)
    runs["mlp_dp_pp_1f1b"] = dict(
        runs["mlp_dp_pp_gpipe"],
        sgd={"pipeline_stages": [["pfc0", "pfc1"], ["pfc2", "pfc3"]],
             "pipeline_schedule": "1f1b"})
    names = list(runs)
    emb = [("_emb0.w0", (100, 64)), ("_fc1.w0", (64, 64)),
           ("_fc1.wbias", (64,)), ("_fc2.w0", (64, 63)),
           ("_conv.w0", (3, 3, 8, 16)), ("_m.moe_up", (4, 8, 16))]
    items = [("train_run", {"run": runs[n]}) for n in names]
    items.append(("evaluator_run", {
        "tar": runs["mlp_dp_mp"]["tar"], "shape": [("dp", 2), ("mp", 2)],
        "batch": _mlp_batches(n=8, seed=11)[0]}))
    items.append(("spec_checks", {"shape": [("dp", 2), ("mp", 2)],
                                  "names_shapes": emb, "model": "mlp",
                                  "opt": ADAM}))
    res = run_world(td.scenario, 4, tmp, items)
    port = [dict(zip(names + ["evaluators", "specs"], r)) for r in res]
    return runs, port, emb


GRAFT_MESH = {"mlp_dp_mp": [("dp", 4), ("mp", 2)],
              "convbn_dp_mp": [("dp", 2), ("mp", 2)],
              "resnet_dp_mp": [("dp", 2), ("mp", 2)],
              "sparse_dp_mp": [("dp", 2), ("mp", 2)],
              "lm_dp_sp": [("dp", 2), ("sp", 2)],
              "moe_dp_ep": [("dp", 2), ("ep", 2)],
              "mlp_dp_pp_gpipe": [("dp", 2), ("pp", 2)],
              "mlp_dp_pp_1f1b": [("dp", 2), ("pp", 2)]}


class TestDataModelParallel:
    def test_dp_mp_matches_single_device(self, graft_world):
        runs, port, _ = graft_world
        want = jax_run(runs["mlp_dp_mp"], GRAFT_MESH["mlp_dp_mp"])
        single = jax_run(runs["mlp_dp_mp"])
        np.testing.assert_allclose(want["losses"], single["losses"],
                                   rtol=RTOL, atol=ATOL)
        for rank in port:
            assert_run_close(rank["mlp_dp_mp"], want)
            # the rank holds its mp column block of the fc weights
            held = rank["mlp_dp_mp"]
            assert held["params"]["_h.w0"].shape == (32, 64)


class TestShardingRules:
    def test_embedding_rows_sharded_fc_cols_sharded(self, graft_world):
        _, port, emb = graft_world
        mesh = jmesh([("dp", 4), ("mp", 2)])
        want = [tuple(jtp.spec_for(n, s, mesh)) for n, s in emb]
        assert want[:4] == [("mp", None), (None, "mp"), (), ()]
        for rank in port:
            assert rank["specs"]["spec_for"] == want

    def test_microbatch_shardings_split_rows_not_steps(self, graft_world):
        """A (k, mb) microbatched feed keeps the accumulation axis whole
        and splits each microbatch's rows over dp, as the JAX
        microbatch_shardings places it."""
        from paddle_tpu.parallel.data_parallel import microbatch_shardings
        _, port, _ = graft_world
        want = microbatch_shardings({"x": jnp.zeros((2, 8))},
                                    jmesh([("dp", 2), ("mp", 2)]))
        for i, rank in enumerate(port):
            got = rank["specs"]
            assert got["microbatch_specs"] == [tuple(want["x"].spec)] * 2
            d = i // 2          # the rank's dp index (rank = dp * 2 + mp)
            assert got["microbatch_rows"] == [
                [float(8 * j + 4 * d + r) for r in range(4)]
                for j in range(2)]

    def test_param_placement(self, graft_world):
        """param_shardings and opt_state_shardings agree with the JAX
        package's on test_param_placement's MLP; each rank holds its
        block of the sharded dims."""
        _, port, _ = graft_world
        mesh = jmesh([("dp", 4), ("mp", 2)])
        jpaddle.init(use_tpu=False, seed=0)
        cost, _, _ = td.build(jpaddle, "mlp")
        topo = jpaddle.Topology(cost)
        sh = jtp.param_shardings(topo.param_specs, mesh)
        params = jtp.shard_params(topo.init_params(), mesh, sh)
        opt = td.optimizer(jpaddle, *ADAM).bind(topo.param_specs)
        osh = jtp.opt_state_shardings(opt.init_state(params), sh, mesh)
        for rank in port:
            got = rank["specs"]
            assert got["param_specs"] == {k: tuple(v.spec)
                                          for k, v in sh.items()}
            assert got["shard_shapes"]["_h.w0"] == (32, 32)
            assert got["shard_shapes"]["_h.wbias"] == (64,)
            for k, slots in got["slot_specs"].items():
                for n, spec in slots.items():
                    assert spec == tuple(osh["slots"][k][n].spec), (k, n)
            assert got["step_spec"] == ()


def test_evaluators_see_the_global_batch(graft_world):
    """Host evaluators on a dp2 x mp2 mesh: every rank's classification
    error and gradient printers receive the whole batch's values — the
    activation gradients d(cost)/d(h) and d(cost)/d(out) summed over
    the ranks sharing the rows and gathered over dp — equal to the JAX
    package's on the same mesh (rtol 1e-5, atol 1e-6)."""
    import io
    runs, port, _ = graft_world
    jpaddle.init(use_tpu=False, seed=0)
    cost, _, _ = td.build(jpaddle, "mlp")
    topo = jpaddle.Topology(cost)
    h, out, lbl = (topo.get_layer(n) for n in ("h", "out", "y"))
    evs = [jpaddle.evaluator.classification_error(out, lbl),
           jpaddle.evaluator.gradient_printer(h, stream=io.StringIO()),
           jpaddle.evaluator.gradient_printer(out, name="gp_out",
                                              stream=io.StringIO())]
    seen = td._record(evs)
    with open(runs["mlp_dp_mp"]["tar"], "rb") as f:
        params = jpaddle.Parameters.from_tar(f)
    tr = jpaddle.SGD(cost=cost, parameters=params, evaluators=evs,
                     update_equation=jpaddle.optimizer.Momentum(
                         learning_rate=0.1),
                     mesh=jmesh([("dp", 2), ("mp", 2)]))
    tr.train(lambda: iter([_mlp_batches(n=8, seed=11)[0]]), num_passes=1,
             event_handler=lambda e: 0)
    for rank in port:
        got = rank["evaluators"]
        assert sorted(got["seen"]) == sorted(seen)
        for name, (vals, n_real) in seen.items():
            gvals, gn = got["seen"][name]
            assert gn == n_real == 8
            for a, b in zip(gvals, vals):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                           err_msg=name)
        assert got["error"] == evs[0].result()


@pytest.mark.parametrize("mode", ["sparse_dp_mp", "lm_dp_sp", "moe_dp_ep",
                                  "mlp_dp_pp_gpipe", "mlp_dp_pp_1f1b"])
def test_graft_mode_matches_jax(graft_world, mode):
    """Each __graft_entry__ mode trained through SGD(mesh=) on the same
    mesh shape as the JAX run: costs and every updated parameter. The
    row table's case is the global-touched-ids trap: ids shared across
    the dp ranks, rows owned by the other mp rank, Adam's lazy clock
    across steps that touch different rows; the MoE's routes over the
    global token order."""
    runs, port, _ = graft_world
    want = jax_run(runs[mode], GRAFT_MESH[mode])
    for rank in port:
        assert_run_close(rank[mode], want)


def test_graft_resnet_dp_mp(graft_world):
    """The tiny ResNet-50 under dp x mp, held against the JAX run on the
    same mesh on what is well conditioned: the first cost (rtol 2e-4)
    and the moving statistics after one step (rtol 2e-3, atol 1e-4 on
    statistics up to 0.2: the two packages' float32 statistics of these
    4 images differ by up to 7e-4 relative on one device already, where
    a rank's own 2 images would miss by far more). Its updated
    parameters are held by no one: at 32 x 32 and 4 images its training
    is chaotic (on one process, scaling the images by 1 + 1e-6 moves the
    port's second cost from 2.74 to 1.63), so two steps only have to
    stay finite. The tight batch-norm check is the next test's."""
    runs, port, _ = graft_world
    run = runs["resnet_dp_mp"]
    want = jax_run(dict(run, steps=1), GRAFT_MESH["resnet_dp_mp"])
    for rank in port:
        got = rank["resnet_dp_mp"]
        np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                                   rtol=RTOL)
        assert np.isfinite(got["losses"]).all()
        for k, v in want["state"].items():
            np.testing.assert_allclose(got["state1"][k], v, rtol=2e-3,
                                       atol=1e-4, err_msg=k)


def test_batch_norm_statistics_over_dp(graft_world):
    """The batch-norm trap, tight: batch_norm and conv_bn over 8 x 8
    maps (64 positions an image), 8 images on dp2 x mp2 — costs,
    parameters and moving statistics against the JAX run on the same
    mesh after two Momentum steps."""
    runs, port, _ = graft_world
    want = jax_run(runs["convbn_dp_mp"], GRAFT_MESH["convbn_dp_mp"])
    for rank in port:
        assert_run_close(rank["convbn_dp_mp"], want, state=True)


class TestGraftEntry:
    def test_dryrun_multichip(self, graft_world):
        """All five modes ran on every rank with finite costs, the two
        pipeline schedules' losses equal (the dryrun's check), and the
        row-sparse table's rows live on their mp owners."""
        _, port, _ = graft_world
        for rank in port:
            for mode in GRAFT_MESH:
                assert np.isfinite(rank[mode]["losses"]).all(), mode
            np.testing.assert_allclose(rank["mlp_dp_pp_gpipe"]["losses"],
                                       rank["mlp_dp_pp_1f1b"]["losses"],
                                       atol=1e-3)
            assert rank["sparse_dp_mp"]["held"]["_big_emb_w"] == (2048, 16)
            # the expert tables: E/ep experts a rank
            held = rank["moe_dp_ep"]["held"]
            assert all(v[0] == 2 for k, v in held.items()
                       if k.endswith((".moe_up", ".moe_down")))


# ---------------------------------------------------------- dp x mp x sp

def test_dp_mp_sp_transformer_matches_single_device(tmp_path):
    """tensor-parallel fc columns + ring attention over sp + dp in one
    mesh (dp2 x mp2 x sp2, a world of 8) reproduce the JAX numerics."""
    run = dict(model="lm", model_kw=LM, tar=_tar(tmp_path, "lm", "lm", LM),
               mesh=[("dp", 2), ("mp", 2), ("sp", 2)], opt=ADAM,
               batches=_lm_batch(4, 16, 64), steps=3)
    port = run_world(td.train_run, 8, tmp_path, run)
    want = jax_run(run, [("dp", 2), ("mp", 2), ("sp", 2)])
    for rank in port:
        assert_run_close(rank, want)


# ----------------------------------------------------- island reconcile

class TestIslandReconcileGuard:
    """AsyncSGDIsland.reconcile with in-process islands from the JAX
    islands' weight tars: the poisoned island dropped and healed, an
    all-poisoned group left alone, a healthy group averaged — each held
    against the JAX reconcile on the same weights."""

    def _islands(self, tmp_path, seeds):
        import paddle_tpu_torch as tpaddle
        from paddle_tpu_torch.trainer import Parameters
        out = []
        for s in seeds:
            tar = _tar(tmp_path, f"isl{s}", "mlp", seed=s)
            jpaddle.init(use_tpu=False, seed=s)
            jcost, _, _ = td.build(jpaddle, "mlp")
            with open(tar, "rb") as f:
                jp = jpaddle.Parameters.from_tar(f)
            jtr = jpaddle.SGD(cost=jcost, parameters=jp,
                              update_equation=jpaddle.optimizer.Momentum(
                                  learning_rate=0.1))
            tpaddle.init(use_gpu=False, seed=s)
            tcost, _, _ = td.build(tpaddle, "mlp")
            with open(tar, "rb") as f:
                tp = Parameters.from_tar(f, device="cpu")
            ttr = tpaddle.SGD(cost=tcost, parameters=tp,
                              update_equation=tpaddle.optimizer.Momentum(
                                  learning_rate=0.1), device="cpu")
            out.append((jtr, ttr))
        return out

    @staticmethod
    def _poison(pair, value):
        import torch
        jtr, ttr = pair
        k0 = sorted(jtr.parameters.raw)[0]
        bad = dict(jtr.parameters.raw)
        bad[k0] = jnp.full_like(bad[k0], value)
        jtr.parameters.replace(bad)
        with torch.no_grad():
            ttr.parameters.raw[k0].fill_(value)

    def _check(self, pairs):
        for jtr, ttr in pairs:
            for k, v in jtr.parameters.raw.items():
                np.testing.assert_allclose(
                    ttr.parameters.raw[k].detach().numpy(), np.asarray(v),
                    rtol=1e-6, atol=1e-7, err_msg=k)

    def test_poisoned_island_dropped_and_healed(self, tmp_path):
        from paddle_tpu.parallel.async_sgd import AsyncSGDIsland as JIsland
        from paddle_tpu_torch.parallel.async_sgd import AsyncSGDIsland
        from paddle_tpu_torch.utils.stats import global_counters
        pairs = self._islands(tmp_path, (0, 1, 2))
        self._poison(pairs[0], float("nan"))
        JIsland(pairs[0][0], sync_period=1,
                sync_group=[p[0].parameters for p in pairs]).reconcile()
        island = AsyncSGDIsland(pairs[0][1], sync_period=1,
                                sync_group=[p[1].parameters for p in pairs])
        before = global_counters.value("parallel/poisoned_islands")
        with pytest.warns(UserWarning, match="non-finite"):
            island.reconcile()
        assert global_counters.value(
            "parallel/poisoned_islands") == before + 1
        self._check(pairs)

    def test_all_poisoned_skips_reconcile(self, tmp_path):
        from paddle_tpu_torch.parallel.async_sgd import AsyncSGDIsland
        pairs = self._islands(tmp_path, (0, 1))
        for p in pairs:
            self._poison(p, float("inf"))
        island = AsyncSGDIsland(pairs[0][1], sync_period=1,
                                sync_group=[p[1].parameters for p in pairs])
        with pytest.warns(UserWarning, match="every island"):
            island.reconcile()
        k0 = sorted(pairs[0][1].parameters.raw)[0]
        assert not np.isfinite(
            pairs[0][1].parameters.raw[k0].detach().numpy()).any()

    def test_healthy_islands_unchanged_semantics(self, tmp_path):
        from paddle_tpu.parallel.async_sgd import AsyncSGDIsland as JIsland
        from paddle_tpu_torch.parallel.async_sgd import AsyncSGDIsland
        pairs = self._islands(tmp_path, (0, 1))
        JIsland(pairs[0][0], sync_period=1,
                sync_group=[p[0].parameters for p in pairs]).reconcile()
        leaves = {k: v for k, v in pairs[0][1].parameters.raw.items()}
        AsyncSGDIsland(pairs[0][1], sync_period=1,
                       sync_group=[p[1].parameters
                                   for p in pairs]).reconcile()
        self._check(pairs)
        # written in place: the trainer's autograd leaves are kept
        for k, v in pairs[0][1].parameters.raw.items():
            assert v is leaves[k] and v.requires_grad


def test_cli_train_trainer_count(tmp_path):
    """``cli.py train --trainer_count 2`` on each rank of a world of 2
    (the launcher's group): SGD trains on a dp2 mesh, every rank prints
    the same pass results, those of the single-process command (rtol
    1e-5)."""
    import re

    from tests.test_torch_cli_train import CONFIG
    cfg = tmp_path / "cfg.py"
    cfg.write_text(CONFIG.format(delay=0.0))
    argv = ["train", "--use_tpu=false", "--config", str(cfg),
            "--num_passes", "1", "--log_period", "100"]
    ranks = run_world(td.cli_train, 2, tmp_path, argv + ["--trainer_count",
                                                         "2"])
    single = td.cli_train(0, 1, argv)

    def pass_line(out):
        return [l for l in out.splitlines() if l.startswith("Pass 0 done")]

    assert single[0] == 0 and all(rc == 0 for rc, _ in ranks)
    want = pass_line(single[1])
    assert len(want) == 1
    for _, out in ranks:
        got = pass_line(out)
        assert got == pass_line(ranks[0][1])
        num = [float(v) for v in re.findall(r"[-+]?\d*\.\d+(?:e[-+]?\d+)?",
                                            got[0])]
        ref = [float(v) for v in re.findall(r"[-+]?\d*\.\d+(?:e[-+]?\d+)?",
                                            want[0])]
        np.testing.assert_allclose(num, ref, rtol=1e-5)
