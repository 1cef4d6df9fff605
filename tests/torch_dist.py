"""Spawned gloo worlds for the port's parallel parity tests, and the
per-rank workers they run.

``run_world(fn, world, tmp_path, *args)`` starts ``world`` processes
(``spawn``), each joining one gloo group through
``parallel.init_distributed`` over a file store under ``tmp_path`` (no
TCP port, so concurrent test workers cannot collide) with a 60 s
collective timeout, runs ``fn(rank, world, *args)`` on the CPU, and
returns the ranks' results in rank order. The parent polls the ranks
against a deadline: a rank that exits non-zero fails the world at once
with its exit code or signal, the status it wrote and its traceback,
and a world still running at the deadline is killed — a broken
collective fails its test, it never hangs the suite. Each rank records
its live threads after ``destroy_process_group()``
(``run_world(..., with_threads=True)`` returns them).

This module imports torch and the port only: the workers must not load
JAX (the parent test holds their results against it).
"""

from __future__ import annotations

import gc
import os
import pickle
import signal
import threading
import time
import traceback

import numpy as np
import torch

STORE_TIMEOUT_S = 60
DEADLINE_S = 300


def live_threads():
    """This process's live threads: the Python ones by name, and every
    native thread by its kernel name (gloo's ``gloo_tcp_loop`` and
    ``pt_gloo_runloop`` are C++ threads Python does not see)."""
    native = []
    for tid in sorted(os.listdir("/proc/self/task")):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                native.append(f.read().strip())
        except OSError:                 # the thread ended meanwhile
            pass
    return {"python": sorted(t.name for t in threading.enumerate()),
            "native": native}


def _write(out, record):
    """Write the rank's record whole: flushed and fsynced before the
    rank goes on to exit."""
    with open(out, "wb") as f:
        pickle.dump(record, f)
        f.flush()
        os.fsync(f.fileno())


def _child(fn, rank, world, store, out, args):
    torch.set_num_threads(1)
    try:
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.parallel import init_distributed
        paddle.init(use_gpu=False, seed=0)
        init_distributed(f"file://{store}", world, rank, device_type="cpu",
                         timeout_s=STORE_TIMEOUT_S)
        res = fn(rank, world, *args)
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
        gc.collect()
        _write(out, ("ok", res, live_threads()))
    except BaseException:
        _write(out, ("err", traceback.format_exc(), live_threads()))
        os._exit(1)


def run_world(fn, world, tmp_path, *args, deadline_s=DEADLINE_S,
              with_threads=False):
    """The ranks' results in rank order; with ``with_threads`` also each
    rank's ``live_threads()`` after its group was destroyed. A rank
    that exits non-zero fails the world with its exit code (or signal),
    what it wrote and its traceback."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tag = f"{fn.__name__}_{time.monotonic_ns()}"
    store = os.path.join(str(tmp_path), f"{tag}.store")
    outs = [os.path.join(str(tmp_path), f"{tag}.{r}.pkl")
            for r in range(world)]
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, store, outs[r], args))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                raise AssertionError(
                    _failure(bad[0], procs[bad[0]].exitcode, outs[bad[0]]))
            if time.monotonic() > end:
                raise AssertionError(
                    f"world {fn.__name__} still running after "
                    f"{deadline_s} s: killed")
            time.sleep(0.05)
        results, threads = [], []
        for r, p in enumerate(procs):
            record = _load(outs[r])
            if p.exitcode != 0 or record is None or record[0] != "ok":
                raise AssertionError(_failure(r, p.exitcode, outs[r]))
            results.append(record[1])
            threads.append(record[2])
        return (results, threads) if with_threads else results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)


def _load(path):
    """The rank's (status, value, threads) record, or None."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception:
        return None


def _exit_text(code):
    if code is None:
        return "still running"
    if code < 0:
        try:
            return f"killed by signal {signal.Signals(-code).name} ({-code})"
        except ValueError:
            return f"killed by signal {-code}"
    return f"exit code {code}"


def _failure(rank, code, path):
    """One rank's failure: its exit code or signal, whether it wrote a
    record and with which status, and its traceback when it wrote one."""
    return f"rank {rank} failed: {_exit_text(code)}; " + _read(path)


def _read(path):
    """What the rank wrote, as text (never raises)."""
    record = _load(path)
    if record is None:
        return "it wrote no result"
    status, val = record[0], record[1]
    if status == "ok":
        threads = record[2] if len(record) > 2 else None
        return (f"it wrote status 'ok' (a result), then exited; threads "
                f"alive after destroy_process_group(): {threads}")
    return f"it wrote status {status!r}:\n{val}"


def np_tree(tree):
    """Tensors of a nested dict/list as numpy arrays (picklable)."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


# ------------------------------------------------------------------ graphs
# Each graph function takes a package (paddle_tpu or paddle_tpu_torch) and
# returns (cost, extra_layers, extra_outputs); the same calls give the
# same layer and parameter names in both packages from reset counters.

def mlp_net(paddle):
    """test_parallel.py's _net: fc 32 -> 64 relu -> 8 softmax."""
    img = paddle.layer.data("x", paddle.data_type.dense_vector(32))
    h = paddle.layer.fc(img, size=64, act=paddle.activation.Relu(),
                        name="h")
    out = paddle.layer.fc(h, size=8, act=paddle.activation.Softmax(),
                          name="out")
    lbl = paddle.layer.data("y", paddle.data_type.integer_value(8))
    return paddle.layer.classification_cost(out, lbl, name="cost"), [], []


def pipe_mlp(paddle):
    """test_pipeline_sgd.py's _model: four fc 32 stages and a head."""
    x = paddle.layer.data("x", paddle.data_type.dense_vector(32))
    h = x
    for i in range(4):
        h = paddle.layer.fc(h, size=32, act=paddle.activation.Relu(),
                            name=f"pfc{i}")
    out = paddle.layer.fc(h, size=4, act=paddle.activation.Softmax(),
                          name="head")
    lbl = paddle.layer.data("y", paddle.data_type.integer_value(4))
    return paddle.layer.classification_cost(out, lbl, name="cost"), [], []


def _models(paddle):
    from importlib import import_module
    return import_module(paddle.__name__ + ".models")


def lm_net(paddle, **kw):
    spec = _models(paddle).transformer_lm(**kw)
    return spec.cost, [spec.output], [spec.output]


def resnet_net(paddle):
    """__graft_entry__'s tiny ResNet-50 (32 x 32, 16 classes)."""
    spec = _models(paddle).resnet(50, height=32, width=32, num_classes=16)
    return spec.cost, list(spec.extra_layers), []


def sparse_net(paddle, vocab, emb=16):
    """__graft_entry__'s row-sparse table (``_big_emb_w``) and a softmax."""
    from importlib import import_module
    registry = import_module(paddle.__name__ + ".core.registry")
    ids = paddle.layer.data("ids", paddle.data_type.integer_value(vocab))
    lbl = paddle.layer.data("y", paddle.data_type.integer_value(2))
    e = paddle.layer.embedding(ids, size=emb, name="big_emb",
                               param_attr=registry.ParamAttr(
                                   name="_big_emb_w", sparse=True))
    out = paddle.layer.fc(e, size=2, act=paddle.activation.Softmax())
    return paddle.layer.classification_cost(out, lbl), [], []


def convbn_net(paddle):
    """Batch norm on both code paths (batch_norm after img_conv, and
    conv_bn) over 8 x 8 images: its statistics couple the batch's rows."""
    img = paddle.layer.data("img", paddle.data_type.dense_vector(3 * 8 * 8),
                            height=8, width=8)
    c = paddle.layer.img_conv(img, filter_size=3, num_filters=8,
                              num_channels=3, padding=1, bias_attr=False)
    b = paddle.layer.batch_norm(c, act=paddle.activation.Relu())
    d = paddle.layer.conv_bn(b, filter_size=3, num_filters=8, padding=1,
                             act=paddle.activation.Relu())
    out = paddle.layer.fc(d, size=4, act=paddle.activation.Softmax())
    lbl = paddle.layer.data("y", paddle.data_type.integer_value(4))
    return paddle.layer.classification_cost(out, lbl), [], []


def island_net(paddle):
    """test_multihost.py's island: fc 8 -> 1 under mse."""
    x = paddle.layer.data("x", paddle.data_type.dense_vector(8))
    y = paddle.layer.data("y", paddle.data_type.dense_vector(1))
    return paddle.layer.mse_cost(paddle.layer.fc(x, size=1), y), [], []


GRAPHS = {"mlp": mlp_net, "convbn": convbn_net, "island": island_net,
          "pipe_mlp": pipe_mlp, "lm": lm_net, "resnet": resnet_net,
          "sparse": sparse_net}

STAGE_LAYERS = ("ln1", "q", "k", "v", "attn", "proj", "res1", "ln2", "up",
                "down", "res2")


def lm_stages(n):
    return [[f"tfm_l{i}_{s}" for s in STAGE_LAYERS] for i in range(n)]


def build(paddle, model, model_kw=None):
    from importlib import import_module
    import_module(paddle.__name__ + ".core.registry").reset_name_counters()
    return GRAPHS[model](paddle, **(model_kw or {}))


def optimizer(paddle, name, kw):
    return getattr(paddle.optimizer, name)(**kw)


# ----------------------------------------------------------------- workers

def train_run(rank, world, run):
    """One training run of ``run`` (a dict): ``model``/``model_kw``, the
    weight tar ``tar``, ``mesh`` ([(axis, size)] or None; "trainer_count"
    builds none and sets init(trainer_count=)), ``opt`` (name, kwargs),
    ``sgd`` (extra SGD kwargs), and ``batches`` trained for ``passes``
    passes through ``SGD.train`` (with ``train_kw``; or ``steps``
    train_batch calls on
    batches[0]). Returns the losses, the gathered parameters, the layer
    state (and after the first step, ``state1``), the trainer's mesh
    shape and the shapes the rank holds."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.parallel import create_mesh
    from paddle_tpu_torch.parallel.mesh import mesh_shape
    from paddle_tpu_torch.trainer import Parameters
    paddle.init(use_gpu=False, seed=0,
                trainer_count=run.get("trainer_count", 1))
    cost, extra, extra_out = build(paddle, run["model"], run.get("model_kw"))
    with open(run["tar"], "rb") as f:
        params = Parameters.from_tar(f, device="cpu")
    mesh = None
    if run.get("mesh"):
        mesh = create_mesh(run["mesh"], device_type="cpu")
    tr = paddle.SGD(cost=cost, parameters=params, extra_layers=extra,
                    update_equation=optimizer(paddle, *run["opt"]),
                    mesh=mesh, device="cpu", **run.get("sgd", {}))
    losses, metrics = [], []
    batches = run["batches"]
    state1 = None
    if run.get("steps"):
        for _ in range(run["steps"]):
            loss, m = tr.train_batch(list(batches[0]))
            losses.append(loss)
            metrics.append(m)
            if state1 is None:
                state1 = np_tree(dict(tr.parameters.state))
    else:
        def handler(e):
            if isinstance(e, paddle.event.EndIteration):
                losses.append(e.cost)
                metrics.append(dict(e.metrics))
        tr.train(lambda: iter(batches), num_passes=run.get("passes", 1),
                 event_handler=handler, **run.get("train_kw", {}))
    return dict(losses=losses, metrics=metrics,
                params=np_tree(tr.gathered_parameters()),
                state=np_tree(dict(tr.parameters.state)), state1=state1,
                mesh=None if tr.mesh is None else mesh_shape(tr.mesh),
                held={k: tuple(v.shape)
                      for k, v in tr.parameters.raw.items()})


def train_runs(rank, world, runs):
    """Several ``train_run``s in one world, in order."""
    return [train_run(rank, world, r) for r in runs]


def spec_checks(rank, world, shape, names_shapes, model=None, opt=None):
    """spec_for of each (name, shape) on the mesh ``shape``; with a
    ``model``: param_shardings' specs, the shards' shapes and
    opt_state_shardings' specs of ``opt``'s state over the shards."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.parallel import create_mesh
    from paddle_tpu_torch.parallel import tensor_parallel as tp
    from paddle_tpu_torch.parallel import data_parallel as dpm
    mesh = create_mesh(shape, device_type="cpu")
    out = {"spec_for": [tuple(tp.spec_for(n, s, mesh))
                        for n, s in names_shapes]}
    # a feed split into 2 microbatches of 8 rows: each keeps its rows'
    # dp block, never a share of the microbatches
    parts = [{"x": torch.arange(8.0) + 8 * j} for j in range(2)]
    out["microbatch_specs"] = [tuple(v.spec) for part in
                               dpm.microbatch_shardings(parts, mesh)
                               for v in part.values()]
    out["microbatch_rows"] = [p["x"].tolist() for p in
                              dpm.shard_microbatched_feed(parts, mesh)]
    if model is not None:
        cost, _, extra_out = build(paddle, model)
        topo = paddle.Topology(cost, extra_outputs=extra_out)
        sh = tp.param_shardings(topo.param_specs, mesh)
        shards = tp.shard_params(topo.init_params(device="cpu"), mesh, sh)
        o = optimizer(paddle, *opt).bind(topo.param_specs)
        state = o.init_state(shards)
        osh = tp.opt_state_shardings(state, sh, mesh)
        out["param_specs"] = {k: tuple(v.spec) for k, v in sh.items()}
        out["shard_shapes"] = {k: tuple(v.shape) for k, v in shards.items()}
        out["slot_specs"] = {k: {n: tuple(s.spec) for n, s in v.items()}
                             for k, v in osh["slots"].items()}
        out["step_spec"] = tuple(osh["step"].spec)
    return out


def scenario(rank, world, items):
    """Run ``items`` — (worker name, kwargs) pairs of this module — in
    one world, in order; returns their results."""
    return [globals()[name](rank, world, **kw) for name, kw in items]


def attention_cases(rank, world, cases):
    """Each case (dict: ``fn`` "ring" or "ulysses", ``qkv`` arrays,
    ``lengths``, ``causal``, ``grad``) through the port on an sp mesh
    of the world: the output, and with ``grad`` the gradients of
    sum(out ** 2) — each rank differentiates its 1/n share of the
    replicated loss and the shares are summed over sp, as the trainer
    sums a replicated gradient."""
    from paddle_tpu_torch.parallel import (comm, create_mesh,
                                           ring_attention, ulysses_attention)
    mesh = create_mesh([("sp", world)], device_type="cpu")
    out = []
    for c in cases:
        fn = ring_attention if c["fn"] == "ring" else ulysses_attention
        q, k, v = [torch.tensor(a, requires_grad=c.get("grad", False))
                   for a in c["qkv"]]
        lens = None if c.get("lengths") is None else \
            torch.tensor(c["lengths"], dtype=torch.int32)
        with torch.set_grad_enabled(c.get("grad", False)):
            y = fn(q, k, v, mesh, lengths=lens, causal=c.get("causal", False))
        res = {"out": y.detach().numpy()}
        if c.get("grad"):
            gs = torch.autograd.grad((y ** 2).sum() / world, [q, k, v])
            res["grads"] = [comm.all_reduce(g, mesh, "sp").numpy()
                            for g in gs]
        out.append(res)
    return out


def _tanh_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def pipeline_cases(rank, world, cases):
    """test_pipeline.py's stage (tanh(x @ w + b)) pipelined over pp =
    the world: each case (``w`` [n, d, d], ``b`` [n, d], ``x``, ``m``,
    ``grad``, ``remat``, ``loss``) gives the output, with ``loss``
    pipeline_loss's sum(y ** 2), and with ``grad`` the gradients of
    sum(y ** 2) — the stages' stacked over pp, x's summed over pp
    (stage 0 holds it)."""
    from paddle_tpu_torch.parallel import comm, create_mesh
    from paddle_tpu_torch.parallel.mesh import axis_index
    from paddle_tpu_torch.parallel.pipeline import pipeline, pipeline_loss
    mesh = create_mesh([("pp", world)], device_type="cpu")
    s = axis_index(mesh, "pp")
    out = []
    for c in cases:
        grad = c.get("grad", False)
        p = {k: torch.tensor(c[k][s], requires_grad=grad) for k in "wb"}
        x = torch.tensor(c["x"], requires_grad=grad)
        with torch.set_grad_enabled(grad):
            y = pipeline(_tanh_stage, p, x, mesh, num_microbatches=c.get("m"),
                         remat=c.get("remat", False))
        res = {"out": y.detach().numpy()}
        if c.get("loss"):
            # pipeline_loss: the same pipeline composed with sum(y ** 2)
            with torch.no_grad():
                res["loss"] = float(pipeline_loss(
                    _tanh_stage, lambda y: (y ** 2).sum())(
                        p, x, mesh, num_microbatches=c.get("m")))
        if grad:
            gw, gb, gx = torch.autograd.grad((y ** 2).sum() / world,
                                             [p["w"], p["b"], x])
            res["grads"] = {
                "w": comm.all_gather(gw[None], mesh, "pp").numpy(),
                "b": comm.all_gather(gb[None], mesh, "pp").numpy(),
                "x": comm.all_reduce(gx, mesh, "pp").numpy()}
        out.append(res)
    return out


def pipeline_memory(rank, world, ms, d=64, mb=8):
    """The peak count of saved stage inputs (pipeline.saved_peak) of a
    GPipe (remat) and a 1F1B backward at each microbatch count in
    ``ms``, over pp = the world."""
    from paddle_tpu_torch.parallel import create_mesh, pipeline as pl
    mesh = create_mesh([("pp", world)], device_type="cpu")
    w = {"w": torch.eye(d, requires_grad=True)}

    def stage(p, x):
        return torch.tanh(x @ p["w"])

    def tail_vjp(y, j):
        return (y * y).sum(), [2 * y], {}

    out = {"gpipe": [], "1f1b": []}
    for m in ms:
        x = torch.zeros((m * mb, d))
        y = pl.pipeline(stage, w, x, mesh, num_microbatches=m, remat=True)
        torch.autograd.grad((y ** 2).sum(), [w["w"]])
        out["gpipe"].append(pl.saved_peak["gpipe"])
        pl.pipeline_1f1b(stage, w, x, tail_vjp, mesh, num_microbatches=m)
        out["1f1b"].append(pl.saved_peak["1f1b"])
    return out


def stage_validation(rank, world):
    """The refusals of a pp mesh's SGD: stages that differ, and no stage
    map (the error messages)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.parallel import create_mesh
    mesh = create_mesh([("dp", world // 2), ("pp", 2)], device_type="cpu")
    cost, _, _ = build(paddle, "pipe_mlp")
    params = paddle.create_parameters(paddle.Topology(cost), device="cpu")
    errors = []
    for stages in ([["pfc0", "pfc1"], ["pfc2", "pfc3", "head"]], None):
        try:
            paddle.SGD(cost=cost, parameters=params,
                       update_equation=paddle.optimizer.Momentum(
                           learning_rate=0.1),
                       mesh=mesh, pipeline_stages=stages)
            errors.append(None)
        except (AssertionError, ValueError) as e:
            errors.append((type(e).__name__, str(e)))
    return errors


def multihost_sync(rank, world):
    """tests/multihost_worker.py's sync run: the same 16-row stream on
    every rank, each keeping its round-robin share (process_reader), the
    global batch assembled by global_batch over dp, two steps of a
    linear regression from zero weights (lr 0.1). Returns the losses and
    this rank's view of (rank, world, coordinator) and the batch."""
    from paddle_tpu_torch.parallel import (create_mesh, global_batch,
                                           init_distributed, is_coordinator,
                                           process_reader)
    from paddle_tpu_torch.parallel.mesh import batch_sharding
    me = init_distributed()                 # already formed: recorded
    mesh = create_mesh([("dp", world)], device_type="cpu")
    rng = np.random.RandomState(0)
    xs = rng.randn(16, 4).astype(np.float32)
    ys = rng.randn(16, 1).astype(np.float32)

    def reader():
        for i in range(16):
            yield xs[i], ys[i]

    local = list(process_reader(reader, rank, world)())
    spec = batch_sharding(mesh).spec
    x = global_batch(np.stack([s[0] for s in local[:4]]), mesh, spec)
    y = global_batch(np.stack([s[1] for s in local[:4]]), mesh, spec)
    w = torch.zeros((4, 1), requires_grad=True)
    losses = []
    for _ in range(2):
        loss = torch.mean((x @ w - y) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        with torch.no_grad():
            w -= 0.1 * g
        losses.append(float(loss))
    from paddle_tpu_torch.parallel.mesh import group_places
    return dict(losses=losses, me=me, coord=is_coordinator(),
                x=x.numpy(), n_local=len(local),
                places=[tuple(p) for p in group_places()])


def multihost_async(rank, world):
    """tests/multihost_worker.py's async run: islands on different data
    (seed 100 + rank), averaged every 4 of 12 steps (average_pytree)."""
    from paddle_tpu_torch.parallel import average_pytree
    rng = np.random.RandomState(100 + rank)
    w_true = torch.tensor(np.random.RandomState(9).randn(4, 1)
                          .astype(np.float32))
    w = torch.zeros((4, 1))
    syncs, losses = [], []
    for it in range(12):
        x = torch.tensor(rng.randn(32, 4).astype(np.float32))
        y = x @ w_true
        wl = w.clone().requires_grad_(True)
        loss = torch.mean((x @ wl - y) ** 2)
        (g,) = torch.autograd.grad(loss, [wl])
        w = (wl - 0.2 * g).detach()
        losses.append(float(loss))
        if (it + 1) % 4 == 0:
            w = average_pytree({"w": w})["w"]
            syncs.append(w.numpy().copy())
    return dict(syncs=syncs, losses=losses)


def poisoned_islands(rank, world, tar, batches, sync_period=2,
                     poison_step=3):
    """One AsyncSGDIsland a process (sync_group=None) over the process
    group, the regression net of test_multihost's islands from ``tar``;
    the last rank's parameters go NaN after step ``poison_step``: the
    reconcile drops its tree and heals it with the healthy average.
    Returns the parameters after each reconcile and the counter."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.parallel import AsyncSGDIsland
    from paddle_tpu_torch.trainer import Parameters
    from paddle_tpu_torch.utils.stats import global_counters
    cost, _, _ = build(paddle, "island")
    with open(tar, "rb") as f:
        params = Parameters.from_tar(f, device="cpu")
    tr = paddle.SGD(cost=cost, parameters=params,
                    update_equation=paddle.optimizer.Adam(
                        learning_rate=3e-2), device="cpu")
    island = AsyncSGDIsland(tr, sync_period=sync_period)
    after = []
    for step, batch in enumerate(batches[rank]):
        if rank == world - 1 and step == poison_step:
            with torch.no_grad():
                for v in params.raw.values():
                    v.fill_(float("nan"))
        island.train_batch(batch)
        if (step + 1) % sync_period == 0:
            after.append(np_tree(dict(params.raw)))
    return dict(after=after,
                poisoned=global_counters.value("parallel/poisoned_islands"))


def exit_after_result(rank, world, codes, linger_s=0.0):
    """Return a result, then end the process at interpreter exit with
    ``codes[rank]``: an int exit code, ``"kill"`` (SIGKILL) or None (a
    clean exit that lingers ``linger_s``) — a rank that wrote ``ok``
    and still failed."""
    import atexit
    import signal as sig
    code = codes[rank]
    if code == "kill":
        atexit.register(os.kill, os.getpid(), sig.SIGKILL)
    elif code is not None:
        atexit.register(os._exit, code)
    else:
        atexit.register(time.sleep, linger_s)
    return [rank, "done"]


def places_then_threads(rank, world):
    """Resolve the group's places (``group_places`` keeps them): the
    world's teardown must still end gloo's threads."""
    from paddle_tpu_torch.parallel import create_mesh
    from paddle_tpu_torch.parallel.mesh import group_places
    create_mesh([("dp", world)], device_type="cpu")
    return [tuple(p) for p in group_places()]


def moe_cases(rank, world, cases, shape):
    """ops.moe.moe_ffn on a mesh of ``shape`` (dp x ep): each case's
    global tokens ``x`` [n, d] split over dp (this rank passes its
    rows), the full expert tables (the function keeps this rank's
    experts), ``valid``, ``k``, ``capacity_factor``, ``mode``. Returns
    this rank's output rows, the aux loss, and with ``proj`` the
    gradients of sum(y * proj) — each rank's 1/R share differentiated,
    summed over the world (the x rows' over the ranks sharing them)."""
    from paddle_tpu_torch.ops import moe
    from paddle_tpu_torch.parallel import comm, create_mesh
    from paddle_tpu_torch.parallel.mesh import axis_index, axis_size
    mesh = create_mesh(shape, device_type="cpu")
    dp, ep = axis_size(mesh, "dp"), axis_size(mesh, "ep")
    me = axis_index(mesh, "dp")
    out = []
    for c in cases:
        n = c["x"].shape[0] // dp
        rows = slice(me * n, (me + 1) * n)
        leaves = {k: torch.tensor(c[k], requires_grad=True)
                  for k in ("gate_w", "w_up", "w_down")}
        x = torch.tensor(c["x"][rows], requires_grad=True)
        valid = None if c.get("valid") is None else \
            torch.tensor(c["valid"][rows])
        y, aux = moe.moe_ffn(x, valid, leaves["gate_w"], leaves["w_up"],
                             leaves["w_down"], k=c.get("k", 2),
                             capacity_factor=c.get("capacity_factor", 1.25),
                             mesh=mesh, dispatch_mode=c.get("mode", "auto"))
        res = {"y": y.detach().numpy(), "aux": float(aux), "rows": rows}
        if c.get("proj") is not None:
            loss = (y * torch.tensor(c["proj"][rows])).sum() / ep
            gs = torch.autograd.grad(loss, [x] + list(leaves.values()))
            res["dx"] = comm.all_reduce(gs[0], mesh, "ep").numpy()
            res["grads"] = {k: comm.all_reduce(g, mesh, ("dp", "ep"))
                            .numpy()
                            for k, g in zip(leaves, gs[1:])}
        out.append(res)
    return out


def cli_train(rank, world, argv):
    """``cli.main(argv)`` on this rank; returns (rc, its stdout)."""
    import contextlib
    import io
    from paddle_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _record(evs):
    """Wrap each evaluator's eval_batch to keep what it received."""
    seen = {}
    for ev in evs:
        def record(values, n_real, ev=ev, orig=ev.eval_batch):
            seen[ev.name] = ([np.asarray(v) for v in values], n_real)
            orig(values, n_real)
        ev.eval_batch = record
    return seen


def evaluator_run(rank, world, tar, shape, batch):
    """The MLP on a mesh of ``shape`` with a classification-error
    evaluator and gradient printers on ``h`` and ``out``: what each
    evaluator received in one step (every rank: the whole batch) and
    the error's result."""
    import io
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.parallel import create_mesh
    from paddle_tpu_torch.trainer import Parameters
    cost, _, _ = build(paddle, "mlp")
    topo = paddle.Topology(cost)
    h, out, lbl = (topo.get_layer(n) for n in ("h", "out", "y"))
    evs = [paddle.evaluator.classification_error(out, lbl),
           paddle.evaluator.gradient_printer(h, stream=io.StringIO()),
           paddle.evaluator.gradient_printer(out, name="gp_out",
                                             stream=io.StringIO())]
    seen = _record(evs)
    with open(tar, "rb") as f:
        params = Parameters.from_tar(f, device="cpu")
    tr = paddle.SGD(cost=cost, parameters=params, evaluators=evs,
                    update_equation=optimizer(paddle, "Momentum",
                                              {"learning_rate": 0.1}),
                    mesh=create_mesh(shape, device_type="cpu"), device="cpu")
    tr.train(lambda: iter([batch]), num_passes=1, event_handler=lambda e: 0)
    return dict(seen=seen, error=evs[0].result())
