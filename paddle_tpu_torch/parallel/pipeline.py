"""Pipeline parallelism over the mesh's ``pp`` axis — the port of
``paddle_tpu/parallel/pipeline.py``: GPipe and 1F1B.

ParallelNeuralNetwork pinned layers to devices (``--parallel_nn``);
here rank s of the pp axis holds stage s's parameters and runs stage
s. The JAX package writes both schedules as one ``shard_map`` program
that every device runs masked, tick by tick; the port runs the same
ticks explicitly on each rank, computing only its own active slots,
and each tick's activation (or cotangent) hop is one point-to-point
exchange (``comm.send_recv``) that every rank issues in the same tick
order.

- :func:`pipeline` (GPipe): m + n - 1 forward ticks — rank s runs
  microbatch t - s at tick t — and the mirrored backward ticks, as one
  ``torch.autograd.Function``: its backward receives the cotangent of
  the output, runs the microbatches' backward in reverse tick order and
  returns the stage parameters' gradients and the input's (on stage 0;
  the prologue gradient). ``remat`` runs each stage under
  ``torch.utils.checkpoint``: only the stage inputs are kept, the
  interior is recomputed in the backward. The output is summed over pp
  from the last stage (``psum``), so every rank holds it.
- :func:`pipeline_1f1b`: microbatch j runs forward at stage s on tick
  j + s and backward on tick j + 2(n-1) - s, over m + 2(n-1) ticks, with
  a ring buffer of 2n-1 saved stage INPUTS (the backward recomputes the
  stage from its input): activation memory is O(stages), not
  O(microbatches). The loss head (``tail_vjp``) runs on the last rank
  only, the moment a microbatch's forward completes, and its cotangent
  enters the backward ring in the same tick.

The boundary between stages may be a pytree (a SequenceBatch): only its
float leaves ride the ring and are differentiated; its integer leaves
(lengths) are constants of each microbatch, re-attached by microbatch
index, which is sound only if each stage preserves the boundary's
structure, shapes and dtypes (checked on the first microbatch).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.utils.checkpoint

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.parallel import comm
from paddle_tpu_torch.parallel.mesh import PP_AXIS, axis_index, axis_size


# ----------------------------------------------------------- pytree codec

def _flatten(x):
    """(leaves, rebuild(leaves) -> a value like x) for a tensor, a
    SequenceBatch, or lists / tuples / dicts of them."""
    if isinstance(x, torch.Tensor):
        return [x], lambda l: l[0]
    if isinstance(x, SequenceBatch):
        has = [t is not None for t in (x.segment_ids, x.num_segments)]
        leaves = [x.data, x.lengths] + \
            [t for t, h in zip((x.segment_ids, x.num_segments), has) if h]

        def rebuild(l):
            it = iter(l[2:])
            extra = [next(it) if h else None for h in has]
            return SequenceBatch(l[0], l[1], *extra)
        return leaves, rebuild
    if isinstance(x, dict):
        keys = sorted(x)
        items = [x[k] for k in keys]
        leaves, rebuild = _flatten(items)
        return leaves, lambda l: dict(zip(keys, rebuild(l)))
    if isinstance(x, (list, tuple)):
        parts = [_flatten(v) for v in x]
        sizes = [len(p[0]) for p in parts]

        def rebuild(l):
            out, i = [], 0
            for (_, rb), n in zip(parts, sizes):
                out.append(rb(l[i:i + n]))
                i += n
            return type(x)(out)
        return [a for p in parts for a in p[0]], rebuild
    raise TypeError(f"unsupported pipeline boundary leaf {type(x)}")


def _structure(x):
    leaves, _ = _flatten(x)
    kind = type(x).__name__
    if isinstance(x, SequenceBatch):
        kind += f"{[t is not None for t in (x.segment_ids, x.num_segments)]}"
    return kind, len(leaves)


def is_dynamic_leaf(a: torch.Tensor) -> bool:
    """THE predicate for what rides the ring and is differentiated:
    floating leaves. Integer leaves are per-microbatch constants."""
    return a.is_floating_point()


def interleave_leaves(dyn, static, is_dyn):
    """Re-zip split leaves back into flat leaf order."""
    di, si, out = 0, 0, []
    for d in is_dyn:
        if d:
            out.append(dyn[di])
            di += 1
        else:
            out.append(static[si])
            si += 1
    return out


def _strip_static(y) -> List[torch.Tensor]:
    return [a for a in _flatten(y)[0] if is_dynamic_leaf(a)]


def _microbatch_codec(x, m: int):
    """(dyn [per leaf: m chunks], rebuild(dyn_mb, j), collect(dyn_full),
    b): the boundary split into m microbatches of its rows."""
    leaves, rebuild_tree = _flatten(x)
    b = leaves[0].shape[0]
    if b % m:
        raise ValueError(f"microbatches {m} must divide batch {b}")
    chunks = [list(a.chunk(m, dim=0)) for a in leaves]
    is_dyn = [is_dynamic_leaf(a) for a in leaves]
    dyn = [c for c, d in zip(chunks, is_dyn) if d]
    static = [c for c, d in zip(chunks, is_dyn) if not d]
    static_full = [a for a, d in zip(leaves, is_dyn) if not d]

    def rebuild(dyn_mb, j):
        return rebuild_tree(interleave_leaves(list(dyn_mb),
                                              [s[j] for s in static],
                                              is_dyn))

    def collect(dyn_full):
        return rebuild_tree(interleave_leaves(list(dyn_full), static_full,
                                              is_dyn))

    return dyn, rebuild, collect, b


def _assert_boundary_preserving(x_mb, y_mb):
    """Each stage must preserve the boundary: same structure, same leaf
    shapes and dtypes at microbatch size (the codec re-attaches the
    input's integer leaves to every stage's output)."""
    assert _structure(y_mb) == _structure(x_mb), (
        "stage_fn must preserve the boundary pytree structure: in "
        f"{_structure(x_mb)}, out {_structure(y_mb)}")
    for i, (a, o) in enumerate(zip(_flatten(x_mb)[0], _flatten(y_mb)[0])):
        assert (tuple(o.shape), o.dtype) == (tuple(a.shape), a.dtype), (
            f"stage_fn boundary leaf {i} changed "
            f"{tuple(a.shape)}/{a.dtype} -> {tuple(o.shape)}/{o.dtype}; "
            "the pipeline boundary must be shape- and dtype-preserving")


def _hop(vals, to, frm, like, mesh, axis):
    """One tick's hop of a microbatch's float leaves: send ``vals`` (or
    nothing) to stage ``to`` and receive leaves like ``like`` from stage
    ``frm`` (None: nothing). Returns the received leaves or None."""
    got = [comm.send_recv(None if vals is None else vals[i], mesh, axis,
                          to, frm, like=like[i]) for i in range(len(like))]
    return got if frm is not None else None


def _psum_from(vals, owner: bool, mesh, axis):
    """``vals`` of the owning rank on every rank of ``axis``."""
    return [comm.all_reduce(v if owner else torch.zeros_like(v), mesh, axis)
            for v in vals]


#: the peak count of microbatch stage inputs the last call of each
#: schedule held on this rank — its activation memory in units of one
#: stage input (GPipe keeps m; 1F1B at most 2n-1)
saved_peak = {"gpipe": 0, "1f1b": 0}


# -------------------------------------------------------------- GPipe

class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, *tensors):
        n_x = run["n_x"]
        xs, pvals = tensors[:n_x], tensors[n_x:]
        ys = run["forward"](list(xs), list(pvals))
        ctx.run = run
        return tuple(ys)

    @staticmethod
    def backward(ctx, *dys):
        dx, dp = ctx.run["backward"](list(dys))
        ctx.run = None
        return (None,) + tuple(dx) + tuple(dp)


def pipeline(stage_fn: Callable, stage_params: Dict[str, torch.Tensor], x,
             mesh, num_microbatches: Optional[int] = None,
             axis_name: str = PP_AXIS, remat: bool = False):
    """Run ``stage_fn`` as an n-stage GPipe pipeline over ``axis_name``.

    stage_fn(params, x_mb) -> y_mb, shape-preserving (a SequenceBatch
      boundary is supported, its integer leaves constants).
    stage_params: THIS rank's stage parameters (the JAX function takes
      the stacked [n_stages, ...] pytree sharded over pp; here stage s's
      slice lives on rank s).
    x: [batch, ...], every rank of the pp group holding it; split into
      ``num_microbatches`` (default n).
    remat: ``torch.utils.checkpoint`` each stage (boundaries kept,
      interiors recomputed).

    Returns the [batch, ...] output on every rank of the pp group;
    differentiable in x and stage_params."""
    n = axis_size(mesh, axis_name)
    s = axis_index(mesh, axis_name)
    m = num_microbatches or n
    dyn, rebuild, collect, b = _microbatch_codec(x, m)
    keys = list(stage_params)
    n_x = len(dyn)
    dyn_full = [torch.cat(c) for c in dyn]
    like = [c[0] for c in dyn]
    saved: List = [None] * m
    state = {}

    def run_stage(xl, pl, j):
        def fn(*flat):
            p = dict(zip(keys, flat[n_x:]))
            y = stage_fn(p, rebuild(flat[:n_x], j))
            if j == 0:
                _assert_boundary_preserving(rebuild(flat[:n_x], j), y)
            return tuple(_strip_static(y))
        if remat:
            return list(torch.utils.checkpoint.checkpoint(
                fn, *xl, *pl, use_reentrant=False))
        return list(fn(*xl, *pl))

    def forward(xs, pvals):
        chunks = [list(a.chunk(m, dim=0)) for a in xs]
        pl = [p.detach().requires_grad_(True) for p in pvals]
        outs = [None] * m
        recv = None
        saved_peak["gpipe"] = 0
        for t in range(m + n - 1):
            j = t - s
            y = None
            if 0 <= j < m:
                src = [c[j] for c in chunks] if s == 0 else recv
                xl = [a.detach().requires_grad_(True) for a in src]
                with torch.set_grad_enabled(grad):
                    y = run_stage(xl, pl, j)
                saved[j] = (xl, y)
                saved_peak["gpipe"] = max(saved_peak["gpipe"],
                                          sum(v is not None for v in saved))
                if s == n - 1:
                    outs[j] = [a.detach() for a in y]
            j_in = t + 1 - s
            recv = _hop(y if s < n - 1 else None, s + 1 if s < n - 1
                        and y is not None else None,
                        s - 1 if s > 0 and 0 <= j_in < m else None,
                        like, mesh, axis_name)
        state["pl"] = pl
        ys = [torch.cat([o[i] for o in outs]) if s == n - 1
              else torch.zeros_like(dyn_full[i]) for i in range(n_x)]
        with torch.no_grad():
            return _psum_from(ys, s == n - 1, mesh, axis_name)

    def backward(dys):
        with torch.no_grad():
            dys = [comm.all_reduce(d.contiguous(), mesh, axis_name)
                   for d in dys]
        dy_chunks = [list(d.chunk(m, dim=0)) for d in dys]
        pl = state["pl"]
        g_acc = [None] * len(pl)
        dx = [None] * m
        recv = None
        for t in range(m + n - 1):
            j = m - 1 - (t - (n - 1 - s))
            dxj = None
            if 0 <= j < m:
                g_in = [c[j] for c in dy_chunks] if s == n - 1 else recv
                xl, y = saved[j]
                gs = torch.autograd.grad(y, xl + pl, g_in,
                                         allow_unused=True)
                saved[j] = None
                dxj = [torch.zeros_like(a) if g is None else g
                       for a, g in zip(xl, gs[:n_x])]
                for i, g in enumerate(gs[n_x:]):
                    if g is not None:
                        g_acc[i] = g if g_acc[i] is None else g_acc[i] + g
                if s == 0:
                    dx[j] = dxj
            j_in = m - 1 - (t - (n - 2 - s))
            recv = _hop(dxj if s > 0 else None,
                        s - 1 if s > 0 and dxj is not None else None,
                        s + 1 if s < n - 1 and 0 <= j_in < m else None,
                        like, mesh, axis_name)
        dx_full = [torch.cat([d[i] for d in dx]) if s == 0
                   else torch.zeros_like(dyn_full[i]) for i in range(n_x)]
        dp = [torch.zeros_like(p) if g is None else g
              for p, g in zip(pl, g_acc)]
        return dx_full, dp

    # a forward without autograd (a test pass) keeps no stage graph
    grad = torch.is_grad_enabled()
    run = {"n_x": n_x, "forward": forward, "backward": backward}
    ys = _GPipe.apply(run, *dyn_full, *[stage_params[k] for k in keys])
    return collect(list(ys))


# --------------------------------------------------------------- 1F1B

def pipeline_1f1b(stage_fn: Callable, stage_params: Dict[str, torch.Tensor],
                  x, tail_vjp: Callable, mesh,
                  num_microbatches: Optional[int] = None,
                  axis_name: str = PP_AXIS, tail_args=()):
    """One-forward-one-backward schedule (PipeDream-flush / Megatron
    1F1B), hand-scheduled.

    stage_fn(params, x_mb) -> y_mb, shape-preserving; stage_params: this
      rank's stage parameters.
    tail_vjp(y_mb, j, *tail_args) -> (loss_j, dy_mb, dtail): the
      per-microbatch loss head and its gradients, called on the LAST
      rank the tick microbatch j's forward completes. tail_args[0] is
      the {name: tensor} dict the tail differentiates: dtail has its
      keys.

    Returns (loss_sum, y [batch, ...], stage_grads {name: grad} of this
    rank's stage, dtail_sum, dx) — loss_sum, y, dtail_sum and dx (the
    cotangent of x's float leaves, [batch, ...] each: the PROLOGUE
    gradient when x was computed by earlier layers) on every rank of
    the pp group."""
    n = axis_size(mesh, axis_name)
    s = axis_index(mesh, axis_name)
    m = num_microbatches or n
    dyn, rebuild, collect, b = _microbatch_codec(x, m)
    keys = list(stage_params)
    pl = [stage_params[k].detach().requires_grad_(True) for k in keys]
    n_x = len(dyn)
    ring = 2 * n - 1
    like = [c[0] for c in dyn]
    last = s == n - 1

    def stage_dyn(xl, j):
        y = stage_fn(dict(zip(keys, pl)), rebuild(xl, j))
        if j == 0:
            _assert_boundary_preserving(rebuild(xl, j), y)
        return _strip_static(y)

    inbuf: List = [None] * ring
    youts: List = [None] * m
    dxs: List = [None] * m
    g_acc = [None] * len(pl)
    loss_sum = torch.zeros((), dtype=torch.float32, device=like[0].device)
    dtail = None
    x_state = dy_state = None
    saved_peak["1f1b"] = 0
    for t in range(m + 2 * (n - 1)):
        # ---- forward slot: microbatch fj = t - s
        fj = t - s
        y = None
        if 0 <= fj < m:
            x_in = [c[fj] for c in dyn] if s == 0 else x_state
            inbuf[fj % ring] = [a.detach() for a in x_in]
            saved_peak["1f1b"] = max(saved_peak["1f1b"],
                                     sum(v is not None for v in inbuf))
            with torch.no_grad():
                y = stage_dyn(x_in, fj)
            dy_tail = None
            if last:
                youts[fj] = y
                loss_j, dy_t, dt_j = tail_vjp(rebuild(y, fj), fj,
                                              *tail_args)
                loss_sum = loss_sum + loss_j.detach().float()
                dy_tail = _strip_static(dy_t)
                dtail = dt_j if dtail is None else \
                    {k: dtail[k] + dt_j[k] for k in dtail}
        # ---- backward slot: microbatch bj = t - 2(n-1) + s
        bj = t - 2 * (n - 1) + s
        dxj = None
        if 0 <= bj < m:
            dy_in = dy_tail if last else dy_state
            xl = [a.requires_grad_(True) for a in inbuf[bj % ring]]
            with torch.enable_grad():
                yb = stage_dyn(xl, bj)
            gs = torch.autograd.grad(yb, xl + pl, dy_in, allow_unused=True)
            inbuf[bj % ring] = None
            dxj = [torch.zeros_like(a) if g is None else g
                   for a, g in zip(xl, gs[:n_x])]
            for i, g in enumerate(gs[n_x:]):
                if g is not None:
                    g_acc[i] = g if g_acc[i] is None else g_acc[i] + g
            if s == 0:
                dxs[bj] = dxj
        # ---- hops: activations up, cotangents down
        f_in = t + 1 - s
        x_state = _hop(y if s < n - 1 else None,
                       s + 1 if s < n - 1 and y is not None else None,
                       s - 1 if s > 0 and 0 <= f_in < m else None,
                       like, mesh, axis_name)
        b_in = t - 2 * (n - 1) + s + 1
        dy_state = _hop(dxj if s > 0 else None,
                        s - 1 if s > 0 and dxj is not None else None,
                        s + 1 if s < n - 1 and 0 <= b_in < m else None,
                        like, mesh, axis_name)
    with torch.no_grad():
        full_like = [torch.cat(c) for c in dyn]
        ys = [torch.cat([o[i] for o in youts]) if last
              else torch.zeros_like(full_like[i]) for i in range(n_x)]
        ys = _psum_from(ys, last, mesh, axis_name)
        dx = [torch.cat([d[i] for d in dxs]) if s == 0
              else torch.zeros_like(full_like[i]) for i in range(n_x)]
        dx = _psum_from(dx, s == 0, mesh, axis_name)
        loss_sum = _psum_from([loss_sum], last, mesh, axis_name)[0]
        dkeys = sorted(tail_args[0]) if tail_args else []
        dvals = [dtail[k] if last else torch.zeros_like(tail_args[0][k])
                 for k in dkeys]
        dvals = _psum_from(dvals, last, mesh, axis_name)
    grads = {k: torch.zeros_like(p) if g is None else g
             for k, p, g in zip(keys, pl, g_acc)}
    return (loss_sum, collect(ys), grads, dict(zip(dkeys, dvals)), dx)


def pipeline_loss(stage_fn: Callable, loss_fn: Callable):
    """pipeline + loss as one differentiable objective:
    loss_fn(y, *args) on the pipeline output."""
    def objective(stage_params, x, mesh, *loss_args, **kw):
        y = pipeline(stage_fn, stage_params, x, mesh, **kw)
        return loss_fn(y, *loss_args)
    return objective


# ------------------------------------------------------ topology stages

def topology_stages(topology, stage_names):
    """The pipeline pieces of a Topology-defined model.

    stage_names: one list of layer names per pp rank — the explicit
    stage map (ParallelNeuralNetwork's per-layer ``deviceId``).
    Constraints (asserted, as in the JAX package): structurally
    identical stages (layer types, parameter shapes, internal wiring);
    each stage a DAG whose layers consume in-stage values or the single
    BOUNDARY input (the previous stage's last layer; stage 0's is a
    data layer or a computed layer outside the stages); the stage
    output its LAST layer; no stateful layer and no dropout inside.

    Returns (stage_fn, stack_params, body_names, x_src, body_end):
      stage_fn(slot_params, x) replays stage 0's DAG with substituted
        parameters (slot names: stage 0's parameter names);
      stack_params(params, stage=None): {slot name: [n_stages, ...]
        stack}, or with ``stage`` that stage's {slot name: tensor};
        ``.unstack(slot_grads, stage)`` -> {global name: grad},
        ``.param_names`` every body parameter, ``.names_of(stage)``
        the parameters of one stage;
      body_names, x_src (the boundary feeding the pipeline), body_end
        (the last stage's last layer)."""
    from paddle_tpu_torch.core.registry import ApplyContext, get_layer_impl

    by_name = topology.by_name
    n = len(stage_names)
    sigs = []
    x_src = None
    for si, st in enumerate(stage_names):
        boundary = stage_names[si - 1][-1] if si > 0 else None
        in_stage = {nm: k for k, nm in enumerate(st)}
        sig = []
        for li, nm in enumerate(st):
            l = by_name[nm]
            assert not l.states, \
                f"stateful layer {nm!r} unsupported inside a pipeline stage"
            assert l.type != "dropout", \
                f"dropout ({nm!r}) unsupported inside a pipeline stage — " \
                "the stage context has no per-step rng (put dropout in " \
                "the tail, or between body and head)"
            wiring = []
            for p in l.parents:
                if p.name in in_stage:
                    assert in_stage[p.name] < li, \
                        f"{nm!r} consumes {p.name!r} before it is " \
                        "computed — list stage layers in topo order"
                    wiring.append(in_stage[p.name])
                else:
                    if boundary is None:
                        boundary = p.name
                    assert p.name == boundary, \
                        f"{nm!r} consumes {p.name!r} from outside the " \
                        f"stage; the only allowed external input is the " \
                        f"boundary {boundary!r}"
                    wiring.append(-1)
            sig.append((l.type, tuple(wiring),
                        tuple(tuple(ps.shape) for ps in l.params)))
        sigs.append(tuple(sig))
        if si == 0:
            x_src = boundary
    assert all(sg == sigs[0] for sg in sigs), \
        "pipeline stages must be structurally identical"
    assert x_src not in {nm for st in stage_names for nm in st}, \
        f"the stage-0 boundary {x_src!r} cannot itself be a stage layer"

    name_matrix = [[ps.name for nm in st for ps in by_name[nm].params]
                   for st in stage_names]
    slot_names = name_matrix[0]
    stage0 = [by_name[nm] for nm in stage_names[0]]
    wiring0 = [w for (_, w, _) in sigs[0]]

    def stage_fn(slot_params, x):
        ctx = ApplyContext("train", {}, None)
        vals = []
        for l, wires in zip(stage0, wiring0):
            impl = get_layer_impl(l.type)
            lp = {ps.name: slot_params[ps.name] for ps in l.params}
            ins = [x if w < 0 else vals[w] for w in wires]
            vals.append(impl["apply"](ctx, l.name, l.config, lp, ins))
        return vals[-1]

    def stack_params(params, stage=None):
        if stage is not None:
            return {slot_names[j]: params[name_matrix[stage][j]]
                    for j in range(len(slot_names))}
        return {slot_names[j]: torch.stack(
            [params[name_matrix[i][j]] for i in range(n)])
            for j in range(len(slot_names))}

    def unstack(slot_grads, stage):
        return {name_matrix[stage][j]: slot_grads[slot_names[j]]
                for j in range(len(slot_names))}

    stack_params.unstack = unstack
    stack_params.param_names = {nm for row in name_matrix for nm in row}
    stack_params.names_of = lambda stage: set(name_matrix[stage])
    body_names = [nm for st in stage_names for nm in st]
    return stage_fn, stack_params, body_names, x_src, stage_names[-1][-1]
