"""SGD trainer — the port of the plain train loop of
``paddle_tpu/trainer/trainer.py``.

One step is: feed conversion, ``Topology.forward`` (seeded for the
random layers by ``init(seed=)`` and the step count), the masked
per-row cost summed and divided by the real row count,
``torch.autograd.grad`` over this trainer's parameter tensors (autograd
leaves), and ``optimizer.update``, which writes the new values into
those tensors under ``no_grad``; the new state (batch norm's moving
statistics) is kept detached from the step's graph.

Row-sparse tables (``ParamAttr(sparse=True)`` embeddings whose ids come
from a data layer, ``Topology.sparse_tables``) take the row path: the
step prefetches each table's touched rows with the optimizer's
catch-up (under ``no_grad``), makes the row blocks fresh autograd
leaves, looks ids up inside them (``sparse_sub``), differentiates the
dense parameters and the row blocks — never the tables — and hands the
row gradients to ``optimizer.update(sparse_rows=)``, which writes only
those rows back. No ``[vocab, emb]`` gradient exists. The loss, the metrics and the
evaluators' inputs come back to the host in one transfer per step.
PyTorch runs the step eagerly where the JAX package jits it.

Evaluators (``evaluators=[...]``, paddle_tpu_torch/evaluator) are host
accumulators: their input layers become extra outputs of the step, and
the rows below the batch's real count feed them. ``test`` evaluates the
optimizer's ``test_params`` (the model average when it is on, the
sparse tables caught up to the current step);
``save_pass`` writes ``pass-%05d/params.tar``. An evaluator that
``wants_gradient`` (the gradient printer) gets d(cost)/d(activation)
of its input layers: the step adds a zero tap to each such output
(``Topology.forward(taps=)``) and differentiates it beside the
parameters, in the same backward pass.

``train`` carries the single trainer's infrastructure: full-state
checkpoints (``checkpoint_manager`` / ``checkpoint_dir``,
``checkpoint_period``, trainer/checkpoint.py) with ``auto_resume`` —
the pass, the position in it (a checkpointable reader seeks its
source) and the optimizer's counters all resume; the guarded step
(``fault_policy``, trainer/fault.py): a step whose cost or new values
are not finite leaves parameters, slots, layer state and the
optimizer's counters as they were, and a streak rolls back to the
newest checkpoint; adaptive microbatching (``microbatch``,
``oom_probe``, trainer/memory.py): a step that runs out of device
memory re-runs as accumulated microbatches. With no evaluator attached
the loop never waits for the card: its events are lazy and the pass
sums stay on the device (compensated); a bounded thread converts the
next batches meanwhile (``_prefetched``).

The elastic fleet: ``train(coordinator=, chunk_reader=, worker_id=)``
reads coordinator-dispatched tasks (trainer/coordinator.py), joins and
leaves the fleet's membership and shares its MemoryPlan.

A device mesh (``mesh=``, parallel/mesh.py; or ``init(trainer_count=)``
over an initialized process group) runs the step as one rank of the
global program the JAX package jits over the mesh. Every rank feeds the
same GLOBAL batch and keeps its dp block of it; its loss is the masked
cost of its rows (by global index) over the GLOBAL real-row count,
divided by R, the ranks that share those rows (the live mp, sp, ep and
pp axes), so the world's losses sum to the global loss and autograd
through the differentiable collectives (parallel/comm.py) gives each
rank its share of every gradient. Each gradient is then summed over the
axes its parameter is replicated on (one all-reduce per group of
parameters), and the optimizer updates what the rank holds: whole
replicated parameters, its shard of each mp/ep-sharded one (and their
slots), its pipeline stage's. The reported loss and metrics are summed
over dp, the evaluators' inputs gathered over dp. Row-sparse tables
under mp take their touched ids from the global batch; each row block
comes from its owner shard (with the optimizer's catch-up), and each
owner updates only its rows. Pipelined models (``pipeline_stages``,
one list of layer names per pp rank) run GPipe (optionally with
``pipeline_remat``) or 1F1B (``pipeline_schedule``) over
``pipeline_microbatches``. Under a mesh, ``test`` runs the same sharded
forward, ``gathered_parameters`` assembles the full table on every rank
and ``save_parameter_to_tar`` writes it; full-state checkpoints of a
mesh trainer raise (not ported).
"""

from __future__ import annotations

import contextlib
import copy
import os
import sys
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import torch

from paddle_tpu_torch.config import global_config
from paddle_tpu_torch.core.registry import LayerOutput, fold_seed
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.obs import context as obs_context
from paddle_tpu_torch.obs.profile import PROFILER
from paddle_tpu_torch.trainer import event as evt
from paddle_tpu_torch.trainer.data_feeder import DataFeeder
from paddle_tpu_torch.trainer.parameters import Parameters


class SGD:
    """v2-compatible trainer: ``cost`` (a cost LayerOutput or a list),
    ``parameters`` (Parameters), ``update_equation`` (an Optimizer);
    ``extra_layers`` are metric nodes reported in the events and
    ``evaluators`` host evaluators fed every batch. Runs on ``device``
    (the process's device unless one is given, device.py); parameters
    living elsewhere move there."""

    def __init__(self, cost, parameters: Parameters, update_equation,
                 extra_layers: Optional[Sequence[LayerOutput]] = None,
                 is_local: bool = True, mesh=None, evaluators=None,
                 pipeline_stages=None, pipeline_remat: bool = False,
                 pipeline_schedule: str = "gpipe",
                 pipeline_microbatches: Optional[int] = None,
                 device: DeviceLike = None, **kwargs):
        if pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"pipeline_schedule must be 'gpipe' or "
                             f"'1f1b', got {pipeline_schedule!r}")
        if mesh is None:
            mesh = self._default_mesh()
        self.mesh = mesh
        if device is None and mesh is not None:
            from paddle_tpu_torch.parallel.mesh import compute_device
            device = compute_device(mesh)
        self.device = resolve_device(device)
        # the explicit stage map over the mesh's pp axis
        # (ParallelNeuralNetwork deviceId pinning): [[stage0 layers], ...]
        self.pipeline_stages = pipeline_stages
        # torch.utils.checkpoint each GPipe stage: the backward keeps the
        # stage boundaries and recomputes the interiors
        self.pipeline_remat = bool(pipeline_remat)
        # "gpipe" or "1f1b" (O(stages) activation memory,
        # parallel/pipeline.py)
        self.pipeline_schedule = pipeline_schedule
        self.pipeline_microbatches = pipeline_microbatches
        costs = cost if isinstance(cost, (list, tuple)) else [cost]
        self.costs = list(costs)
        self.extra_layers = list(extra_layers or [])
        self.evaluators = list(evaluators or [])
        # gradient printers need d(cost)/d(activation) of their inputs:
        # the step taps those outputs (one backward)
        self._grad_tap_names = sorted({
            li.name for ev in self.evaluators
            if getattr(ev, "wants_gradient", False) for li in ev.inputs})
        # evaluator inputs become extra outputs of the step
        eval_inputs: List[LayerOutput] = []
        seen = {c.name for c in self.costs} | \
            {e.name for e in self.extra_layers}
        for ev in self.evaluators:
            for li in ev.inputs:
                if li.name not in seen and hasattr(li, "parents"):
                    seen.add(li.name)
                    eval_inputs.append(li)
        self._eval_out_names = sorted({li.name for ev in self.evaluators
                                       for li in ev.inputs})
        self.topology = Topology(
            self.costs, extra_outputs=self.extra_layers + eval_inputs)
        feed_names = {name for name, _ in self.topology.data_type()}
        known = set(self.topology.by_name) | feed_names
        for ev in self.evaluators:
            for li in ev.inputs:
                if li.name not in known:
                    raise ValueError(
                        f"evaluator {ev.name!r} input {li.name!r} is "
                        "neither a layer in this topology nor one of its "
                        f"data layers {sorted(feed_names)}")
        self.parameters = parameters
        for name, spec in self.topology.state_specs.items():
            if name not in parameters.state:
                parameters.state[name] = torch.full(
                    tuple(spec.shape), spec.init_value, dtype=spec.dtype,
                    device=self.device)
        # including the parameters of layers only evaluators reach
        missing = [n for n in self.topology.param_specs
                   if n not in parameters.raw]
        if missing:
            gen = torch.Generator().manual_seed(global_config().seed)
            parameters.raw.update(self.topology.init_params(
                gen, only=missing, device=self.device))
        stale_bias = [
            n for n in parameters.raw
            if n.endswith(".wbias") and n not in self.topology.param_specs
            and n[:-len("wbias")] + "w0" in self.topology.param_specs]
        if stale_bias:
            warnings.warn(
                f"parameter table carries bias entries {stale_bias} for "
                "layers this topology builds WITHOUT bias: training "
                "ignores them, but inference paths reading the raw table "
                "may still apply them.", stacklevel=2)
        # this trainer's parameters become autograd leaves on the device
        raw = parameters.raw
        for k in self.topology.param_specs:
            raw[k] = raw[k].detach().to(self.device).requires_grad_(True)
        for k, v in list(parameters.state.items()):
            parameters.state[k] = v.to(self.device)
        self._sparse_map = self.topology.sparse_tables()
        if self._sparse_map and self._grad_tap_names:
            raise NotImplementedError(
                "gradient_printer is not supported together with "
                "row-sparse embedding tables")
        # the parameters this rank holds and updates (a pipeline stage's
        # live on its pp rank only) and, under mp/ep, their specs
        self._own_names = list(self.topology.param_specs)
        self._specs: Dict[str, tuple] = {}
        self._pp = None
        self._loss_scale = 1.0
        if mesh is not None:
            self._place_on_mesh()
        self.optimizer = update_equation.bind(
            self.topology.param_specs, sparse_params=self._sparse_map.keys())
        self.opt_state = self.optimizer.init_state(self._own_params())
        # the random layers' seed: each step folds in its count, and each
        # layer its name (ApplyContext.rng_for)
        self._seed = global_config().seed
        self._step_count = 0
        # the position auto-resume re-enters: completed passes and
        # completed batches of the current pass (both checkpointed)
        self._pass_count = 0
        self._batch_in_pass = 0
        # a checkpointable train reader (reader.batch over a
        # CheckpointableReader): mid-pass checkpoints carry its position
        # and auto-resume seeks instead of re-reading
        self._reader_batches = None
        self._reader_batch_base = 0
        self._reader_state = None
        # train(fault_policy=): the [current, sticky peak] bad-step
        # streak, host ints (the guard reads each step's outcome on the
        # host), acted on every check_period steps
        self._fault_policy = None
        self._bad_streak = [0, 0]
        self._fault_steps_since_check = 0
        # train(microbatch=): the adaptive executor (trainer/memory.py)
        self._memory_exec = None
        self._restored_memory_plan = None
        # fault-injection seam: called as (accum_steps, microbatch_rows)
        # right before each step the memory executor or its probe runs;
        # may raise an OOM
        self._step_interceptor = None
        # optimizer updates begun: an OOM after this moved cannot be
        # retried, the update writes the parameters in place
        self._update_writes = 0
        # the continuous profiler's cost source: the last step's inputs
        # (kept only while the profiler is on), registered once
        self._profile_feed = None
        self._profile_cost_armed = False

    # ------------------------------------------------------------------
    def refresh_update_hooks(self):
        """Recompute parameter-hook state (pruning masks) from the
        current parameter values — after loading weights into a trainer
        already made."""
        self.opt_state = self.optimizer.refresh_hooks(self._own_params(),
                                                      self.opt_state)

    def _own_params(self) -> Dict[str, torch.Tensor]:
        raw = self.parameters.raw
        return {k: raw[k] for k in self._own_names}

    @staticmethod
    def _default_mesh():
        """trainer_count > 1 without an explicit mesh: data parallelism
        over the initialized process group, one rank per trainer
        (config.py); otherwise one device, with the JAX package's
        warning."""
        import torch.distributed as dist
        tc = global_config().trainer_count
        if tc <= 1:
            return None
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world < 2:
            warnings.warn(
                f"trainer_count={tc} requested but the process group has "
                f"{world} rank (parallel.init_distributed forms one); "
                "training single-device", stacklevel=3)
            return None
        if tc > world:
            warnings.warn(
                f"trainer_count={tc} > {world} ranks in the process "
                f"group; using dp={world}", stacklevel=3)
            tc = world
        from paddle_tpu_torch.parallel.mesh import data_parallel_mesh
        return data_parallel_mesh(tc)

    def _place_on_mesh(self):
        """Set up this rank's part of the mesh program: the pipeline's
        stage (its parameters kept, the other stages' dropped), or the
        mp/ep shards of the parameters; the axes each gradient is summed
        over; the loss scale 1/R."""
        from paddle_tpu_torch.parallel import mesh as pm
        from paddle_tpu_torch.parallel import tensor_parallel as tp
        mesh = self.mesh
        live = [a for a in pm.axis_names(mesh) if pm.live(mesh, a)]
        self._live_axes = live
        raw = self.parameters.raw
        for a in live:
            if a != pm.DP_AXIS:
                self._loss_scale /= pm.axis_size(mesh, a)
        self._grad_axes = {}
        if pm.PP_AXIS in live:
            self._place_pipeline(live)
            return
        if pm.MP_AXIS in live or pm.EP_AXIS in live:
            with torch.no_grad():
                for k in self._own_names:
                    spec = tp.spec_for(k, tuple(raw[k].shape), mesh)
                    self._specs[k] = spec
                    if spec:
                        raw[k] = tp.local_shard(raw[k].detach(), spec, mesh) \
                            .contiguous().requires_grad_(True)
        for k in self._own_names:
            spec = self._specs.get(k, ())
            self._grad_axes[k] = [a for a in live if a not in spec]

    def _place_pipeline(self, live):
        from paddle_tpu_torch.parallel import mesh as pm
        from paddle_tpu_torch.parallel.pipeline import topology_stages
        mesh = self.mesh
        if self._grad_tap_names:
            raise NotImplementedError(
                "gradient_printer is not supported with a pipelined "
                "train step; use it on the plain path")
        if not self.pipeline_stages:
            raise ValueError("a pp mesh needs SGD(..., pipeline_stages="
                             "[[layer names]...])")
        n = pm.axis_size(mesh, pm.PP_AXIS)
        if len(self.pipeline_stages) != n:
            raise ValueError("pipeline_stages must have one entry per pp "
                             f"rank ({len(self.pipeline_stages)} for pp={n})")
        other = sorted(set(live) - {pm.DP_AXIS, pm.PP_AXIS})
        if other or self._sparse_map:
            raise NotImplementedError(
                f"a pipelined step on a mesh with {other or 'row-sparse'}"
                " beside dp x pp is not supported")
        stage_fn, stack, body, x_src, body_end = topology_stages(
            self.topology, self.pipeline_stages)
        stage = pm.axis_index(mesh, pm.PP_AXIS)
        mine = stack.names_of(stage)
        for k in stack.param_names - mine:
            self.parameters.raw.pop(k, None)    # lives on its stage's rank
        self._own_names = [k for k in self._own_names
                           if k not in stack.param_names or k in mine]
        if self.pipeline_schedule == "1f1b":
            for lname, l in self.topology.by_name.items():
                if lname not in body and l.type == "dropout":
                    raise AssertionError(
                        f"dropout layer {lname!r} in the tail is "
                        "unsupported with pipeline_schedule='1f1b' "
                        "(per-microbatch rng would diverge from the "
                        "metrics pass)")
            # the schedule's gradients are whole on every pp rank
            self._loss_scale = 1.0
        self._pp = dict(stage_fn=stage_fn, stack=stack, body=body,
                        x_src=x_src, body_end=body_end, stage=stage,
                        prologue_skip=self._pipeline_prologue_skip(x_src))
        for k in self._own_names:
            whole = self.pipeline_schedule == "1f1b" or k in mine
            self._grad_axes[k] = [pm.DP_AXIS] if whole else list(live)

    def _pipeline_prologue_skip(self, x_src):
        """None when the pipeline's boundary is a data layer (fed
        directly); otherwise the layers to SKIP so a forward computes
        exactly the boundary's ancestors (the embedding prologue)."""
        if self.topology.by_name[x_src].type == "data":
            return None
        anc = set()
        stack = [self.topology.by_name[x_src]]
        while stack:
            l = stack.pop()
            if l.name in anc:
                continue
            anc.add(l.name)
            stack.extend(l.parents)
        return [l.name for l in self.topology.layers if l.name not in anc]

    @staticmethod
    def _masked_cost(v, row0, n_real: int):
        """Sum the cost rows whose global index (row0 + local) is below
        n_real, divided by n_real."""
        v = v.reshape(v.shape[0], -1).sum(dim=-1) if v.dim() > 1 else v
        rows = row0 + torch.arange(v.shape[0], device=v.device)
        mask = (rows < n_real).to(v.dtype)
        return torch.sum(v * mask) / max(float(n_real), 1.0)

    def _loss_and_metrics(self, params, state, feed, n_real: int,
                          mode: str, rng: Optional[int] = None,
                          sparse_sub=None, taps=None, row0: int = 0,
                          part: bool = False, body=None):
        """Forward ``feed`` and reduce the costs and extra layers over the
        batch's ``n_real`` real rows. ``part``: ``feed`` holds rows
        ``[row0, row0 + rows)`` of a larger batch (a microbatch), so each
        reduction sums its own real rows and divides by the whole
        batch's ``n_real`` — the parts' losses, metrics and gradients add
        up to the whole batch's. On a mesh ``feed`` is the global batch
        (or a microbatch of it): the rank keeps its dp block, gathers its
        sharded parameters, runs the pipelined body (or injects
        ``body``, its output), and returns its rows' partial loss and
        metrics (``_reduce_reported`` sums them) with the evaluators'
        inputs gathered over dp."""
        from paddle_tpu_torch.trainer.memory import _leading_rows
        mesh = self.mesh
        if mesh is not None:
            from paddle_tpu_torch.parallel import data_parallel as dpm
            from paddle_tpu_torch.parallel.mesh import DP_AXIS, axis_index
            feed = dpm.shard_feed(feed, mesh)
            row0 += axis_index(mesh, DP_AXIS) * _leading_rows(feed)
            params = self._gathered_for_use(params)
        n_local = n_real
        if part or mesh is not None:
            n_local = min(max(n_real - row0, 0), _leading_rows(feed))
        injected, skip = None, ()
        if self._pp is not None:
            if body is None:
                body = self._gpipe_body(params, state, feed, rng, n_local)
            injected, skip = {self._pp["body_end"]: body}, self._pp["body"]
        outs, new_state = self.topology.forward(params, state, feed,
                                                mode=mode, rng=rng,
                                                n_real=n_local,
                                                sparse_sub=sparse_sub,
                                                taps=taps, injected=injected,
                                                skip=skip, mesh=mesh)
        total = 0.0
        metrics = {}
        for c in self.costs:
            cost_val = self._masked_cost(outs[c.name], row0, n_real)
            total = total + cost_val
            metrics[c.name] = cost_val
        for e in self.extra_layers:
            v = outs[e.name]
            if isinstance(v, SequenceBatch):
                if part:
                    # a token mean over the whole batch does not split
                    # into the parts' sums
                    raise NotImplementedError(
                        f"sequence-output extra layer {e.name!r} is not "
                        "supported under microbatch accumulation")
                m = v.mask()
                data = v.data.reshape(v.data.shape[0], v.data.shape[1], -1)
                den = torch.sum(m)
                if mesh is not None:
                    # the token mean of the global batch: this rank's
                    # share over the global token count
                    from paddle_tpu_torch.parallel import comm
                    from paddle_tpu_torch.parallel.mesh import DP_AXIS
                    den = comm.all_reduce(den.detach().float(), mesh,
                                          DP_AXIS)
                metrics[e.name] = torch.sum(data.float().mean(-1) * m) / \
                    torch.clamp(den, min=1.0)
            else:
                v = v.reshape(v.shape[0], -1).float().mean(dim=-1)
                rows = row0 + torch.arange(v.shape[0], device=v.device)
                metrics[e.name] = torch.sum(v * (rows < n_real).to(v.dtype)) \
                    / max(float(n_real), 1.0)
        # evaluator inputs: graph outputs, or raw feed entries (labels)
        eval_outs = {n: (outs[n] if n in outs else feed[n])
                     for n in self._eval_out_names}
        if mesh is not None:
            from paddle_tpu_torch.parallel.data_parallel import gather_rows
            eval_outs = {n: gather_rows(v, mesh)
                         for n, v in eval_outs.items()}
        return total, (metrics, new_state, eval_outs)

    # ------------------------------------------------------ the mesh step
    def _gathered_for_use(self, params):
        """The parameters a forward reads: the mp-sharded ones gathered
        (differentiably), the ep experts and row-sparse tables as held."""
        if not self._specs:
            return params
        from paddle_tpu_torch.parallel import tensor_parallel as tp
        return tp.gather_params(params, self._specs, self.mesh,
                                keep_local=self._sparse_map)

    def _gpipe_body(self, params, state, feed, rng, n_local):
        """The pipelined body's output (GPipe, parallel/pipeline.py): the
        boundary is a data layer's feed or the prologue's output."""
        from paddle_tpu_torch.parallel.pipeline import pipeline
        pp = self._pp
        x = self._pipeline_input(params, state, feed, rng, n_local)
        return pipeline(pp["stage_fn"], pp["stack"](params, pp["stage"]), x,
                        self.mesh, num_microbatches=self.pipeline_microbatches,
                        remat=self.pipeline_remat)

    def _pipeline_input(self, params, state, feed, rng, n_local):
        """The boundary feeding the pipeline: a data layer's feed, or the
        ancestor slice (embeddings) run forward — one implementation for
        both schedules."""
        pp = self._pp
        if pp["prologue_skip"] is None:
            return feed[pp["x_src"]]
        outs, _ = self.topology.forward(
            params, state, feed, mode="train", rng=rng,
            output_names=[pp["x_src"]], skip=pp["prologue_skip"],
            mesh=self.mesh, n_real=n_local)
        return outs[pp["x_src"]]

    def _reduce_grads(self, grads):
        """Each gradient summed over the axes its parameter is replicated
        on: one all-reduce per group of parameters with the same axes. A
        gradient that is None on this rank is zeros when another rank has
        one (the ranks agree on the set through one small all-reduce)."""
        if self.mesh is None:
            return grads
        from paddle_tpu_torch.parallel import comm
        names = sorted(grads)
        dev = self.device
        has = torch.tensor([float(grads[k] is not None) for k in names],
                           device=dev)
        has = comm.all_reduce(has, self.mesh, self._live_axes).tolist()
        own = self._own_params()
        buckets: Dict[tuple, List[str]] = {}
        for k, h in zip(names, has):
            if h == 0:
                continue
            if grads[k] is None:
                grads[k] = torch.zeros_like(own[k])
            axes = tuple(self._grad_axes.get(k, self._live_axes))
            if axes:
                buckets.setdefault((axes, grads[k].dtype), []).append(k)
        with torch.no_grad():
            for (axes, _), ks in buckets.items():
                flat = comm.all_reduce(
                    torch.cat([grads[k].reshape(-1) for k in ks]),
                    self.mesh, axes)
                off = 0
                for k in ks:
                    n = grads[k].numel()
                    grads[k] = flat[off:off + n].view_as(grads[k])
                    off += n
        return grads

    def _reduce_reported(self, loss, metrics):
        """The ranks' partial loss and metrics summed over dp (the other
        axes' ranks hold the same partials)."""
        if self.mesh is None:
            return loss, metrics
        from paddle_tpu_torch.parallel import comm
        from paddle_tpu_torch.parallel.mesh import DP_AXIS
        names = list(metrics)
        with torch.no_grad():
            flat = comm.all_reduce(torch.stack(
                [torch.as_tensor(loss, device=self.device).float()] +
                [metrics[k].detach().float() for k in names]),
                self.mesh, DP_AXIS)
        return flat[0], dict(zip(names, flat[1:]))

    @staticmethod
    def _fetch_host(loss, metrics, eval_outs=None):
        """One device -> host transfer for a step's loss, metrics and
        evaluator inputs: the scalars and every evaluator tensor go to
        the host as one byte buffer. Returns (loss, {name: metric},
        {name: host tensor or SequenceBatch of host tensors}). Timed as
        the profiler's ``settle`` phase (the wait for the card)."""
        from paddle_tpu_torch.utils.stats import stat_timer
        names = list(metrics)
        scalars = torch.stack([loss.detach().float()] +
                              [metrics[k].detach().float() for k in names])
        parts = [scalars]
        for v in (eval_outs or {}).values():
            parts += [v.data, v.lengths] if isinstance(v, SequenceBatch) \
                else [v]
        with stat_timer("train/settle"):
            flat = torch.cat([p.detach().contiguous().reshape(-1)
                              .view(torch.uint8) for p in parts]).cpu()
        host_parts, off = [], 0
        for p in parts:
            n = p.numel() * p.element_size()
            host_parts.append(flat[off:off + n].clone().view(p.dtype)
                              .reshape(p.shape))
            off += n
        host = host_parts[0].tolist()
        rest = iter(host_parts[1:])
        eval_host = {}
        for k, v in (eval_outs or {}).items():
            eval_host[k] = SequenceBatch(next(rest), next(rest)) \
                if isinstance(v, SequenceBatch) else next(rest)
        return host[0], dict(zip(names, host[1:])), eval_host

    def _step(self, feed, n_real: int, fetch_evals: bool = True):
        obs_context.set_step(self._step_count)
        rng = fold_seed(self._seed, self._step_count)
        self._step_count += 1
        loss, metrics, eval_outs = self._device_step(feed, n_real, rng)
        self._profile_step(feed, rng, n_real)
        return self._fetch_host(loss, metrics,
                                eval_outs if fetch_evals else None)

    def _profile_step(self, feed, rng, n_real: int) -> None:
        """The continuous profiler's per-step hook (a no-op attribute
        read while it is off)."""
        if not PROFILER.enabled:
            return
        self._profile_feed = (feed, rng, n_real)
        self._arm_profile_cost()
        PROFILER.on_step("train")

    def _arm_profile_cost(self) -> None:
        """Register the profiler's lazy FLOP source once: a weakref
        closure that counts one forward and backward of the last step's
        inputs (``cost_of``; nothing written, the update's element-wise
        work is left out). The profiler calls it at most once per
        enable, off a sampled step."""
        if self._profile_cost_armed or self.mesh is not None:
            # on a mesh the cost source's step is a collective, which a
            # sampled rank cannot run alone
            return
        self._profile_cost_armed = True
        import weakref
        ref = weakref.ref(self)

        def _cost():
            tr = ref()
            if tr is None or tr._profile_feed is None:
                return None, None
            from paddle_tpu_torch.obs.profile import cost_of
            feed, rng, n_real = tr._profile_feed
            return cost_of(tr._grads, tr._own_params(), feed, n_real, rng)

        PROFILER.set_cost_source("train", _cost)

    def _device_step(self, feed, n_real: int, rng, k: int = 1,
                     guarded: bool = False):
        """One optimizer step over ``feed``: the gradients (of ``k``
        accumulated microbatches when k > 1), the update of the
        parameters (in place), the optimizer state and the layer state;
        with ``guarded`` a step whose values are not finite is undone
        (``_guarded_update``). Returns (loss, metrics, eval_outs) on the
        device."""
        params = self._own_params()
        if k > 1:
            (loss, metrics, new_state, eval_outs, grads,
             sparse_rows) = self._accum_grads(params, feed, n_real, rng, k)
        else:
            (loss, (metrics, new_state, eval_outs), grads,
             sparse_rows) = self._grads(params, feed, n_real, rng)
        # detached: a moving statistic that kept its graph would hold
        # every earlier step's activations alive
        new_state = {name: v.detach() for name, v in new_state.items()}
        loss, metrics = self._reduce_reported(loss, metrics)
        if global_config().debug_nans:
            _raise_if_nonfinite("forward", [loss, metrics, new_state])
            _raise_if_nonfinite("backward", [grads, sparse_rows])
        if guarded:
            metrics = self._guarded_update(params, grads, sparse_rows,
                                           n_real, loss, metrics, new_state)
        else:
            self._update_writes += 1
            _, self.opt_state = self.optimizer.update(
                params, grads, self.opt_state, n_real,
                sparse_rows=sparse_rows)
            self.parameters.state = new_state
        return loss, metrics, eval_outs

    def _grads(self, params, feed, n_real: int, rng):
        """Forward and backward of one step, nothing written: prefetch
        each row-sparse table's touched rows, forward on those row
        blocks, gradients of the dense parameters and the blocks (never
        of the tables). With no row-sparse table it is the plain dense
        step. The gradient printers' activation gradients (the taps')
        join the evaluator inputs as ``__grad__<layer>``. On a mesh the
        gradients come back summed over the ranks (``_reduce_grads``),
        the loss and metrics as this rank's partials. Returns
        (loss, (metrics, new_state, eval_outs), dense grads,
        sparse_rows for ``optimizer.update``)."""
        if self._pp is not None and self.pipeline_schedule == "1f1b":
            return self._grads_1f1b(params, feed, n_real, rng)
        from paddle_tpu_torch.ops import embedding as emb_ops
        next_step = self.opt_state["step"] + 1
        slots = self.opt_state["slots"]
        uids, rows0, slot_rows, owned = {}, {}, {}, {}
        for pname, src in self._sparse_map.items():
            v = feed[src]
            ids = v.data if isinstance(v, SequenceBatch) else v
            table = params[pname]
            if self._specs.get(pname):
                # the table's rows are sharded over mp: the global ids'
                # rows come from their owners, caught up there
                (uids[pname], rows0[pname], slot_rows[pname],
                 owned[pname]) = self._owner_prefetch(pname, table, ids,
                                                      next_step)
                continue
            uids[pname] = emb_ops.touched_ids(ids, table.shape[0])
            rows0[pname], slot_rows[pname] = self.optimizer.sparse_prefetch(
                pname, table, slots[pname], uids[pname], next_step)
        rows = {k: r.detach().requires_grad_(True) for k, r in rows0.items()}
        sub = {k: (uids[k], rows[k]) + ((owned[k][2],) if k in owned else ())
               for k in rows}
        taps = dict.fromkeys(self._grad_tap_names) or None
        out = self._loss_and_metrics(params, self.parameters.state, feed,
                                     n_real, "train", rng, sparse_sub=sub,
                                     taps=taps)
        dense = [k for k in params if k not in self._sparse_map]
        tables = list(rows)
        tapped = list(taps or ())
        grads = torch.autograd.grad(
            out[0] * self._loss_scale,
            [params[k] for k in dense] + [rows[k] for k in tables]
            + [taps[k] for k in tapped], allow_unused=True)
        g_taps = grads[len(dense) + len(tables):]
        grads = grads[:len(dense) + len(tables)]
        for k, g in zip(tapped, g_taps):
            g = torch.zeros_like(taps[k]) if g is None else g
            out[1][2]["__grad__" + k] = self._whole_activation_grad(g)
        g_dense = self._reduce_grads(dict(zip(dense, grads[:len(dense)])))
        g_rows = self._reduce_grads(
            {k: torch.zeros_like(rows0[k]) if g is None else g
             for k, g in zip(tables, grads[len(dense):])})
        sparse_rows = {}
        for k in tables:
            entry = (uids[k], g_rows[k], rows0[k], slot_rows[k])
            if k in owned:
                entry = self._owned_rows(entry, owned[k])
                if entry is None:
                    continue        # no touched row lives on this rank
            sparse_rows[k] = entry
        return out[0], out[1], g_dense, sparse_rows

    def _owner_prefetch(self, pname, shard, ids, next_step: int):
        """Prefetch of an mp-row-sharded table: the global batch's
        touched ids, each row read (with the optimizer's catch-up) from
        the rank that owns it and summed over mp so every rank holds the
        block. Returns (uids, rows, this rank's slot rows, (owned mask,
        local ids, global rows))."""
        from paddle_tpu_torch.ops import embedding as emb_ops
        from paddle_tpu_torch.parallel import comm
        from paddle_tpu_torch.parallel.mesh import (MP_AXIS, axis_index,
                                                    axis_size)
        local = shard.shape[0]
        vocab = local * axis_size(self.mesh, MP_AXIS)
        lo = axis_index(self.mesh, MP_AXIS) * local
        uids = emb_ops.touched_ids(ids, vocab)
        own = (uids >= lo) & (uids < lo + local)
        luids = torch.where(own, uids - lo, torch.full_like(uids, local))
        p_rows, s_rows = self.optimizer.sparse_prefetch(
            pname, shard, self.opt_state["slots"][pname], luids, next_step)
        with torch.no_grad():
            p_rows = comm.all_reduce(p_rows * own[:, None].to(p_rows.dtype),
                                     self.mesh, MP_AXIS)
        return uids, p_rows, s_rows, (own, luids, vocab)

    @staticmethod
    def _owned_rows(entry, owned):
        """The sparse update entry of the rows this rank owns, by their
        shard-local ids; None when it owns none of them."""
        uids, g_rows, p_rows, slot_rows = entry
        own, luids, _ = owned
        idx = torch.nonzero(own).reshape(-1)
        if idx.numel() == 0:
            return None
        return (luids[idx], g_rows[idx], p_rows[idx],
                {k: v[idx] for k, v in slot_rows.items()})

    def _whole_activation_grad(self, g):
        """A gradient printer's d(cost)/d(activation) of the global
        batch: this rank's share summed over the ranks that share its
        rows, gathered over dp."""
        if self.mesh is None:
            return g
        from paddle_tpu_torch.parallel import comm
        from paddle_tpu_torch.parallel.data_parallel import gather_rows
        from paddle_tpu_torch.parallel.mesh import DP_AXIS
        with torch.no_grad():
            g = comm.all_reduce(g, self.mesh, [a for a in self._live_axes
                                               if a != DP_AXIS])
        return gather_rows(g, self.mesh)

    def _grads_1f1b(self, params, feed, n_real: int, rng):
        """The 1F1B step: the gradients come out of the schedule
        (parallel/pipeline.py pipeline_1f1b), not a backward of the
        whole loss — the tail's from the per-microbatch head on the last
        rank, the stage's on its rank, the prologue's through the
        schedule's input cotangent; then a tail pass without gradients
        gives the reported loss, metrics, layer state and evaluator
        inputs, math identical to GPipe's. ``pipeline_loss_drift`` (the
        schedule's loss minus the pass's) shows an objective that
        drifted from the report."""
        from paddle_tpu_torch.parallel import data_parallel as dpm
        from paddle_tpu_torch.parallel.mesh import (DP_AXIS, PP_AXIS,
                                                    axis_index, axis_size)
        from paddle_tpu_torch.parallel.pipeline import (_flatten,
                                                        is_dynamic_leaf,
                                                        pipeline_1f1b)
        from paddle_tpu_torch.trainer.memory import _leading_rows, _rows
        pp, mesh = self._pp, self.mesh
        state = self.parameters.state
        feed_l = dpm.shard_feed(feed, mesh)
        rows = _leading_rows(feed_l)
        row0 = axis_index(mesh, DP_AXIS) * rows
        n_local = min(max(n_real - row0, 0), rows)
        x = self._pipeline_input(params, state, feed_l, rng, n_local)
        leaves, rebuild = _flatten(x)
        x_dyn = [a for a in leaves if is_dynamic_leaf(a)]
        x_in = rebuild([a.detach() for a in leaves])
        m = self.pipeline_microbatches or axis_size(mesh, PP_AXIS)
        if rows % m:
            raise ValueError(f"microbatches {m} must divide the rank's "
                             f"{rows} rows")
        mb = rows // m
        body = set(pp["body"])
        tail_p = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()
                  if k not in pp["stack"].param_names}

        def tail_vjp(y_mb, j, tp, fl):
            y_leaves, y_rebuild = _flatten(y_mb)
            yl = [a.detach().requires_grad_(True) if is_dynamic_leaf(a)
                  else a for a in y_leaves]
            r0 = row0 + j * mb
            feed_j = {k: _rows(v, j * mb, (j + 1) * mb)
                      for k, v in fl.items()}
            with torch.enable_grad():
                outs, _ = self.topology.forward(
                    tp, state, feed_j, mode="train", rng=fold_seed(rng, j),
                    injected={pp["body_end"]: y_rebuild(yl)}, skip=body,
                    n_real=min(max(n_real - r0, 0), mb))
                total = sum(self._masked_cost(outs[c.name], r0, n_real)
                            for c in self.costs)
            names = sorted(tp)
            dyn = [a for a in yl if is_dynamic_leaf(a)]
            gs = torch.autograd.grad(total, [tp[k] for k in names] + dyn,
                                     allow_unused=True)
            dtail = {k: torch.zeros_like(tp[k]) if g is None else g
                     for k, g in zip(names, gs[:len(names)])}
            dy = [torch.zeros_like(a) if g is None else g
                  for a, g in zip(dyn, gs[len(names):])]
            return total.detach(), dy, dtail

        loss_sum, y, g_stage, dtail, dx = pipeline_1f1b(
            pp["stage_fn"], pp["stack"](params, pp["stage"]), x_in, tail_vjp,
            mesh, num_microbatches=m, tail_args=(tail_p, feed_l))
        grads = dict(dtail)
        if x_dyn and any(a.requires_grad for a in x_dyn):
            # the schedule's input cotangent back through the prologue
            names = list(params)
            g_pro = torch.autograd.grad(x_dyn, [params[k] for k in names],
                                        dx, allow_unused=True)
            for k, g in zip(names, g_pro):
                if g is not None:
                    grads[k] = grads[k] + g if k in grads else g
        grads.update(pp["stack"].unstack(g_stage, pp["stage"]))
        with torch.no_grad():
            loss, (metrics, new_state, eval_outs) = self._loss_and_metrics(
                params, state, feed, n_real, "train", rng, body=y)
        metrics["pipeline_loss_drift"] = loss_sum - loss
        return loss, (metrics, new_state, eval_outs), \
            self._reduce_grads(grads), {}

    def _accum_grads(self, params, feed, n_real: int, rng, k: int):
        """The gradient of a batch as ``k`` contiguous microbatches (the
        memory executor pads the rows to a multiple of k): microbatch j
        runs rows [j*mb, (j+1)*mb) forward and backward on its own, its
        cost the masked cost of its GLOBAL rows divided by ``n_real``,
        so the k losses, metrics and gradients add up to the full-batch
        step's. Peak activation memory drops to a microbatch's, plus one
        gradient-sized accumulator. Layer state threads through the
        microbatches (each sees its own statistics) and the random
        layers draw per microbatch (``fold_seed(rng, j)``), the standard
        accumulation trade, as in the JAX package."""
        from paddle_tpu_torch.trainer.memory import _leading_rows, split_feed
        if self._sparse_map:
            raise NotImplementedError(
                "microbatch accumulation does not compose with "
                "row-sparse embedding tables yet")
        if self._pp is not None:
            raise NotImplementedError(
                "pipelined meshes microbatch through "
                "pipeline_microbatches, not the memory executor")
        if self._grad_tap_names or self.evaluators:
            raise NotImplementedError(
                "microbatch accumulation does not support "
                "gradient-printer or host evaluators")
        if self.mesh is not None:
            # each microbatch's rows split over dp: pad (masked rows past
            # n_real) so dp divides them
            from paddle_tpu_torch.parallel.mesh import DP_AXIS, axis_size
            from paddle_tpu_torch.trainer.memory import _pad_to_multiple
            step = k * axis_size(self.mesh, DP_AXIS)
            if _leading_rows(feed) % step:
                feed, _ = _pad_to_multiple(feed, step)
        parts = split_feed(feed, k)
        mb = _leading_rows(feed) // k
        names = list(params)
        state = self.parameters.state
        grads = [None] * len(names)
        loss = 0.0
        metrics: Dict[str, torch.Tensor] = {}
        for j, part in enumerate(parts):
            total, (m, state, _) = self._loss_and_metrics(
                params, state, part, n_real, "train", fold_seed(rng, j),
                row0=j * mb, part=True)
            for name, v in m.items():
                metrics[name] = metrics.get(name, 0.0) + v.detach()
            g = torch.autograd.grad(total * self._loss_scale,
                                    [params[n] for n in names],
                                    allow_unused=True)
            grads = [gj if acc is None else
                     acc if gj is None else acc + gj
                     for acc, gj in zip(grads, g)]
            loss = loss + total.detach().float()
            del total, m, g
        return loss, metrics, state, {}, \
            self._reduce_grads(dict(zip(names, grads))), {}

    def _guarded_update(self, params, grads, sparse_rows, n_real: int,
                        loss, metrics, new_state):
        """The update under a FaultPolicy. What the in-place update
        overwrites is copied first (``_snapshot``); after the update the
        loss and every float value of the new parameters, optimizer state
        and layer state are checked on the device, and the one host read
        of that check decides: keep the step, or restore the copies and
        keep the old optimizer state (its host counters ``step`` and
        ``num_samples`` included) and layer state — bit-identical to
        skipping the batch. The streak [current, sticky peak] advances
        either way. Returns the metrics (zeroed on a bad step) with
        ``fault_ok``."""
        restore = self._snapshot()
        with torch.no_grad():
            self._update_writes += 1
            _, new_opt = self.optimizer.update(
                params, grads, self.opt_state, n_real,
                sparse_rows=sparse_rows)
            ok = bool(_all_finite([loss, params, new_opt, new_state]))
        cur = 0 if ok else self._bad_streak[0] + 1
        self._bad_streak = [cur, max(self._bad_streak[1], cur)]
        if ok:
            self.opt_state = new_opt
            self.parameters.state = new_state
        else:
            restore()
            metrics = {k: torch.zeros_like(v) for k, v in metrics.items()}
        metrics = dict(metrics)
        metrics["fault_ok"] = torch.tensor(float(ok), device=loss.device)
        return metrics

    def _snapshot(self):
        """Copy what an optimizer update writes in place — the
        parameters, and the slots of the row-sparse tables (a dense
        update makes new slot tensors) — and return a function that
        writes the copies back and reinstates this optimizer state and
        layer state."""
        with torch.no_grad():
            params = self._own_params()
            saved = {k: p.detach().clone() for k, p in params.items()}
            opt = self.opt_state
            slots = {k: {n: v.clone() for n, v in opt["slots"][k].items()}
                     for k in self._sparse_map}
        state = self.parameters.state

        def restore():
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(saved[k])
                for k, sl in slots.items():
                    for n, v in sl.items():
                        opt["slots"][k][n].copy_(v)
            self.opt_state = opt
            self.parameters.state = state
        return restore

    def _feed_evaluators(self, eval_host, n_real: int) -> Dict[str, float]:
        """Push a batch's fetched outputs through the evaluators; returns
        their running pass-so-far results."""
        if not self.evaluators:
            return {}
        from paddle_tpu_torch.evaluator import _to_np
        host = {k: _to_np(v) for k, v in eval_host.items()}
        results: Dict[str, float] = {}
        for ev in self.evaluators:
            if getattr(ev, "wants_gradient", False):
                keys = ["__grad__" + li.name for li in ev.inputs]
                if any(k not in host for k in keys):
                    continue    # no backward ran (a test sweep)
                ev.eval_batch([host[k] for k in keys], n_real)
            else:
                ev.eval_batch([host[li.name] for li in ev.inputs], n_real)
            if not getattr(ev, "expensive_result", False):
                results.update(ev.result())
        return results

    def _feeder(self, feeding):
        return DataFeeder(self.topology.data_type(), feeding,
                          device=self.device)

    def train_batch(self, data_batch, feeding=None):
        """One optimizer step on a batch (a list of sample tuples);
        returns (cost, metrics) as host floats."""
        feed = self._feeder(feeding)(data_batch)
        n_real = int(feed.pop("__batch_size__"))
        return self._step(feed, n_real, fetch_evals=False)[:2]

    def train(self, reader=None, num_passes: int = 1,
              event_handler: Optional[Callable] = None, feeding=None,
              num_batches_per_pass: Optional[int] = None,
              coordinator=None, chunk_reader=None, batch_size: int = 0,
              checkpoint_manager=None, checkpoint_period: int = 0,
              checkpoint_dir: Optional[str] = None,
              auto_resume: bool = False, fault_policy=None,
              idle_timeout: float = 600.0, microbatch=None,
              oom_probe: bool = False,
              worker_id: Optional[str] = None, on_reshape=None):
        """reader: callable yielding batches (lists of sample tuples).
        Emits BeginPass / BeginIteration / EndIteration / EndPass (and
        FaultEvent / OOMEvent); the EndIteration metrics carry the
        evaluators' running results, the EndPass metrics the pass
        averages and the evaluators' pass results. With no evaluator the
        EndIteration events are ``LazyEndIteration``: reading ``cost``
        or ``metrics`` waits for that step, nothing else does.

        checkpoint_manager / checkpoint_dir (shorthand for
        ``CheckpointManager(checkpoint_dir)``): save the full state every
        ``checkpoint_period`` steps and at each pass end.

        auto_resume: restore the newest intact checkpoint before the
        first pass and continue FROM it — the pass, the position in it,
        the optimizer state and the step count (the random layers' seed
        folds it in) all resume, so a killed run relaunched with the
        same flags replays the uninterrupted one (``num_passes`` is the
        run's total). A checkpointable reader (``reader.batch`` over a
        ``CheckpointableReader``) resumes by seeking its source to the
        saved position; any other reader is re-read and the covered
        batches skipped.

        fault_policy: a trainer.fault.FaultPolicy — skip non-finite
        updates and roll back to the newest checkpoint after
        ``max_bad_steps`` bad steps in a row, emitting FaultEvent.

        microbatch: "auto" or an int — adaptive microbatching
        (trainer/memory.py): a step that runs out of device memory is
        re-run as accumulated microbatches (numerically the full-batch
        step), an OOMEvent per adaptation; an int fixes the starting
        microbatch rows. The plan rides in checkpoint meta.
        oom_probe: with microbatch="auto", find the largest safe
        microbatch on the first batch before stepping.

        Elastic mode: pass ``coordinator`` (a Coordinator or a
        ``coordinator.connect`` proxy, trainer/coordinator.py) and
        ``chunk_reader(chunk) -> records`` instead of ``reader``. The
        data then comes as coordinator-dispatched tasks (``task_reader``,
        grouped into ``batch_size`` batches), re-queued when this trainer
        dies; ``num_passes`` counts coordinator epochs, and a pass ends
        when the reader has seen the epoch turn or ``idle_timeout``
        seconds with no task. With ``checkpoint_manager`` the trainer
        restores the newest checkpoint on entry. ``worker_id`` joins the
        fleet's membership (adopting its published MemoryPlan when this
        trainer has none of its own, and publishing its plan after each
        pass) and leaves gracefully at the end; a grant that shows a new
        membership generation journals ``trainer/reshape`` and calls
        ``on_reshape(generation)``."""
        if event_handler is None:
            event_handler = _default_event_handler
        # one run id for the whole run: every journal record carries it
        obs_context.ensure_run_id()
        # warm start: a relaunched (auto_resume / elastic-replacement)
        # trainer takes its kernel libraries from the compile cache —
        # the default one, or PADDLE_TPU_COMPILE_CACHE when it is set
        from paddle_tpu_torch.artifacts import cache as _compile_cache
        _compile_cache.ensure_default()
        feeder = self._feeder(feeding)
        if checkpoint_manager is None and checkpoint_dir:
            from paddle_tpu_torch.trainer.checkpoint import CheckpointManager
            checkpoint_manager = CheckpointManager(checkpoint_dir)

        self._fault_policy = fault_policy
        if fault_policy is not None:
            self._fault_steps_since_check = 0

        self._memory_exec = None
        if microbatch is not None:
            from paddle_tpu_torch.trainer.memory import (
                AdaptiveMicrobatcher, MemoryPlan)
            if self.evaluators:
                raise NotImplementedError(
                    "microbatch= does not compose with host evaluators "
                    "yet — drop the evaluators or the microbatching")
            if microbatch == "auto":
                plan = MemoryPlan()
            else:
                mb = int(microbatch)
                if mb < 1:
                    raise ValueError("microbatch must be >= 1 or 'auto'")
                plan = MemoryPlan(microbatch=mb, provenance="configured")
            self._memory_exec = AdaptiveMicrobatcher(self, plan,
                                                     probe=oom_probe)
        elif oom_probe:
            raise ValueError(
                "oom_probe=True needs microbatch='auto' or an int")

        if coordinator is not None:
            return self._train_elastic(
                coordinator, chunk_reader, num_passes, event_handler,
                feeder, num_batches_per_pass, batch_size,
                checkpoint_manager, checkpoint_period, idle_timeout,
                worker_id, on_reshape)

        ckptable = hasattr(reader, "state_for") and \
            hasattr(reader, "set_state")
        self._reader_batches = reader if ckptable else None
        start_pass, skip_batches, seek_batches = 0, 0, 0
        if auto_resume and checkpoint_manager is not None and \
                self.restore_checkpoint(checkpoint_manager):
            self._adopt_restored_plan()
            start_pass = self._pass_count
            skip_batches = self._batch_in_pass
            if ckptable and skip_batches and self._reader_state:
                # position the source right after the last checkpointed
                # batch: each remaining record is consumed exactly once
                reader.set_state(self._reader_state)
                seek_batches, skip_batches = skip_batches, 0
        try:
            for pass_id in range(start_pass, num_passes):
                first = pass_id == start_pass
                self._run_pass(pass_id, reader, feeder, event_handler,
                               num_batches_per_pass, checkpoint_manager,
                               checkpoint_period,
                               skip_batches=skip_batches if first else 0,
                               batch_offset=seek_batches if first else 0)
                if checkpoint_manager is not None:
                    self.save_checkpoint(checkpoint_manager)
        finally:
            self._reader_batches = None
            if checkpoint_manager is not None:
                # never leave train() with a write in flight, and
                # surface a background write error
                checkpoint_manager.wait()

    def _train_elastic(self, coordinator, chunk_reader, num_passes,
                       event_handler, feeder, num_batches_per_pass,
                       batch_size, checkpoint_manager, checkpoint_period,
                       idle_timeout, worker_id, on_reshape):
        """``train``'s elastic mode (its docstring): every coordinator
        RPC retries with backoff, so a coordinator restarting while the
        trainers come up delays them instead of killing them."""
        import xmlrpc.client as xc

        from paddle_tpu_torch.obs.events import emit
        from paddle_tpu_torch.reader import batch as batch_reader
        from paddle_tpu_torch.trainer.coordinator import (
            RetryPolicy, call_with_retry, coordinator_epoch, task_reader)
        if chunk_reader is None:
            raise ValueError(
                "coordinator mode needs chunk_reader(chunk) -> records")
        retry = RetryPolicy()
        joined = False
        join_plan_meta = None
        if worker_id is not None:
            try:
                resp = call_with_retry(coordinator.join, worker_id,
                                       policy=retry)
                joined = True
                join_plan_meta = (resp or {}).get("memory_plan")
            except xc.Fault:
                warnings.warn(
                    "coordinator has no join() RPC — running without "
                    "elastic membership")

        def on_generation_change(gen):
            # a grant showed a new membership generation: the fleet
            # resharded under this trainer
            emit("trainer", "reshape", generation=int(gen),
                 worker_id=worker_id)
            if on_reshape is not None:
                on_reshape(gen)

        rdr = task_reader(coordinator, chunk_reader,
                          idle_timeout=idle_timeout, retry=retry,
                          worker_id=worker_id if joined else None,
                          on_generation_change=on_generation_change)
        if batch_size:
            rdr = batch_reader(rdr, batch_size)
        if checkpoint_manager is not None and \
                self.restore_checkpoint(checkpoint_manager):
            self._adopt_restored_plan()
        self._adopt_fleet_plan(join_plan_meta)

        def publish_plan():
            # the next joiner adopts this trainer's known-safe plan from
            # its join() response instead of probing or running out of
            # memory on its own
            if not joined or self._memory_exec is None:
                return
            pm = self._memory_exec.plan.to_meta()
            if pm is None:
                return
            try:
                call_with_retry(coordinator.put_memory_plan, pm,
                                policy=retry)
            except (xc.Fault, TimeoutError):
                pass        # an older coordinator, or it is gone

        publish_plan()
        try:
            while coordinator_epoch(coordinator, retry=retry) < num_passes:
                pass_id = coordinator_epoch(coordinator, retry=retry)
                self._run_pass(pass_id, rdr, feeder, event_handler,
                               num_batches_per_pass, checkpoint_manager,
                               checkpoint_period)
                if checkpoint_manager is not None:
                    self.save_checkpoint(checkpoint_manager)
                publish_plan()
                if coordinator_epoch(coordinator, retry=retry) == pass_id:
                    # the reader gave up without the epoch turning
                    # (every task dropped, or idle_timeout)
                    warnings.warn(
                        f"elastic training stopped at epoch {pass_id} "
                        f"of {num_passes}: the pass never completed")
                    break
        finally:
            if joined:
                # graceful scale-in: the leased tasks go back now, with
                # their reader position, instead of at lease expiry
                try:
                    call_with_retry(coordinator.leave, worker_id,
                                    policy=retry)
                except (xc.Fault, TimeoutError):
                    pass        # coordinator gone: the leases expire
            if checkpoint_manager is not None:
                checkpoint_manager.wait()

    def _prefetched(self, reader, feeder, depth: int = 2):
        """Feed conversion (samples -> padded tensors on the device) in a
        background thread, ``depth`` batches ahead — the DoubleBuffer
        discipline (DataProvider.h:249) applied to the feeder. The
        thread is named ``pt-data-feed`` and exits on a stop event when
        the consumer abandons the generator (a ``break`` out of the
        pass) instead of blocking on a full queue."""
        import queue
        import threading

        from paddle_tpu_torch.utils.stats import stat_timer
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                for batch in reader():
                    with stat_timer("train/h2d"):
                        converted = feeder(batch)
                    if not put((None, converted)):
                        return
                put((None, done))
            except BaseException as e:      # surfaced in the main thread
                put((e, None))

        t = threading.Thread(target=work, daemon=True, name="pt-data-feed")
        t.start()
        try:
            while True:
                with stat_timer("train/data_wait"):
                    err, feed = q.get()
                if err is not None:
                    raise err
                if feed is done:
                    return
                yield feed
        finally:
            stop.set()
            t.join(timeout=5.0)

    @staticmethod
    def _kahan_add(acc, v):
        """One compensated-summation step on the device: (sum, comp) + v
        (eager ops: nothing simplifies the compensation away)."""
        s, c = acc
        y = v - c
        t = s + y
        return t, (t - s) - y

    def _check_faults(self, policy, pass_id, batch_id, event_handler,
                      checkpoint_manager):
        """Host side of the guarded step: every check_period steps look
        at the [current, peak-since-last-check] bad-step streak; roll
        back and emit FaultEvent when the peak reached the policy's
        limit. The peak is sticky, so a streak that ended between checks
        is still seen."""
        from paddle_tpu_torch.obs.events import emit_event
        from paddle_tpu_torch.utils.stats import global_counters
        self._fault_steps_since_check += 1
        if self._fault_steps_since_check < policy.effective_check_period:
            return
        self._fault_steps_since_check = 0
        cur, high = self._bad_streak
        if high >= policy.max_bad_steps:
            restored = None
            if policy.rollback and checkpoint_manager is not None and \
                    self.restore_checkpoint(checkpoint_manager):
                restored = self._step_count
            self._bad_streak = [0, 0]
            ev = evt.FaultEvent(pass_id, batch_id, "rollback", high,
                                restored)
        elif high > 0:
            # a streak below the limit, live or ended: report it once,
            # lowering the peak to the live value
            self._bad_streak = [cur, cur]
            ev = evt.FaultEvent(pass_id, batch_id, "nonfinite", high, None)
        else:
            return
        global_counters.bump("trainer/fault_events")
        emit_event(ev)      # journaled BEFORE the handler, which may raise
        event_handler(ev)

    def _run_pass(self, pass_id, reader, feeder, event_handler,
                  num_batches_per_pass, checkpoint_manager=None,
                  checkpoint_period: int = 0, skip_batches: int = 0,
                  batch_offset: int = 0):
        """One pass. batch_offset: the reader's source was SEEKED past
        the first ``batch_offset`` batches, so numbering continues from
        there; skip_batches: the replay of a non-checkpointable reader,
        whose first batches are consumed and discarded."""
        from paddle_tpu_torch.obs import context as obs_context
        from paddle_tpu_torch.utils.stats import global_counters, stat_timer
        event_handler(evt.BeginPass(pass_id))
        pass_metrics: Dict[str, float] = {}
        metrics_dev = None      # lazy path: on-device (sum, comp) pairs
        n_batches = 0
        policy = self._fault_policy
        for ev in self.evaluators:
            ev.start()
        # with host evaluators their inputs come to the host every step;
        # without, nothing in the loop needs host data per step
        lazy = not self.evaluators
        self._batch_in_pass = skip_batches or batch_offset
        self._reader_batch_base = batch_offset
        for idx, feed in enumerate(self._prefetched(reader, feeder)):
            batch_id = idx + batch_offset
            if num_batches_per_pass is not None and \
                    batch_id >= num_batches_per_pass:
                break
            if batch_id < skip_batches:
                continue        # the checkpoint already covers it
            obs_context.set_step(self._step_count)
            event_handler(evt.BeginIteration(pass_id, batch_id))
            n_real = int(feed.pop("__batch_size__"))
            rng = fold_seed(self._seed, self._step_count)
            with stat_timer("train_step"):
                if self._memory_exec is not None:
                    loss, metrics, eval_outs = self._memory_exec.run(
                        feed, rng, n_real, guarded=policy is not None,
                        ctx=(pass_id, batch_id, event_handler))
                else:
                    loss, metrics, eval_outs = self._device_step(
                        feed, n_real, rng, guarded=policy is not None)
            self._step_count += 1
            global_counters.bump("trainer/steps")
            self._profile_step(feed, rng, n_real)
            del feed
            self._batch_in_pass = batch_id + 1
            n_batches += 1
            if lazy:
                acc = {k: v.detach().float() for k, v in metrics.items()}
                if metrics_dev is None:
                    metrics_dev = {k: (v, torch.zeros_like(v))
                                   for k, v in acc.items()}
                else:
                    metrics_dev = {k: self._kahan_add(metrics_dev[k], v)
                                   for k, v in acc.items()}
                fetch_host = self._fetch_host   # the event must not pin
                # the trainer alive
                event_handler(evt.LazyEndIteration(
                    pass_id, batch_id,
                    lambda loss=loss, metrics=metrics, fh=fetch_host:
                        fh(loss, metrics)[:2]))
            else:
                loss_h, metrics_h, eval_host = self._fetch_host(
                    loss, metrics, eval_outs)
                for k, v in metrics_h.items():
                    pass_metrics[k] = pass_metrics.get(k, 0.0) + v
                metrics_h.update(self._feed_evaluators(eval_host, n_real))
                event_handler(evt.EndIteration(pass_id, batch_id, loss_h,
                                               metrics_h))
            del loss, metrics, eval_outs
            if policy is not None:
                self._check_faults(policy, pass_id, batch_id,
                                   event_handler, checkpoint_manager)
            if checkpoint_manager is not None and checkpoint_period and \
                    self._step_count % checkpoint_period == 0:
                self.save_checkpoint(checkpoint_manager)
        if metrics_dev is not None:
            # one transfer fetches the whole pass's sums
            names = list(metrics_dev)
            sums = torch.stack([torch.stack(metrics_dev[k])
                                for k in names]).double().sum(1).tolist()
            for k, v in zip(names, sums):
                pass_metrics[k] = pass_metrics.get(k, 0.0) + v
        # guarded runs: skipped steps contributed zeros — average over
        # the GOOD steps, and report the good share
        denom = float(max(n_batches, 1))
        if policy is not None and "fault_ok" in pass_metrics:
            good = pass_metrics.pop("fault_ok")
            avg = {k: v / max(good, 1.0) for k, v in pass_metrics.items()}
            avg["fault_ok"] = good / denom
        else:
            avg = {k: v / denom for k, v in pass_metrics.items()}
        for ev in self.evaluators:
            avg.update(ev.result())
        self._pass_count = pass_id + 1
        self._batch_in_pass = 0
        event_handler(evt.EndPass(pass_id, avg, self.parameters))

    @contextlib.contextmanager
    def _scratch_state(self):
        """Steps inside run on the training state and leave it as it was
        (the warmup probe's trial steps)."""
        restore = self._snapshot()
        try:
            yield
        finally:
            restore()

    # ------------------------------------------------------------------
    def save_checkpoint(self, manager, meta: Optional[Dict] = None) -> str:
        """Full-state checkpoint (parameters, optimizer slots and
        counters, layer state, the trainer's position) through a
        CheckpointManager; returns its path."""
        self._refuse_mesh_checkpoint()
        m = {"step_count": self._step_count,
             "pass_count": self._pass_count,
             "batch_in_pass": self._batch_in_pass}
        # the position of a checkpointable reader after the last
        # completed batch (pass-end saves carry none)
        if self._reader_batches is not None and self._batch_in_pass > 0:
            rs = self._reader_batches.state_for(
                self._batch_in_pass - 1 - self._reader_batch_base)
            if rs is not None:
                m["reader_state"] = rs
        if self._memory_exec is not None:
            pm = self._memory_exec.plan.to_meta()
            if pm is not None:
                m["memory_plan"] = pm
        m.update(meta or {})
        return manager.save(self._step_count, self.parameters.raw,
                            self.opt_state, self.parameters.state, m)

    def restore_checkpoint(self, manager, step: Optional[int] = None) -> bool:
        """Resume the parameters, optimizer and layer state and the
        trainer's position from the newest intact (or the given)
        checkpoint, written by either package. The parameters are
        written into the trainer's tensors in place (they stay its
        autograd leaves); a JAX-written ``rng`` in the meta is not used
        (the port's random layers fold the restored step count into the
        seed). Returns False if there is none."""
        self._refuse_mesh_checkpoint()
        res = manager.restore(step)
        if res is None:
            return False
        _, tree = res
        raw = self.parameters.raw
        own = set(self.topology.param_specs)
        with torch.no_grad():
            for k, v in tree["params"].items():
                t = torch.from_numpy(v)
                if k in own:
                    if tuple(raw[k].shape) != tuple(t.shape):
                        raise ValueError(
                            f"checkpoint parameter {k!r} has shape "
                            f"{tuple(t.shape)}, the trainer's "
                            f"{tuple(raw[k].shape)}")
                    raw[k].copy_(t)
                else:
                    raw[k] = t.to(self.device)
        self.parameters.state = {k: torch.from_numpy(v).to(self.device)
                                 for k, v in tree["state"].items()}
        self.opt_state = self._opt_state_from(tree["opt_state"])
        meta = tree["meta"]
        self._step_count = int(meta.get("step_count", 0))
        self._pass_count = int(meta.get("pass_count", 0))
        self._batch_in_pass = int(meta.get("batch_in_pass", 0))
        self._reader_state = meta.get("reader_state")
        self._restored_memory_plan = meta.get("memory_plan")
        return True

    def _refuse_mesh_checkpoint(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "full-state checkpoints of a trainer on a device mesh are "
                "not ported yet; save_parameter_to_tar writes the "
                "gathered parameters")

    def _opt_state_from(self, tree) -> Dict:
        """The optimizer state of a checkpoint in the port's form: the
        counters as host numbers (the JAX package stores int32 and
        float32 scalars), the slots as tensors on the device, each
        parameter's slot names checked against this optimizer's."""
        dev = self.device

        def tensors(d):
            return {k: torch.from_numpy(v).to(dev) for k, v in d.items()}

        out = {"step": int(tree["step"]),
               "num_samples": float(tree["num_samples"]),
               "slots": {k: tensors(v)
                         for k, v in tree.get("slots", {}).items()}}
        for k, now in self.opt_state["slots"].items():
            got = out["slots"].get(k)
            if got is None or set(got) != set(now):
                raise ValueError(
                    f"checkpoint optimizer slots of {k!r} are "
                    f"{sorted(got or {})}, this optimizer keeps "
                    f"{sorted(now)}")
        if "avg" in tree:
            out["avg"] = tensors(tree["avg"])
        return out

    def _adopt_restored_plan(self):
        """Auto-resume with microbatching on: restart at the checkpoint's
        known-safe MemoryPlan instead of re-probing or re-discovering it
        by an OOM."""
        if self._memory_exec is None or not self._restored_memory_plan:
            return
        from paddle_tpu_torch.trainer.memory import MemoryPlan
        plan = MemoryPlan.from_meta(self._restored_memory_plan,
                                    provenance="resumed")
        if plan is not None:
            self._memory_exec.adopt(plan)

    def _adopt_fleet_plan(self, meta):
        """Elastic join: adopt the fleet's published MemoryPlan (the
        coordinator's join() response) when this trainer has none better
        — a restored, configured or probed plan wins — so a replacement
        starts at the known-safe microbatch (provenance "adopted")."""
        if self._memory_exec is None or not meta:
            return
        if self._memory_exec.plan.provenance != "full":
            return
        from paddle_tpu_torch.trainer.memory import MemoryPlan
        plan = MemoryPlan.from_meta(meta, provenance="adopted")
        if plan is None:
            return
        self._memory_exec.adopt(plan)
        from paddle_tpu_torch.obs.events import emit
        emit("trainer", "plan_adopted", provenance="adopted",
             microbatch=plan.microbatch, accum_steps=plan.accum_steps)

    def test(self, reader, feeding=None) -> evt.TestResult:
        """One sweep of ``reader`` in test mode, with the optimizer's
        ``test_params``; the evaluators' training accumulators are kept
        and restored around it (test may run mid-pass)."""
        feeder = self._feeder(feeding)
        totals: Dict[str, float] = {}
        total_loss, n = 0.0, 0
        params = self.optimizer.test_params(self._own_params(),
                                            self.opt_state)
        saved = [{k: copy.deepcopy(v) for k, v in ev.__dict__.items()
                  if k != "inputs"} for ev in self.evaluators]
        for ev in self.evaluators:
            ev.start()
        with torch.no_grad():
            for batch in reader():
                feed = feeder(batch)
                n_real = int(feed.pop("__batch_size__"))
                loss, (metrics, _, eval_outs) = self._loss_and_metrics(
                    params, self.parameters.state, feed, n_real, "test")
                loss, metrics = self._reduce_reported(loss, metrics)
                loss_h, metrics_h, eval_host = self._fetch_host(
                    loss, metrics, eval_outs)
                total_loss += loss_h
                for k, v in metrics_h.items():
                    totals[k] = totals.get(k, 0.0) + v
                self._feed_evaluators(eval_host, n_real)
                n += 1
        n = max(n, 1)
        avg = {k: v / n for k, v in totals.items()}
        for ev, st in zip(self.evaluators, saved):
            avg.update(ev.result())
            ev.__dict__.update(st)
        return evt.TestResult(total_loss / n, avg)

    def gathered_parameters(self) -> Dict[str, torch.Tensor]:
        """The whole parameter table on every rank (a collective on a
        mesh: the mp/ep shards gathered, each pipeline stage's
        parameters from its rank); the trainer's own tensors, detached,
        without one."""
        raw = self.parameters.raw
        if self.mesh is None:
            return {k: v.detach() for k, v in raw.items()}
        from paddle_tpu_torch.parallel import comm
        from paddle_tpu_torch.parallel import tensor_parallel as tp
        from paddle_tpu_torch.parallel.mesh import PP_AXIS
        staged = self._pp["stack"].param_names if self._pp else set()
        out = {k: v.detach() for k, v in raw.items()}
        with torch.no_grad():
            for k in sorted(self.topology.param_specs):
                if k in staged:
                    ps = self.topology.param_specs[k]
                    held = raw.get(k)
                    t = held.detach() if held is not None else torch.zeros(
                        tuple(ps.shape), dtype=ps.dtype, device=self.device)
                    out[k] = comm.all_reduce(t, self.mesh, PP_AXIS)
                elif self._specs.get(k):
                    out[k] = tp.gather_param(raw[k].detach(), self._specs[k],
                                             self.mesh)
        return out

    def _tar_parameters(self) -> Parameters:
        if self.mesh is None:
            return self.parameters
        return Parameters(self.gathered_parameters(), self.parameters.state,
                          device=self.device)

    def save_parameter_to_tar(self, f):
        self._tar_parameters().to_tar(f)

    def save_pass(self, output_dir: str, pass_id: int):
        """ParamUtil parity: ``output_dir/pass-%05d/params.tar``."""
        params = self._tar_parameters()
        d = os.path.join(output_dir, f"pass-{pass_id:05d}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "params.tar"), "wb") as f:
            params.to_tar(f)


def _all_finite(trees) -> torch.Tensor:
    """A device bool: every floating value in ``trees`` (tensors in
    nested dicts and lists) is finite. Host numbers are not checked."""
    checks = []

    def walk(v):
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            checks.append(torch.isfinite(v).all())

    walk(trees)
    if not checks:
        return torch.tensor(True)
    return torch.stack(checks).all()


def _raise_if_nonfinite(where: str, trees) -> None:
    """``init(debug_nans=True)``: raise FloatingPointError when a value
    of ``trees`` is not finite (one host read of a device bool)."""
    if not bool(_all_finite(trees)):
        raise FloatingPointError(
            f"debug_nans: a non-finite value in the step's {where} "
            "(the cost, metrics and layer state after the forward; the "
            "gradients after the backward); no update was written")


def _default_event_handler(e):
    cfg = global_config()
    if isinstance(e, evt.EndIteration):
        if e.batch_id % max(cfg.log_period, 1) == 0:
            print(f"Pass {e.pass_id}, Batch {e.batch_id}, "
                  f"Cost {e.cost:.6f}, {e.evaluator}")
    elif isinstance(e, evt.EndPass):
        print(f"Pass {e.pass_id} done. {e.evaluator}")
    elif isinstance(e, evt.FaultEvent):
        print(f"FAULT {e!r}", file=sys.stderr)
