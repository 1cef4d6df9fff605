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

Not ported yet (each raises): a device mesh, pipeline stages, and the
checkpoint / elastic / fault / microbatch options of ``train``.
"""

from __future__ import annotations

import copy
import os
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import torch

from paddle_tpu_torch.config import global_config
from paddle_tpu_torch.core.registry import LayerOutput, fold_seed
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.device import DeviceLike, resolve_device
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
                 pipeline_stages=None, device: DeviceLike = None, **kwargs):
        if mesh is not None or pipeline_stages is not None:
            raise NotImplementedError(
                "mesh and pipeline parallelism are not ported yet (the "
                "parallelism slice, ROADMAP.md queue A)")
        self.device = resolve_device(device)
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
        self.optimizer = update_equation.bind(
            self.topology.param_specs, sparse_params=self._sparse_map.keys())
        self.opt_state = self.optimizer.init_state(self._own_params())
        # the random layers' seed: each step folds in its count, and each
        # layer its name (ApplyContext.rng_for)
        self._seed = global_config().seed
        self._step_count = 0

    # ------------------------------------------------------------------
    def refresh_update_hooks(self):
        """Recompute parameter-hook state (pruning masks) from the
        current parameter values — after loading weights into a trainer
        already made."""
        self.opt_state = self.optimizer.refresh_hooks(self._own_params(),
                                                      self.opt_state)

    def _own_params(self) -> Dict[str, torch.Tensor]:
        raw = self.parameters.raw
        return {k: raw[k] for k in self.topology.param_specs}

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
                          sparse_sub=None, taps=None):
        outs, new_state = self.topology.forward(params, state, feed,
                                                mode=mode, rng=rng,
                                                n_real=n_real,
                                                sparse_sub=sparse_sub,
                                                taps=taps)
        total = 0.0
        metrics = {}
        for c in self.costs:
            cost_val = self._masked_cost(outs[c.name], 0, n_real)
            total = total + cost_val
            metrics[c.name] = cost_val
        for e in self.extra_layers:
            v = outs[e.name]
            if isinstance(v, SequenceBatch):
                m = v.mask()
                data = v.data.reshape(v.data.shape[0], v.data.shape[1], -1)
                metrics[e.name] = torch.sum(data.float().mean(-1) * m) / \
                    torch.clamp(torch.sum(m), min=1.0)
            else:
                v = v.reshape(v.shape[0], -1).float().mean(dim=-1)
                row_mask = (torch.arange(v.shape[0], device=v.device)
                            < n_real).to(v.dtype)
                metrics[e.name] = torch.sum(v * row_mask) / \
                    max(float(n_real), 1.0)
        # evaluator inputs: graph outputs, or raw feed entries (labels)
        eval_outs = {n: (outs[n] if n in outs else feed[n])
                     for n in self._eval_out_names}
        return total, (metrics, new_state, eval_outs)

    @staticmethod
    def _fetch_host(loss, metrics, eval_outs=None):
        """One device -> host transfer for a step's loss, metrics and
        evaluator inputs: the scalars and every evaluator tensor go to
        the host as one byte buffer. Returns (loss, {name: metric},
        {name: host tensor or SequenceBatch of host tensors})."""
        names = list(metrics)
        scalars = torch.stack([loss.detach().float()] +
                              [metrics[k].detach().float() for k in names])
        parts = [scalars]
        for v in (eval_outs or {}).values():
            parts += [v.data, v.lengths] if isinstance(v, SequenceBatch) \
                else [v]
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
        params = self._own_params()
        rng = fold_seed(self._seed, self._step_count)
        self._step_count += 1
        loss, (metrics, new_state, eval_outs) = self._train_step(
            params, feed, n_real, rng)
        # detached: a moving statistic that kept its graph would hold
        # every earlier step's activations alive
        self.parameters.state = {k: v.detach()
                                 for k, v in new_state.items()}
        return self._fetch_host(loss, metrics,
                                eval_outs if fetch_evals else None)

    def _train_step(self, params, feed, n_real: int, rng):
        """The train step: prefetch each row-sparse table's touched rows,
        forward on those row blocks, gradients of the dense parameters
        and the blocks (never of the tables), the update. With no
        row-sparse table it is the plain dense step. The gradient
        printers' activation gradients (the taps') join the evaluator
        inputs as ``__grad__<layer>``."""
        from paddle_tpu_torch.ops import embedding as emb_ops
        next_step = self.opt_state["step"] + 1
        slots = self.opt_state["slots"]
        uids, rows0, slot_rows = {}, {}, {}
        for pname, src in self._sparse_map.items():
            v = feed[src]
            ids = v.data if isinstance(v, SequenceBatch) else v
            uids[pname] = emb_ops.touched_ids(ids, params[pname].shape[0])
            rows0[pname], slot_rows[pname] = self.optimizer.sparse_prefetch(
                pname, params[pname], slots[pname], uids[pname], next_step)
        rows = {k: r.detach().requires_grad_(True) for k, r in rows0.items()}
        sub = {k: (uids[k], rows[k]) for k in rows}
        taps = dict.fromkeys(self._grad_tap_names) or None
        out = self._loss_and_metrics(params, self.parameters.state, feed,
                                     n_real, "train", rng, sparse_sub=sub,
                                     taps=taps)
        dense = [k for k in params if k not in self._sparse_map]
        tables = list(rows)
        tapped = list(taps or ())
        grads = torch.autograd.grad(
            out[0], [params[k] for k in dense] + [rows[k] for k in tables]
            + [taps[k] for k in tapped], allow_unused=True)
        g_taps = grads[len(dense) + len(tables):]
        grads = grads[:len(dense) + len(tables)]
        for k, g in zip(tapped, g_taps):
            out[1][2]["__grad__" + k] = torch.zeros_like(taps[k]) \
                if g is None else g
        g_rows = grads[len(dense):]
        sparse_rows = {
            k: (uids[k], torch.zeros_like(rows0[k]) if g is None else g,
                rows0[k], slot_rows[k])
            for k, g in zip(tables, g_rows)}
        _, self.opt_state = self.optimizer.update(
            params, dict(zip(dense, grads[:len(dense)])), self.opt_state,
            n_real, sparse_rows=sparse_rows)
        return out

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
              num_batches_per_pass: Optional[int] = None, **kwargs):
        """reader: callable yielding batches (lists of sample tuples).
        Emits BeginPass / BeginIteration / EndIteration / EndPass; the
        EndIteration metrics carry the evaluators' running results, the
        EndPass metrics the pass averages and the evaluators' pass
        results."""
        unsupported = sorted(k for k, v in kwargs.items() if v)
        if unsupported:
            raise NotImplementedError(
                f"train options {unsupported} are not ported yet (only the "
                "plain loop is in this slice)")
        if event_handler is None:
            event_handler = _default_event_handler
        feeder = self._feeder(feeding)
        for pass_id in range(num_passes):
            event_handler(evt.BeginPass(pass_id))
            pass_metrics: Dict[str, float] = {}
            n_batches = 0
            for ev in self.evaluators:
                ev.start()
            for batch_id, batch in enumerate(reader()):
                if num_batches_per_pass is not None and \
                        batch_id >= num_batches_per_pass:
                    break
                event_handler(evt.BeginIteration(pass_id, batch_id))
                feed = feeder(batch)
                n_real = int(feed.pop("__batch_size__"))
                loss, metrics, eval_host = self._step(feed, n_real)
                for k, v in metrics.items():
                    pass_metrics[k] = pass_metrics.get(k, 0.0) + v
                metrics.update(self._feed_evaluators(eval_host, n_real))
                n_batches += 1
                event_handler(evt.EndIteration(pass_id, batch_id, loss,
                                               metrics))
            denom = float(max(n_batches, 1))
            avg = {k: v / denom for k, v in pass_metrics.items()}
            for ev in self.evaluators:
                avg.update(ev.result())
            event_handler(evt.EndPass(pass_id, avg, self.parameters))

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

    def save_parameter_to_tar(self, f):
        self.parameters.to_tar(f)

    def save_pass(self, output_dir: str, pass_id: int):
        """ParamUtil parity: ``output_dir/pass-%05d/params.tar``."""
        d = os.path.join(output_dir, f"pass-{pass_id:05d}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "params.tar"), "wb") as f:
            self.parameters.to_tar(f)


def _default_event_handler(e):
    cfg = global_config()
    if isinstance(e, evt.EndIteration):
        if e.batch_id % max(cfg.log_period, 1) == 0:
            print(f"Pass {e.pass_id}, Batch {e.batch_id}, "
                  f"Cost {e.cost:.6f}, {e.evaluator}")
    elif isinstance(e, evt.EndPass):
        print(f"Pass {e.pass_id} done. {e.evaluator}")
