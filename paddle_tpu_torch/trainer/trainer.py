"""SGD trainer — the port of the plain train loop of
``paddle_tpu/trainer/trainer.py``.

One step is: feed conversion, ``Topology.forward``, the masked
per-row cost summed and divided by the real row count,
``torch.autograd.grad`` over this trainer's parameter tensors (autograd
leaves), and ``optimizer.update``, which writes the new values into
those tensors under ``no_grad``. The loss and metrics come back to the
host in one transfer per step. PyTorch runs the step eagerly where the
JAX package jits it.

Not in this slice (each raises): a device mesh, evaluators, pipeline
stages, and the checkpoint / elastic / fault / microbatch options of
``train``.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Sequence

import torch

from paddle_tpu_torch.config import global_config
from paddle_tpu_torch.core.registry import LayerOutput
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.trainer import event as evt
from paddle_tpu_torch.trainer.data_feeder import DataFeeder
from paddle_tpu_torch.trainer.parameters import Parameters


class SGD:
    """v2-compatible trainer: ``cost`` (a cost LayerOutput or a list),
    ``parameters`` (Parameters), ``update_equation`` (an Optimizer);
    ``extra_layers`` are metric nodes reported in the events. Runs on
    ``device`` (the CUDA card unless the CPU is asked for); parameters
    living elsewhere move there."""

    def __init__(self, cost, parameters: Parameters, update_equation,
                 extra_layers: Optional[Sequence[LayerOutput]] = None,
                 is_local: bool = True, mesh=None, evaluators=None,
                 pipeline_stages=None, device: DeviceLike = None, **kwargs):
        if mesh is not None or pipeline_stages is not None:
            raise NotImplementedError(
                "mesh and pipeline parallelism are not ported yet (the "
                "parallelism slice, ROADMAP.md queue A)")
        if evaluators:
            raise NotImplementedError("evaluators are not ported yet")
        self.device = resolve_device(device)
        costs = cost if isinstance(cost, (list, tuple)) else [cost]
        self.costs = list(costs)
        self.extra_layers = list(extra_layers or [])
        self.topology = Topology(self.costs, extra_outputs=self.extra_layers)
        self.parameters = parameters
        for name, spec in self.topology.state_specs.items():
            if name not in parameters.state:
                parameters.state[name] = torch.full(
                    tuple(spec.shape), spec.init_value, dtype=spec.dtype,
                    device=self.device)
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
        self.optimizer = update_equation.bind(self.topology.param_specs)
        self.opt_state = self.optimizer.init_state(self._own_params())

    # ------------------------------------------------------------------
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
                          mode: str):
        outs, new_state = self.topology.forward(params, state, feed,
                                                mode=mode, n_real=n_real)
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
        return total, (metrics, new_state)

    @staticmethod
    def _fetch_host(loss, metrics):
        """One device -> host transfer for a step's loss and metrics."""
        names = list(metrics)
        vals = torch.stack([loss.detach().float()] +
                           [metrics[k].detach().float() for k in names])
        host = vals.cpu().tolist()
        return host[0], dict(zip(names, host[1:]))

    def _step(self, feed, n_real: int):
        params = self._own_params()
        loss, (metrics, new_state) = self._loss_and_metrics(
            params, self.parameters.state, feed, n_real, "train")
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
        _, self.opt_state = self.optimizer.update(
            params, dict(zip(names, grads)), self.opt_state, n_real)
        self.parameters.state = new_state
        return self._fetch_host(loss, metrics)

    def _feeder(self, feeding):
        return DataFeeder(self.topology.data_type(), feeding,
                          device=self.device)

    def train_batch(self, data_batch, feeding=None):
        """One optimizer step on a batch (a list of sample tuples);
        returns (cost, metrics) as host floats."""
        feed = self._feeder(feeding)(data_batch)
        n_real = int(feed.pop("__batch_size__"))
        return self._step(feed, n_real)

    def train(self, reader=None, num_passes: int = 1,
              event_handler: Optional[Callable] = None, feeding=None,
              num_batches_per_pass: Optional[int] = None, **kwargs):
        """reader: callable yielding batches (lists of sample tuples).
        Emits BeginPass / BeginIteration / EndIteration / EndPass; the
        EndPass metrics are the pass averages."""
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
            for batch_id, batch in enumerate(reader()):
                if num_batches_per_pass is not None and \
                        batch_id >= num_batches_per_pass:
                    break
                event_handler(evt.BeginIteration(pass_id, batch_id))
                feed = feeder(batch)
                n_real = int(feed.pop("__batch_size__"))
                loss, metrics = self._step(feed, n_real)
                for k, v in metrics.items():
                    pass_metrics[k] = pass_metrics.get(k, 0.0) + v
                n_batches += 1
                event_handler(evt.EndIteration(pass_id, batch_id, loss,
                                               metrics))
            denom = float(max(n_batches, 1))
            avg = {k: v / denom for k, v in pass_metrics.items()}
            event_handler(evt.EndPass(pass_id, avg, self.parameters))

    def test(self, reader, feeding=None) -> evt.TestResult:
        feeder = self._feeder(feeding)
        totals: Dict[str, float] = {}
        total_loss, n = 0.0, 0
        params = self._own_params()
        with torch.no_grad():
            for batch in reader():
                feed = feeder(batch)
                n_real = int(feed.pop("__batch_size__"))
                loss, (metrics, _) = self._loss_and_metrics(
                    params, self.parameters.state, feed, n_real, "test")
                loss_h, metrics_h = self._fetch_host(loss, metrics)
                total_loss += loss_h
                for k, v in metrics_h.items():
                    totals[k] = totals.get(k, 0.0) + v
                n += 1
        n = max(n, 1)
        return evt.TestResult(total_loss / n,
                              {k: v / n for k, v in totals.items()})

    def save_parameter_to_tar(self, f):
        self.parameters.to_tar(f)


def _default_event_handler(e):
    cfg = global_config()
    if isinstance(e, evt.EndIteration):
        if e.batch_id % max(cfg.log_period, 1) == 0:
            print(f"Pass {e.pass_id}, Batch {e.batch_id}, "
                  f"Cost {e.cost:.6f}, {e.evaluator}")
    elif isinstance(e, evt.EndPass):
        print(f"Pass {e.pass_id} done. {e.evaluator}")
