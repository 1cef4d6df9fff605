"""Asynchronous data parallelism as local-SGD islands — the port of
``paddle_tpu/parallel/async_sgd.py``.

The reference's async SGD (``ParameterServer2::asyncSGD``, the Go
pserver's barrier-free ``SendGrad``) lets each trainer step without
waiting for its peers, ``max_async_count`` bounding the staleness. The
form that survives is local SGD: every island steps on its own shard
and the islands periodically reconcile by averaging parameters — one
collective, no server.

- :func:`average_pytree`: cross-PROCESS parameter averaging over the
  process group (identity in a world of one), a poisoned island
  weighted out.
- :class:`AsyncSGDIsland`: wraps an SGD trainer; ``train_batch`` counts
  local steps and reconciles every ``sync_period`` (the drift bound),
  per process (``sync_group=None``) or across in-process islands
  (``sync_group=`` their Parameters). Reconciling writes the average
  into each trainer's parameter tensors in place, so they stay its
  autograd leaves.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.utils.stats import global_counters


def _float_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _float_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _float_leaves(v)
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield tree


def tree_isfinite(tree) -> bool:
    """True when every float tensor of the tree is finite (one device
    reduction, one host read)."""
    checks = [torch.isfinite(t.detach()).all() for t in _float_leaves(tree)]
    return bool(torch.stack(checks).all()) if checks else True


def filter_finite_rows(keys, grads, counter: str = "parallel/poisoned_rows"):
    """The reconcile guard applied row-wise to a SPARSE gradient push: a
    non-finite gradient row is dropped from the update (counter +
    warning) instead of contaminating the shared table. Returns the
    surviving ``(keys, grads)`` (numpy); an all-poisoned batch comes
    back empty."""
    keys = np.asarray(keys)
    grads = np.asarray(grads)
    finite = np.isfinite(grads).reshape(grads.shape[0], -1).all(axis=1)
    if finite.all():
        return keys, grads
    n_bad = int((~finite).sum())
    global_counters.bump(counter, n_bad)
    warnings.warn(
        f"{n_bad} sparse gradient row(s) non-finite at push; dropped "
        "from the update (reconcile guard applied row-wise)",
        stacklevel=2)
    return keys[finite], grads[finite]


def average_pytree(tree: Dict[str, torch.Tensor], valid: Optional[bool] = None):
    """Average a {name: tensor} tree across the processes of the group.
    Every process must call it with the same names and shapes (a
    collective); a world of one returns the tree.

    valid: this process's vote on whether its own tree may enter the
    average. Invalid trees are weighted out (every process still takes
    part in the collective) and their non-finite values zeroed first; if
    every process votes invalid the trees pass through unchanged."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree
    from paddle_tpu_torch.parallel.comm import sum_over_world
    some = next(iter(tree.values()))
    w = torch.tensor(0.0 if valid is False else 1.0, dtype=torch.float32,
                     device=some.device)
    n_valid = float(sum_over_world(w))
    if n_valid == 0.0:
        return tree
    out = {}
    for k, x in tree.items():
        x = x.detach()
        clean = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        out[k] = (sum_over_world(clean * w.to(x.dtype)) / n_valid) \
            .to(x.dtype)
    return out


def average_local(trees: Sequence[Dict[str, torch.Tensor]]):
    """Average the parameter dicts of in-process islands; each island
    gets an independent copy."""
    keys = trees[0].keys()
    for t in trees:
        assert t.keys() == keys, "islands must share parameter names"
    avg = {k: torch.mean(torch.stack([t[k].detach() for t in trees]), dim=0)
           for k in keys}
    return [{k: v.clone() for k, v in avg.items()} for _ in trees]


def _write(parameters, values: Dict[str, torch.Tensor]) -> None:
    """Values into a Parameters' tensors, in place where they exist."""
    raw = parameters.raw
    with torch.no_grad():
        for k, v in values.items():
            if k in raw and isinstance(raw[k], torch.Tensor) and \
                    raw[k].shape == v.shape:
                raw[k].copy_(v)
            else:
                raw[k] = v


class AsyncSGDIsland:
    """Local-SGD wrapper: train independently, reconcile periodically.

    trainer:      a paddle_tpu_torch SGD instance (this island's)
    sync_period:  local steps between reconciliations — the staleness
                  bound (ParameterServer2's max_async_count role)
    sync_group:   None = average across PROCESSES (each one island); or
                  the Parameters of sibling in-process islands (this
                  trainer's included)
    generation_source: optional zero-arg callable returning the elastic
                  coordinator's membership generation; a change between
                  batches reconciles at once (a fleet that grew or
                  shrank restarts from the common average)."""

    def __init__(self, trainer, sync_period: int = 8,
                 sync_group: Optional[Sequence] = None,
                 generation_source=None):
        assert sync_period >= 1
        self.trainer = trainer
        self.sync_period = sync_period
        self.sync_group = sync_group
        self.generation_source = generation_source
        self._local_steps = 0
        self._last_generation: Optional[int] = None
        self.reshape_reconciles = 0

    def notify_reshape(self, generation: int):
        """Membership changed (SGD.train's ``on_reshape`` hook): reconcile
        now, once per generation."""
        if generation == self._last_generation:
            return
        self._last_generation = generation
        self.reshape_reconciles += 1
        global_counters.bump("parallel/reshape_reconciles")
        self.reconcile()

    def _poll_generation(self):
        if self.generation_source is None:
            return
        gen = self.generation_source()
        if self._last_generation is None:
            self._last_generation = gen      # baseline, not a reshape
            return
        if gen != self._last_generation:
            self.notify_reshape(gen)

    def train_batch(self, batch, feeding=None):
        self._poll_generation()
        loss, metrics = self.trainer.train_batch(batch, feeding)
        self._local_steps += 1
        if self._local_steps % self.sync_period == 0:
            self.reconcile()
        return loss, metrics

    def reconcile(self):
        """Average the parameters across the island group now. An island
        whose parameters are not finite is dropped from the average
        (warning + ``parallel/poisoned_islands``) and healed by adopting
        the healthy islands' average; if every island is poisoned the
        reconcile is a no-op."""
        if self.sync_group is None:
            own = dict(self.trainer.parameters.raw)
            ok = tree_isfinite(own)
            if not ok:
                global_counters.bump("parallel/poisoned_islands")
                warnings.warn(
                    "this island's parameters are non-finite at "
                    "reconcile; its tree is dropped from the average "
                    "and replaced by the healthy islands'",
                    stacklevel=2)
            _write(self.trainer.parameters, average_pytree(own, valid=ok))
            return
        raws = [dict(p.raw) for p in self.sync_group]
        finite = [tree_isfinite(r) for r in raws]
        bad = [i for i, f in enumerate(finite) if not f]
        if bad:
            global_counters.bump("parallel/poisoned_islands", len(bad))
            warnings.warn(
                f"island(s) {bad} have non-finite parameters at "
                "reconcile; dropping their trees from the average "
                f"({len(raws) - len(bad)} healthy island(s) remain)",
                stacklevel=2)
        good = [r for r, f in zip(raws, finite) if f]
        if not good:
            warnings.warn(
                "every island's parameters are non-finite; skipping "
                "reconcile (rollback/fault policy is the remaining "
                "recovery)", stacklevel=2)
            return
        clean = average_local(good)[0]
        for p in self.sync_group:
            _write(p, {k: v.clone() for k, v in clean.items()})
