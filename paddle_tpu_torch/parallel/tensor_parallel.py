"""Tensor/model-parallel parameter sharding — the port of
``paddle_tpu/parallel/tensor_parallel.py``: the same rules, giving the
same specs for the same names and shapes.

Default rules (first matching rule whose axes fit the mesh):
  - expert tables ``.moe_up`` / ``.moe_down`` [E, ...] -> P("ep", None,
    None): each ep rank holds E/ep experts and runs only those
    (ops/moe.py);
  - embedding tables (vocab, emb) -> row-sharded P("mp", None): the
    pserver's sparse-remote-update rows live on their mp owner;
  - fc/projection weights (in, out) -> column-sharded P(None, "mp");
    conv kernels (kh, kw, ic, oc) -> P(None, None, None, "mp");
  - biases, gains, moving statistics -> replicated.

Parameters and their optimizer slots live as shards: a rank holds its
block of every sharded dim (:func:`shard_params`). At its use a
sharded weight is all-gathered by ``comm.all_gather``, whose backward
reduce-scatters the gradient (:func:`gather_params`), so each rank's
gradient and update touch only its shard — the pserver parity
(ParameterServer2 runs op_SGD on its local block). Expert tables are
not gathered: the MoE layer computes with the local experts.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.parallel import comm
from paddle_tpu_torch.parallel.mesh import (EP_AXIS, MP_AXIS, NamedSharding,
                                            P, axis_index, mesh_shape)

Rule = Tuple[str, P]


def default_rules() -> List[Rule]:
    return [
        (r".*\.moe_(up|down)$", P(EP_AXIS, None, None)),    # expert tables
        (r".*emb.*\.w0$|.*emb.*_w$", P(MP_AXIS, None)),     # embedding rows
        (r".*\.w\d+$|.*_w$", P(None, MP_AXIS)),             # fc columns
        (r".*wbias$|.*_b$|.*moving_.*", P()),               # 1-D: replicate
    ]


def _spec_fits(shape: Sequence[int], spec: P, mesh) -> bool:
    """Every sharded dim must exist and divide the mesh axis size."""
    if len(spec) > len(shape):
        return False
    sizes = mesh_shape(mesh)
    for dim, axis in zip(shape, spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        if any(a not in sizes for a in axes):
            return False        # rule names an axis this mesh doesn't have
        n = 1
        for a in axes:
            n *= sizes[a]
        if dim % n != 0:
            return False
    return True


def spec_for(name: str, shape: Sequence[int], mesh,
             rules: Optional[Sequence[Rule]] = None) -> P:
    """PartitionSpec for one parameter (first matching + fitting rule;
    rules whose axes the mesh lacks fall back to replication)."""
    ndim = len(shape)
    for pat, spec in (rules or default_rules()):
        if re.match(pat, name):
            # conv kernels: shard the last (out-channel) dim instead of cols
            if ndim == 4 and spec == P(None, MP_AXIS):
                spec = P(None, None, None, MP_AXIS)
            if len(spec) <= ndim and _spec_fits(shape, spec, mesh):
                return spec
            return P()
    return P()


def param_shardings(param_specs: Dict[str, object], mesh,
                    rules: Optional[Sequence[Rule]] = None
                    ) -> Dict[str, NamedSharding]:
    """Name -> NamedSharding for a topology's parameter table."""
    return {name: NamedSharding(mesh, spec_for(name, tuple(ps.shape), mesh,
                                               rules))
            for name, ps in param_specs.items()}


def _sharded_dims(spec: P):
    """[(dim, axis)] of a spec whose entries are single axis names."""
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if isinstance(axis, tuple):
            if len(axis) != 1:
                raise NotImplementedError(
                    f"a dim sharded over several axes {axis} is not "
                    "supported by the port's meshes")
            axis = axis[0]
        out.append((dim, axis))
    return out


def local_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of a full tensor under ``spec``."""
    sizes = mesh_shape(mesh)
    for dim, axis in _sharded_dims(spec):
        n = t.shape[dim] // sizes[axis]
        t = t.narrow(dim, axis_index(mesh, axis) * n, n)
    return t


def shard_params(params: Dict[str, torch.Tensor], mesh,
                 shardings: Dict[str, NamedSharding]
                 ) -> Dict[str, torch.Tensor]:
    """Each full parameter replaced by this rank's shard (a fresh
    contiguous tensor)."""
    return {k: local_shard(v, shardings[k].spec, mesh).contiguous()
            for k, v in params.items()}


def gather_param(shard: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full tensor from the ranks' shards (differentiable: the
    gradient comes back reduce-scattered onto each shard)."""
    for dim, axis in reversed(_sharded_dims(spec)):
        shard = comm.all_gather(shard, mesh, axis, dim)
    return shard


def gather_params(params: Dict[str, torch.Tensor], specs: Dict[str, P],
                  mesh, keep_local: Sequence[str] = ()) -> Dict:
    """Full tensors for every sharded parameter but the ep-sharded
    expert tables and the names in ``keep_local`` (the row-sparse
    tables, read through their prefetched rows)."""
    out = {}
    for k, v in params.items():
        spec = specs.get(k, P())
        if k in keep_local or not spec or EP_AXIS in spec:
            out[k] = v
        else:
            out[k] = gather_param(v, spec, mesh)
    return out


def opt_state_shardings(opt_state, param_shardings: Dict[str, NamedSharding],
                        mesh):
    """Optimizer slots mirror their parameter's sharding (momentum/adam
    moments have the param's shape); host counters and scalars
    replicate. A lower-rank slot (the per-row ``_t`` clock [vocab] of a
    row-sharded [vocab, emb] table) keeps the leading axes."""
    repl = NamedSharding(mesh, P())

    def assign(path, leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return repl
        for key in path:
            if key in param_shardings:
                sh = param_shardings[key]
                if len(sh.spec) <= leaf.dim():
                    return sh
                return NamedSharding(mesh, P(*sh.spec[: leaf.dim()]))
        return repl

    def walk(path, v):
        if isinstance(v, dict):
            return {k: walk(path + (k,), x) for k, x in v.items()}
        return assign(path, v)

    return walk((), opt_state)
