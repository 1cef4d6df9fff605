"""Topology — the serializable model graph and its executor; the port
of ``paddle_tpu/core/topology.py``.

The graph is recovered from the output LayerOutputs (parents first),
serialized as the same ``paddle_tpu.topology.v1`` JSON, and executed
by ``forward(params, state, feed)``: one eager pass over the layers in
topological order. Gradients come from torch autograd over the
parameter tensors, where the JAX package differentiates the traced
function with ``jax.grad``. A topology that generates (it holds a
``beam_search`` layer, which no gradient goes through) runs its forward
without autograd, so its recurrences take the no-gradient kernel routes
even on parameters that require gradients.
"""

from __future__ import annotations

import contextlib
import json
import warnings
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from paddle_tpu_torch.core.data_type import InputType, SeqType
from paddle_tpu_torch.core.registry import (ApplyContext, LayerOutput,
                                            ParamAttr, ParamSpec, StateSpec,
                                            get_layer_impl, make_layer)
from paddle_tpu_torch.core.sequence import SequenceBatch


def _collect(outputs: Sequence[LayerOutput]) -> List[LayerOutput]:
    """Topological order (parents first) of the sub-graph reaching
    ``outputs`` — the JAX package's iterative DFS, so both packages
    list the layers in the same order."""
    order: List[LayerOutput] = []
    seen: Dict[int, bool] = {}
    stack = [(o, False) for o in reversed(list(outputs))]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            order.append(node)
            continue
        if seen.get(id(node)):
            continue
        seen[id(node)] = True
        stack.append((node, True))
        for p in reversed(node.parents):
            if not seen.get(id(p)):
                stack.append((p, False))
    return order


_warned_orphan_outputs: set = set()


class Topology:
    """The model: layers in topo order + parameter/state specs."""

    def __init__(self, outputs: Union[LayerOutput, Sequence[LayerOutput]],
                 extra_outputs: Sequence[LayerOutput] = ()):
        if isinstance(outputs, LayerOutput):
            outputs = [outputs]
        self.outputs = list(outputs) + list(extra_outputs)
        self.layers = _collect(self.outputs)
        names = [l.name for l in self.layers]
        dup = {n for n in names if names.count(n) > 1}
        if dup:
            raise ValueError(f"duplicate layer names in topology: {sorted(dup)}")
        self.by_name = {l.name: l for l in self.layers}
        # a cost node tagged with a declared inference head that is NOT
        # in this graph: the builder holds a cost-only topology (the
        # transformer's probs side branch) — warn once per head
        for o in self.outputs:
            declared = getattr(o, "declared_output", None)
            if declared is not None and declared not in self.by_name \
                    and declared not in _warned_orphan_outputs:
                _warned_orphan_outputs.add(declared)
                warnings.warn(
                    f"topology built from a cost graph that does NOT "
                    f"contain the model's declared output {declared!r} "
                    "(a side branch): build inference topologies from "
                    "spec.output, or pass extra_outputs=[spec.output] "
                    "here", stacklevel=2)
                break
        # merge param specs (shared params must agree on shape)
        self.param_specs: Dict[str, ParamSpec] = {}
        self.state_specs: Dict[str, StateSpec] = {}
        for l in self.layers:
            for ps in l.params:
                if ps.name in self.param_specs:
                    prev = self.param_specs[ps.name]
                    if tuple(prev.shape) != tuple(ps.shape):
                        raise ValueError(
                            f"shared parameter {ps.name!r} shape mismatch: "
                            f"{prev.shape} vs {ps.shape}")
                else:
                    self.param_specs[ps.name] = ps
            for ss in l.states:
                self.state_specs[ss.name] = ss
        self.generates = any(l.type == "beam_search" for l in self.layers)

    # ------------------------------------------------------------------ init
    def init_params(self, generator: Optional[torch.Generator] = None,
                    only: Optional[Sequence[str]] = None,
                    device=None) -> Dict[str, torch.Tensor]:
        """Initialize parameters in sorted name order from one
        generator (the same distributions as the JAX package, not the
        same draws). ``only`` restricts to a subset of names."""
        if generator is None:
            from paddle_tpu_torch.config import global_config
            generator = torch.Generator().manual_seed(global_config().seed)
        wanted = None if only is None else set(only)
        params = {}
        for name, ps in sorted(self.param_specs.items()):
            if wanted is not None and name not in wanted:
                continue
            params[name] = ps.initializer(generator, tuple(ps.shape),
                                          ps.dtype).to(device)
        return params

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        return {name: torch.full(tuple(ss.shape), ss.init_value,
                                 dtype=ss.dtype, device=device)
                for name, ss in sorted(self.state_specs.items())}

    # --------------------------------------------------------------- forward
    def forward(self, params: Dict[str, torch.Tensor],
                state: Dict[str, torch.Tensor],
                feed: Dict[str, Any], *, mode: str = "train",
                rng: Optional[int] = None,
                output_names: Optional[Sequence[str]] = None,
                sparse_sub: Optional[Dict[str, Any]] = None,
                injected: Optional[Dict[str, Any]] = None,
                skip: Sequence[str] = (), mesh=None, n_real=None,
                taps: Optional[Dict[str, Any]] = None):
        """One forward pass. Returns (outputs_dict, new_state);
        ``outputs_dict`` maps layer name -> value for the requested
        outputs (default: ``self.outputs``). ``rng`` seeds the random
        layers (dropout) of a train step, ``ApplyContext.rng_for``.
        ``sparse_sub``: {table name: (uids, rows)} prefetched row blocks
        — embedding layers whose table appears there look ids up inside
        the block, so gradients stay row-sparse (an entry may carry the
        table's global row count third, for a table held as a shard).
        ``injected`` / ``skip``: values computed elsewhere (the
        pipelined body's output) and layer names NOT to run here; a
        skipped value that is not injected and is consumed downstream
        raises KeyError. ``mesh``: the trainer's device mesh
        (parallel/mesh.py); layers read it to take their sharded paths
        (ring attention over sp, the MoE's global routing and ep
        experts, batch statistics over dp). ``taps``: {layer name:
        tensor added to that layer's output (its payload, for a
        sequence)}; a None entry is filled with a fresh zero leaf that
        requires grad, so that autograd's gradient of the caller's loss
        with respect to it is d(loss)/d(output) (gradient_printer)."""
        with torch.no_grad() if self.generates else contextlib.nullcontext():
            return self._forward(params, state, feed, mode, rng,
                                 output_names, n_real, sparse_sub, taps,
                                 injected, skip, mesh)

    def _forward(self, params, state, feed, mode, rng, output_names,
                 n_real, sparse_sub=None, taps=None, injected=None,
                 skip=(), mesh=None):
        ctx = ApplyContext(mode, state, rng)
        ctx.n_real = n_real
        ctx.sparse_sub = sparse_sub
        ctx.mesh = mesh
        values: Dict[str, Any] = dict(injected or {})
        skip_set = set(skip)
        wanted = set(output_names) if output_names is not None else \
            {o.name for o in self.outputs}
        for layer in self.layers:
            if layer.name in values or layer.name in skip_set:
                continue
            impl = get_layer_impl(layer.type)
            if layer.type == "data":
                if layer.name not in feed:
                    raise KeyError(f"missing feed for data layer {layer.name!r}")
                values[layer.name] = impl["apply"](ctx, layer.name,
                                                   layer.config, {},
                                                   [feed[layer.name]])
            else:
                lparams = {ps.name: params[ps.name] for ps in layer.params}
                inputs = [values[p.name] for p in layer.parents]
                values[layer.name] = impl["apply"](ctx, layer.name,
                                                   layer.config, lparams,
                                                   inputs)
            if taps is not None and layer.name in taps:
                values[layer.name] = _tapped(values[layer.name], taps,
                                             layer.name)
        new_state = dict(state)
        new_state.update(ctx.state_updates)
        outs = {n: values[n] for n in wanted if n in values}
        return outs, new_state

    # ----------------------------------------------------------- sparse path
    def sparse_tables(self) -> Dict[str, str]:
        """param_name -> ids data-layer name, for every embedding table
        marked ParamAttr(sparse=True) whose ids come straight from a data
        layer (the prefetchable set). A sparse table fed by computed
        ids, or shared across two id sources, falls back to dense
        gradients."""
        out: Dict[str, str] = {}
        dense_fallback = set()
        for l in self.layers:
            if l.type != "embedding":
                continue
            for ps in l.params:
                if not getattr(ps.attr, "sparse", False):
                    continue
                if not (l.parents and l.parents[0].type == "data"):
                    dense_fallback.add(ps.name)     # computed ids
                elif ps.name in out and out[ps.name] != l.parents[0].name:
                    dense_fallback.add(ps.name)     # shared across sources
                else:
                    out[ps.name] = l.parents[0].name
        for n in dense_fallback:
            out.pop(n, None)
        return out

    def remote_tables(self) -> Dict[str, str]:
        """param_name -> ids data-layer name, for every embedding table
        marked ``remote=True`` — the set :class:`embed.lookup.RemoteLookup`
        must gather rows for before each forward. Remote ids must come
        straight from a data layer (they are fetched host-side, before
        the forward can compute anything)."""
        out: Dict[str, str] = {}
        for l in self.layers:
            if l.type != "embedding" or not l.config.get("_remote"):
                continue
            assert l.parents and l.parents[0].type == "data", \
                f"remote embedding {l.name!r} must read ids from a " \
                "data layer (rows are gathered host-side per batch)"
            out[l.config["_w_name"]] = l.parents[0].name
        return out

    # ------------------------------------------------------------ data layers
    def data_layers(self) -> Dict[str, LayerOutput]:
        """Name -> data layer, in declaration order (the feeding order)."""
        return {l.name: l for l in self.layers if l.type == "data"}

    def get_layer(self, name: str) -> LayerOutput:
        """The layer node by name (v2's ``Topology.get_layer``)."""
        if name not in self.by_name:
            raise ValueError(f"layer {name!r} not in topology; have "
                             f"{sorted(self.by_name)}")
        return self.by_name[name]

    def data_type(self):
        """[(name, InputType)] for the DataFeeder."""
        return [(name, l.config["input_type"])
                for name, l in self.data_layers().items()]

    # ----------------------------------------------------------- serialization
    def serialize(self) -> str:
        """The ``paddle_tpu.topology.v1`` JSON model config."""
        layers = []
        for l in self.layers:
            layers.append({
                "name": l.name,
                "type": l.type,
                "inputs": [p.name for p in l.parents],
                "config": _jsonify(l.config),
            })
        return json.dumps({
            "format": "paddle_tpu.topology.v1",
            "layers": layers,
            "outputs": [o.name for o in self.outputs],
        }, indent=1)

    @staticmethod
    def deserialize(blob: Union[str, bytes]) -> "Topology":
        spec = json.loads(blob)
        if spec.get("format") != "paddle_tpu.topology.v1":
            raise ValueError("bad topology blob")
        built: Dict[str, LayerOutput] = {}
        for ld in spec["layers"]:
            cfg = _unjsonify(ld["config"])
            inputs = [built[n] for n in ld["inputs"]]
            built[ld["name"]] = make_layer(ld["type"], ld["name"], inputs,
                                           **cfg)
        return Topology([built[n] for n in spec["outputs"]])

    def proto(self) -> str:
        """v2's ``Topology.proto()``: the serialized model config."""
        return self.serialize()


def _tapped(v, taps, name):
    """``v`` plus its tap ``taps[name]`` (made a zero leaf when None)."""
    seq = isinstance(v, SequenceBatch)
    data = v.data if seq else v
    if taps[name] is None:
        taps[name] = torch.zeros_like(data).requires_grad_(True)
    data = data + taps[name]
    return v.with_data(data) if seq else data


def _jsonify(obj):
    if isinstance(obj, dict):
        # "_obj_*" keys hold runtime-only objects — never serialized
        return {k: _jsonify(v) for k, v in obj.items()
                if not k.startswith("_obj_")}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, InputType):
        return {"__input_type__": [obj.dim, obj.kind, obj.seq_type.value]}
    if isinstance(obj, SeqType):
        return {"__seq_type__": obj.value}
    if isinstance(obj, ParamAttr):
        # initializer callables are init-time only; dropped
        d = {
            "name": obj.name, "learning_rate": obj.learning_rate,
            "l1_rate": obj.l1_rate, "l2_rate": obj.l2_rate,
            "is_static": obj.is_static, "sparse": obj.sparse,
            "initial_std": obj.initial_std, "initial_mean": obj.initial_mean,
            "gradient_clipping_threshold": obj.gradient_clipping_threshold}
        hooks = obj.update_hooks
        if hooks is not None:
            d["update_hooks"] = [
                {"type": h.type,
                 "sparsity_ratio": getattr(h, "sparsity_ratio", None)}
                for h in (hooks if isinstance(hooks, (list, tuple))
                          else [hooks])]
        return {"__param_attr__": d}
    return obj


def _unjsonify(obj):
    if isinstance(obj, dict):
        if "__input_type__" in obj:
            d, k, s = obj["__input_type__"]
            return InputType(d, k, SeqType(s))
        if "__seq_type__" in obj:
            return SeqType(obj["__seq_type__"])
        if "__param_attr__" in obj:
            d = dict(obj["__param_attr__"])
            if d.get("update_hooks"):
                from paddle_tpu_torch.attr import HookAttribute
                d["update_hooks"] = [
                    HookAttribute(h["type"], h.get("sparsity_ratio"))
                    for h in d["update_hooks"]]
            return ParamAttr(**d)
        return {k: _unjsonify(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unjsonify(v) for v in obj]
    return obj
