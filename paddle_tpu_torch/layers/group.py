"""recurrent_group — the dynamic recurrent engine; the port of
``paddle_tpu/layers/group.py``.

The step sub-network is captured as its own Topology at build time (the
user's step function runs once, on placeholder data layers) and
serialized into the group node's config, so a group writes the same
``paddle_tpu.topology.v1`` JSON as in the JAX package. ``apply`` runs
that sub-topology eagerly once per timestep of the padded time axis,
with the memories as the loop's carries; padded steps freeze every
memory and write zero outputs, so results follow the ragged semantics.
Where the JAX package runs the step under ``lax.scan`` (and
``jax.checkpoint`` for ``remat``), this is a Python loop (and
``torch.utils.checkpoint``). Beam-search generation lives in
layers/beam.py.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.data_type import InputType, SeqType
from paddle_tpu_torch.core.registry import (ApplyContext, LayerMeta,
                                            LayerOutput, _auto_name,
                                            make_layer, register_layer)
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import sequence_ops as seq_ops


class StaticInput:
    """A per-sample value visible at every step; ``is_seq`` keeps a whole
    sequence (an attention source) as it is."""

    def __init__(self, input: LayerOutput, is_seq: bool = False, size=None):
        self.input = input
        self.is_seq = is_seq


class SubsequenceInput:
    """A nested in-link: the group walks the SUBSEQUENCES of its input,
    and at outer step t the step receives the t-th subsequence of each
    sample as a level-1 sequence. ``max_segments`` / ``max_sub_len``
    bound the dense per-subsequence view (default: the input's max_len,
    always safe)."""

    def __init__(self, input: LayerOutput, max_segments: Optional[int] = None,
                 max_sub_len: Optional[int] = None):
        self.input = input
        self.max_segments = max_segments
        self.max_sub_len = max_sub_len


class GeneratedInput:
    """Generation-mode input of beam_search: the step consumes its own
    previous prediction."""

    def __init__(self, size: int, embedding_name: str, embedding_size: int,
                 bos_id: int = 0, eos_id: int = 1):
        self.size = size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size
        self.bos_id = bos_id
        self.eos_id = eos_id


class _GroupBuildCtx(threading.local):
    def __init__(self):
        self.stack: List[Dict[str, Any]] = []


_build_ctx = _GroupBuildCtx()


def memory(name: str, size: int, boot_layer: Optional[LayerOutput] = None,
           boot_with_const_id: Optional[int] = None, is_seq: bool = False,
           **kw) -> LayerOutput:
    """Inside a recurrent_group step: the value the layer called ``name``
    produced at the previous timestep (zeros, the boot layer's value, or
    ``boot_with_const_id`` at t = 0)."""
    assert _build_ctx.stack, "memory() must be called inside recurrent_group"
    group = _build_ctx.stack[-1]
    feed_name = f"@mem@{group['name']}@{name}@{len(group['memories'])}"
    node = make_layer(
        "data", feed_name, [],
        input_type=InputType(size, "integer" if boot_with_const_id is not None
                             else "dense"))
    group["memories"].append({
        "feed_name": feed_name,
        "link_name": name,
        "size": size,
        "boot_const_id": boot_with_const_id,
        "has_boot_layer": boot_layer is not None,
    })
    if boot_layer is not None:
        group["boot_layers"].append(boot_layer)
    return node


def _static_placeholders(gname: str, static_inputs) -> List[LayerOutput]:
    """``@static@{group}@{i}`` data layers; a sequence static keeps its
    level in the InputType so it survives the sub-topology's JSON."""
    phs = []
    for i, si in enumerate(static_inputs):
        kind = "integer" if si.input.meta.is_integer else "dense"
        seq_t = SeqType(si.input.meta.seq_level if si.is_seq else 0)
        phs.append(make_layer("data", f"@static@{gname}@{i}", [],
                              input_type=InputType(si.input.meta.size, kind,
                                                   seq_t)))
    return phs


def _run_step(step, group, args):
    _build_ctx.stack.append(group)
    try:
        return step(*args)
    finally:
        _build_ctx.stack.pop()


def recurrent_group(step, input, reverse: bool = False,
                    name: Optional[str] = None, remat: bool = False,
                    **kw) -> LayerOutput:
    """Run ``step`` over every timestep of the input sequence(s).

    input: sequence LayerOutput(s), StaticInput(s), or SubsequenceInput(s)
    (a nested group). Returns the sequence of the step's first output;
    get_output selects the others. remat=True recomputes each step's
    interior in the backward pass (torch.utils.checkpoint): only the
    memories are kept per step, the gradients are the same."""
    from paddle_tpu_torch.core.topology import Topology

    gname = name or _auto_name("recurrent_group")
    inputs = input if isinstance(input, (list, tuple)) else [input]
    sub_inputs = [i for i in inputs if isinstance(i, SubsequenceInput)]
    seq_inputs = [i for i in inputs if isinstance(i, LayerOutput)]
    static_inputs = [i for i in inputs if isinstance(i, StaticInput)]
    nested = bool(sub_inputs)
    if nested:
        assert not seq_inputs, \
            "recurrent_group: mix of SubsequenceInput and plain sequence " \
            "in-links is not supported — wrap all of them"
        bounds = {(s.max_segments, s.max_sub_len) for s in sub_inputs}
        assert len(bounds) == 1, \
            "recurrent_group: every SubsequenceInput must carry the same " \
            f"max_segments/max_sub_len bounds, got {sorted(bounds)}"
        seq_inputs = [s.input for s in sub_inputs]
    assert seq_inputs, "recurrent_group needs at least one sequence input"

    # step placeholders: a plain group peels one sequence level off; a
    # nested group hands the step a level-1 subsequence per outer step
    group = {"name": gname, "memories": [], "boot_layers": []}
    placeholders = [
        make_layer("data", f"@in@{gname}@{i}", [],
                   input_type=InputType(
                       si.meta.size,
                       "integer" if si.meta.is_integer else "dense",
                       SeqType(1) if nested else SeqType(0)))
        for i, si in enumerate(seq_inputs)]
    static_phs = _static_placeholders(gname, static_inputs)
    out = _run_step(step, group, placeholders + static_phs)
    step_outputs = out if isinstance(out, (list, tuple)) else [out]

    # the sub-topology: the step's outputs and every memory's linked layer
    probe = Topology(list(step_outputs))
    extra = []
    for mem in group["memories"]:
        if mem["link_name"] not in probe.by_name:
            raise ValueError(
                f"recurrent_group {gname}: memory links to layer "
                f"{mem['link_name']!r} but the step graph doesn't define it")
        extra.append(probe.by_name[mem["link_name"]])
    sub_topo = Topology(step_outputs, extra_outputs=extra)

    outer_inputs = seq_inputs + [s.input for s in static_inputs] + \
        group["boot_layers"]
    group_kw = {"remat": True} if remat else {}
    node = make_layer(
        "recurrent_group", gname, outer_inputs,
        **group_kw,
        n_seq=len(seq_inputs), n_static=len(static_inputs),
        reverse=reverse,
        nested=nested,
        max_segments=(sub_inputs[0].max_segments if nested else None),
        max_sub_len=(sub_inputs[0].max_sub_len if nested else None),
        memories=group["memories"],
        step_in_names=[p.name for p in placeholders],
        static_names=[p.name for p in static_phs],
        static_is_seq=[s.is_seq for s in static_inputs],
        out_name=step_outputs[0].name,
        out_names=[o.name for o in step_outputs],
        sub_topology=sub_topo.serialize(),
        _obj_sub_topo=sub_topo,
    )
    return node


def sub_topology(cfg):
    """The group's step Topology: the one captured at build time, or
    rebuilt from the ``sub_topology`` JSON (a deserialized graph)."""
    from paddle_tpu_torch.core.topology import Topology
    if cfg.get("_obj_sub_topo") is None:
        cfg["_obj_sub_topo"] = Topology.deserialize(cfg["sub_topology"])
    return cfg["_obj_sub_topo"]


def init_memories(cfg, boots, b: int, device, repeat: int = 1):
    """The memories at t = 0: the boot layer's value, ``boot_const_id``
    ints, or float32 zeros; each row repeated ``repeat`` times (beams)."""
    mems = []
    boot_i = 0
    for m in cfg["memories"]:
        if m["has_boot_layer"]:
            bv = boots[boot_i]
            boot_i += 1
            v = bv.data if isinstance(bv, SequenceBatch) else bv
            mems.append(v.repeat_interleave(repeat, dim=0) if repeat > 1
                        else v)
        elif m["boot_const_id"] is not None:
            mems.append(torch.full((b * repeat,), m["boot_const_id"],
                                   dtype=torch.int32, device=device))
        else:
            mems.append(torch.zeros((b * repeat, m["size"]),
                                    dtype=torch.float32, device=device))
    return mems


def _valid(valid: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return valid.reshape((-1,) + (1,) * (like.dim() - 1))


def _record_outputs(ctx, name, out_names, results):
    """Non-primary step outputs are read by get_output off the context."""
    aux = getattr(ctx, "aux_outputs", None)
    if aux is None:
        aux = ctx.aux_outputs = {}
    for on, val in zip(out_names, results):
        aux[(name, on)] = val


@register_layer("recurrent_group")
class RecurrentGroupLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        sub = sub_topology(cfg)
        out_meta = sub.by_name[cfg["out_name"]].meta
        out_level = (out_meta.seq_level + 1) if cfg.get("nested") else 1
        meta = LayerMeta(size=out_meta.size, seq_level=out_level,
                         is_integer=out_meta.is_integer)
        return meta, list(sub.param_specs.values()), []

    @staticmethod
    def apply(ctx: ApplyContext, name, cfg, params, inputs):
        if cfg.get("nested"):
            return _apply_nested_group(ctx, name, cfg, params, inputs)
        sub = sub_topology(cfg)
        n_seq, n_static = cfg["n_seq"], cfg["n_static"]
        seqs: List[SequenceBatch] = list(inputs[:n_seq])
        statics = list(inputs[n_seq:n_seq + n_static])
        boots = list(inputs[n_seq + n_static:])
        lengths = seqs[0].lengths
        T, b = seqs[0].max_len, seqs[0].batch_size
        reverse = cfg.get("reverse", False)
        dev = lengths.device
        mems = init_memories(cfg, boots, b, dev)

        rev_idx = None
        if reverse:
            # each row walks its own positions len-1 ... 0
            t = torch.arange(T, device=dev)
            rev_idx = torch.clamp(lengths.long()[:, None] - 1 - t[None, :],
                                  0, T - 1)
        xs = [seq_ops.take_time(s.data, rev_idx) if reverse else s.data
              for s in seqs]
        static_feed = dict(zip(cfg["static_names"], statics))
        mem_names = [m["feed_name"] for m in cfg["memories"]]
        link_names = [m["link_name"] for m in cfg["memories"]]
        out_names = cfg.get("out_names") or [cfg["out_name"]]
        # one seed for every step: a random layer in the step draws the
        # same mask at each timestep, as the JAX package's scan does
        step_seed = ctx.seed_for(f"{name}@{0}")
        n_mem = len(mems)

        def body(valid, *state):
            carry, x_t = state[:n_mem], state[n_mem:]
            feed = dict(static_feed)
            feed.update(zip(cfg["step_in_names"], x_t))
            feed.update(zip(mem_names, carry))
            outs, _ = sub.forward(params, {}, feed, mode=ctx.mode,
                                  rng=step_seed,
                                  output_names=list(out_names) + link_names,
                                  n_real=ctx.n_real)
            new = []
            for ln, old in zip(link_names, carry):
                nv = outs[ln].data if isinstance(outs[ln], SequenceBatch) \
                    else outs[ln]
                new.append(torch.where(_valid(valid, nv), nv, old))
            for on in out_names:
                ot = outs[on]
                ot = ot.data if isinstance(ot, SequenceBatch) else ot
                new.append(torch.where(_valid(valid, ot), ot,
                                       torch.zeros_like(ot)))
            return tuple(new)

        steps = []
        for t in range(T):
            valid = t < lengths
            args = (valid, *mems, *[x[:, t] for x in xs])
            res = checkpoint(body, *args, use_reentrant=False) \
                if cfg.get("remat") else body(*args)
            mems = list(res[:n_mem])
            steps.append(res[n_mem:])

        results = []
        for j in range(len(out_names)):
            outs = torch.stack([s[j] for s in steps], dim=1)   # [b, T, ...]
            if reverse:
                outs = seq_ops.take_time(outs, rev_idx)
                m = torch.arange(T, device=dev)[None, :] < \
                    lengths.long()[:, None]
                outs = torch.where(m.reshape(m.shape + (1,) * (
                    outs.dim() - 2)), outs, torch.zeros_like(outs))
            results.append(SequenceBatch(outs, lengths))
        _record_outputs(ctx, name, out_names, results)
        return results[0]


def _apply_nested_group(ctx: ApplyContext, name, cfg, params, inputs):
    """Level-2 unroll: an outer loop over subsequences; each outer step
    runs the sub-topology on a level-1 SequenceBatch view of the t-th
    subsequence of every row (one nested_to_padded scatter up front)."""
    sub = sub_topology(cfg)
    n_seq, n_static = cfg["n_seq"], cfg["n_static"]
    seqs: List[SequenceBatch] = list(inputs[:n_seq])
    statics = list(inputs[n_seq:n_seq + n_static])
    boots = list(inputs[n_seq + n_static:])
    ref = seqs[0]
    assert ref.is_nested, \
        f"recurrent_group {name}: SubsequenceInput needs a nested sequence"
    b, T = ref.batch_size, ref.max_len
    S = int(cfg.get("max_segments") or T)
    Lm = int(cfg.get("max_sub_len") or T)
    n_seg = ref.num_segments
    reverse = cfg.get("reverse", False)
    dev = n_seg.device
    s_ar = torch.arange(S, device=dev)[None, :]

    def rev_segments(data, ilen):
        """Per-row flip of the segment axis: step i sees segment
        n_seg-1-i, the backward walk over subsequences."""
        idx = torch.clamp(n_seg.long()[:, None] - 1 - s_ar, 0, S - 1)
        d = seq_ops.take_time(data, idx)
        keep = s_ar < n_seg.long()[:, None]
        return (torch.where(keep.reshape(keep.shape + (1,) * (d.dim() - 2)),
                            d, torch.zeros_like(d)),
                torch.where(keep, torch.gather(ilen, 1, idx), 0))

    views = [seq_ops.nested_to_padded(s, S, Lm) for s in seqs]
    if reverse:
        views = [rev_segments(d, l) for d, l in views]
    mems = init_memories(cfg, boots, b, dev)
    static_feed = dict(zip(cfg["static_names"], statics))
    mem_names = [m["feed_name"] for m in cfg["memories"]]
    link_names = [m["link_name"] for m in cfg["memories"]]
    out_names = cfg.get("out_names") or [cfg["out_name"]]
    out_is_seq = {on: sub.by_name[on].meta.seq_level >= 1
                  for on in out_names}
    # one seed for every outer step, as in the flat group
    step_seed = ctx.seed_for(f"{name}@nested")
    n_mem = len(mems)

    def to_mem(v):
        return seq_ops.last_instance(v) if isinstance(v, SequenceBatch) \
            else v

    def body(valid, *state):
        carry, per_in = state[:n_mem], state[n_mem:]
        feed = dict(static_feed)
        for j, ph_name in enumerate(cfg["step_in_names"]):
            feed[ph_name] = SequenceBatch(per_in[2 * j], per_in[2 * j + 1])
        feed.update(zip(mem_names, carry))
        outs, _ = sub.forward(params, {}, feed, mode=ctx.mode,
                              rng=step_seed,
                              output_names=list(out_names) + link_names,
                              n_real=ctx.n_real)
        new = []
        for ln, old in zip(link_names, carry):
            nv = to_mem(outs[ln])
            new.append(torch.where(_valid(valid, nv), nv, old))
        for on in out_names:
            ov = outs[on]
            if isinstance(ov, SequenceBatch):
                new.append(torch.where(_valid(valid, ov.data), ov.data,
                                       torch.zeros_like(ov.data)))
                new.append(torch.where(valid, ov.lengths,
                                       torch.zeros_like(ov.lengths)))
            else:
                new.append(torch.where(_valid(valid, ov), ov,
                                       torch.zeros_like(ov)))
        return tuple(new)

    steps = []
    for s_idx in range(S):
        valid = s_idx < n_seg
        per_in = []
        for dat, ilen in views:
            per_in += [dat[:, s_idx], ilen[:, s_idx]]
        args = (valid, *mems, *per_in)
        res = checkpoint(body, *args, use_reentrant=False) \
            if cfg.get("remat") else body(*args)
        mems = list(res[:n_mem])
        steps.append(res[n_mem:])

    results = []
    k = 0
    for on in out_names:
        if out_is_seq[on]:
            data = torch.stack([s[k] for s in steps], dim=1)   # [b, S, L, d]
            ilen = torch.stack([s[k + 1] for s in steps], dim=1)
            k += 2
            if reverse:
                data, ilen = rev_segments(data, ilen)
            results.append(seq_ops.padded_to_nested(data, ilen, n_seg, T))
        else:
            out = torch.stack([s[k] for s in steps], dim=1)    # [b, S, d]
            k += 1
            if reverse:
                out, _ = rev_segments(out, torch.zeros(
                    out.shape[:2], dtype=torch.int32, device=dev))
            results.append(SequenceBatch(out, n_seg))
    _record_outputs(ctx, name, out_names, results)
    return results[0]


def beam_search(step, input, bos_id: int, eos_id: int, beam_size: int,
                max_length: int = 100, num_results_per_sample: int = 1,
                name: Optional[str] = None, **kw):
    """Generation-time beam search: a node whose value is a BeamResult
    (the best path as a SequenceBatch, plus num_results_per_sample paths
    with their scores). Built by layers/beam.py."""
    from paddle_tpu_torch.layers.beam import build_beam_search
    return build_beam_search(step, input, bos_id=bos_id, eos_id=eos_id,
                             beam_size=beam_size, max_length=max_length,
                             num_results_per_sample=num_results_per_sample,
                             name=name)


@register_layer("get_output")
class GetOutputLayer:
    """Select a non-default output of a recurrent_group whose step
    returned several layers."""

    @staticmethod
    def build(name, cfg, input_metas):
        return LayerMeta(size=cfg["size"], seq_level=1,
                         is_integer=cfg.get("is_integer", False)), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        aux = getattr(ctx, "aux_outputs", {})
        key = (cfg["group_name"], cfg["arg_name"])
        if key not in aux:
            raise KeyError(
                f"get_output: group {cfg['group_name']!r} produced no "
                f"output {cfg['arg_name']!r} this pass")
        return aux[key]


def get_output(input: LayerOutput, arg_name: str, name=None,
               **kw) -> LayerOutput:
    """Step output ``arg_name`` of a multi-output recurrent_group."""
    if arg_name == input.config.get("out_name"):
        return input                          # the primary output
    sub = input.config.get("_obj_sub_topo")
    assert sub is not None and arg_name in sub.by_name, \
        f"get_output: {arg_name!r} is not an output of {input.name!r}"
    assert arg_name in (input.config.get("out_names") or ()), \
        f"get_output: step did not RETURN {arg_name!r}; return it from " \
        "the step function to expose it"
    m = sub.by_name[arg_name].meta
    return make_layer("get_output", name, [input], arg_name=arg_name,
                      group_name=input.name, size=m.size,
                      is_integer=m.is_integer)
