"""Beam-search generation and the beam cross entropy — the port of
``paddle_tpu/layers/beam.py``.

The beam is a fixed width kept as dense [batch, beam] tensors; each
step runs the step sub-topology eagerly on all batch x beam rows, takes
the top beam_size of the (beam x vocab) scores and gathers every memory
and the token history by the surviving beams. A finished beam continues
only with EOS at score 0 (an additive -1e9 mask on every other token).
The search runs all ``max_length`` steps, as the JAX package's scan
does. Ties between equal scores go to the lower flat index, the order of
``lax.top_k``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from paddle_tpu_torch.core.data_type import InputType
from paddle_tpu_torch.core.registry import (LayerMeta, LayerOutput,
                                            _auto_name, make_layer,
                                            register_layer)
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers import group as group_mod
from paddle_tpu_torch.layers.seq_layers import topk_desc

_NEG = -1e9


class BeamResult(SequenceBatch):
    """Beam-search output: the best path as a SequenceBatch (data /
    lengths, so downstream layers see a normal sequence) plus all
    num_results_per_sample paths with their scores:

      all_data:    [b, N, L] token ids per returned path
      all_lengths: [b, N]    valid lengths (the EOS position included)
      scores:      [b, N]    accumulated log-probabilities, best first
    """

    def __init__(self, data, lengths, all_data, all_lengths, scores):
        super().__init__(data, lengths)
        self.all_data = all_data
        self.all_lengths = all_lengths
        self.scores = scores

    def to_list(self):
        """[[(score, [ids...]), ...] per sample], best path first."""
        ad = self.all_data.detach().cpu().numpy()
        al = self.all_lengths.detach().cpu().numpy()
        sc = self.scores.detach().cpu().numpy()
        out = []
        for b in range(ad.shape[0]):
            out.append([(float(sc[b, n]),
                         [int(v) for v in ad[b, n, : al[b, n]]])
                        for n in range(ad.shape[1])])
        return out


def build_beam_search(step, input, *, bos_id: int, eos_id: int,
                      beam_size: int, max_length: int,
                      num_results_per_sample: int = 1,
                      name: Optional[str] = None) -> LayerOutput:
    from paddle_tpu_torch.core.topology import Topology

    gname = name or _auto_name("beam_search")
    inputs = input if isinstance(input, (list, tuple)) else [input]
    gen_inputs = [i for i in inputs
                  if isinstance(i, group_mod.GeneratedInput)]
    static_inputs = [i for i in inputs
                     if isinstance(i, group_mod.StaticInput)]
    assert len(gen_inputs) == 1, "beam_search needs exactly one GeneratedInput"
    gen = gen_inputs[0]

    group = {"name": gname, "memories": [], "boot_layers": []}
    # the previous generated token (integer ids)
    tok_ph = make_layer("data", f"@gen@{gname}", [],
                        input_type=InputType(gen.size, "integer"))
    static_phs = group_mod._static_placeholders(gname, static_inputs)
    out = group_mod._run_step(step, group, [tok_ph] + static_phs)
    assert isinstance(out, LayerOutput), "beam_search step must return probs"

    probe = Topology([out])
    extra = [probe.by_name[mem["link_name"]] for mem in group["memories"]]
    sub_topo = Topology([out], extra_outputs=extra)

    outer_inputs = [s.input for s in static_inputs] + group["boot_layers"]
    return make_layer(
        "beam_search", gname, outer_inputs,
        n_static=len(static_inputs),
        memories=group["memories"],
        tok_name=tok_ph.name,
        static_names=[p.name for p in static_phs],
        static_is_seq=[s.is_seq for s in static_inputs],
        out_name=out.name,
        vocab=out.meta.size,
        bos_id=bos_id, eos_id=eos_id, beam_size=beam_size,
        max_length=max_length,
        num_results_per_sample=min(num_results_per_sample, beam_size),
        sub_topology=sub_topo.serialize(),
        _obj_sub_topo=sub_topo,
    )


def _tile_beam(x, K: int):
    """[b, ...] -> [b*K, ...], each row repeated K times in place."""
    if isinstance(x, SequenceBatch):
        return SequenceBatch(
            _tile_beam(x.data, K), _tile_beam(x.lengths, K),
            None if x.segment_ids is None else _tile_beam(x.segment_ids, K),
            None if x.num_segments is None else _tile_beam(x.num_segments, K))
    return x.repeat_interleave(K, dim=0)


@register_layer("beam_search")
class BeamSearchLayer:
    @staticmethod
    def build(name, cfg, input_metas):
        sub = group_mod.sub_topology(cfg)
        return LayerMeta(size=1, seq_level=1, is_integer=True), \
            list(sub.param_specs.values()), []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        sub = group_mod.sub_topology(cfg)
        K, V, L = cfg["beam_size"], cfg["vocab"], cfg["max_length"]
        eos = cfg["eos_id"]
        n_static = cfg["n_static"]
        statics = list(inputs[:n_static])
        boots = list(inputs[n_static:])
        # the batch size from the first static or boot input, else 1
        if statics:
            s0 = statics[0]
            b = s0.batch_size if isinstance(s0, SequenceBatch) \
                else s0.shape[0]
            dev = (s0.data if isinstance(s0, SequenceBatch) else s0).device
        elif boots:
            b, dev = boots[0].shape[0], boots[0].device
        else:
            b, dev = 1, next(iter(params.values())).device
        static_feed = {sname: _tile_beam(sv, K) for sname, sv in
                       zip(cfg["static_names"], statics)}
        mems = group_mod.init_memories(cfg, boots, b, dev, repeat=K)
        mem_names = [m["feed_name"] for m in cfg["memories"]]
        link_names = [m["link_name"] for m in cfg["memories"]]
        out_name = cfg["out_name"]

        tokens = torch.full((b, K), cfg["bos_id"], dtype=torch.int32,
                            device=dev)
        # only beam 0 is live at t = 0, so duplicates don't fill the beam
        scores = torch.where(torch.arange(K, device=dev)[None, :] == 0,
                             0.0, _NEG).float().expand(b, K)
        finished = torch.zeros((b, K), dtype=torch.bool, device=dev)
        eos_only = torch.full((V,), _NEG, device=dev)
        eos_only[eos] = 0.0
        hist = torch.zeros((b, K, L), dtype=torch.int32, device=dev)
        rows = torch.arange(b, device=dev)[:, None]
        for t in range(L):
            feed = dict(static_feed)
            feed[cfg["tok_name"]] = tokens.reshape(b * K)
            feed.update(zip(mem_names, mems))
            outs, _ = sub.forward(params, {}, feed, mode="test",
                                  output_names=[out_name] + link_names)
            probs = outs[out_name]
            probs = probs.data if isinstance(probs, SequenceBatch) else probs
            logp = torch.log(torch.clamp(probs.float(), min=1e-12)) \
                .reshape(b, K, V)
            # finished beams: only EOS, with zero added score
            logp = torch.where(finished[..., None], eos_only, logp)
            total = (scores[..., None] + logp).reshape(b, K * V)
            scores, idx = topk_desc(total, K)                    # [b, K]
            beam_idx = torch.div(idx, V, rounding_mode="floor")
            tokens = (idx % V).to(torch.int32)
            finished = finished[rows, beam_idx] | (tokens == eos)

            def reindex(mv):
                return mv.reshape((b, K) + mv.shape[1:])[rows, beam_idx] \
                    .reshape((b * K,) + mv.shape[1:])

            mems = [reindex(outs[ln].data if isinstance(outs[ln],
                                                        SequenceBatch)
                            else outs[ln]) for ln in link_names]
            hist = hist[rows, beam_idx]
            hist[:, :, t] = tokens

        # rank the beams of each sample; keep num_results_per_sample paths
        N = cfg.get("num_results_per_sample", 1)
        top_scores, order = topk_desc(scores, N)                 # [b, N]
        top_seqs = hist[rows, order]                             # [b, N, L]
        is_eos = top_seqs == eos
        first_eos = torch.argmax(is_eos.to(torch.int32), dim=2)
        top_lens = torch.where(is_eos.any(dim=2), first_eos + 1, L) \
            .to(torch.int32)
        return BeamResult(top_seqs[:, 0, :], top_lens[:, 0], top_seqs,
                          top_lens, top_scores)


# ---------------------------------------------------------------------------
# cross_entropy_over_beam — the learning-to-search cost


def _take(x: torch.Tensor, idx) -> torch.Tensor:
    """``jnp.take``'s default indexing: an index in [-n, n) reads x (a
    negative one from the end); any other reads the fill, NaN for float
    x and the int32 minimum for integer x."""
    n = x.shape[0]
    idx = torch.as_tensor(idx, device=x.device).long()
    ok = (idx >= -n) & (idx < n)
    v = x[torch.where(ok, torch.remainder(idx, max(n, 1)), 0)]
    fill = float("nan") if x.is_floating_point() else -2 ** 31
    return torch.where(ok, v, torch.full_like(v, fill))


def _beam_cost_one_sequence(scores: List[torch.Tensor],
                            starts: List[torch.Tensor],
                            ids: List[torch.Tensor],
                            gold: List[torch.Tensor]) -> torch.Tensor:
    """The cost of one sample over E beam expansions.

    scores[e]: [S_e] flat candidate scores of expansion e
    starts[e]: [R_e] start offset of each beam row inside scores[e]
    ids[e]:    [R_e, K_e] selected candidate ids per row, -1 padded
    gold[e]:   the gold candidate id within the gold row

    Tracks the gold row through the expansions, rebuilds every surviving
    path at the last expansion the gold survived (or fell off at), walks
    the parents back, and takes the softmax over all path scores with
    the gold appended as a path of its own when it fell off the beam.
    """
    E = len(ids)
    dev = scores[0].device
    gold_rows, gold_cols = [], []
    grow = torch.zeros((), dtype=torch.long, device=dev)
    for e in range(E):
        ide = ids[e].long()
        K = ide.shape[1]
        hit = ide[torch.clamp(grow, 0, ide.shape[0] - 1)] == gold[e]
        col = torch.where(hit.any(), torch.argmax(hit.to(torch.int32)), -1)
        gold_rows.append(grow)
        gold_cols.append(col)
        if e + 1 < E:
            # the next expansion's gold row: the selected candidates
            # (not -1) before the gold's flat slot in this one
            off = grow * K + torch.clamp(col, min=0)
            flat = ide.reshape(-1)
            before = torch.arange(flat.shape[0], device=dev) < off
            grow = ((flat != -1) & before).sum()
    # the last valid expansion: where the gold first fell off, else E-1
    missed = [e for e in range(E) if int(gold_cols[e]) == -1]
    l = missed[0] if missed else E - 1

    ide = ids[l].long()
    R, K = ide.shape
    flat = ide.reshape(-1)
    valid = flat != -1
    cnt = torch.cumsum(valid.long(), 0) - valid.long()          # exclusive
    n_paths = valid.sum()
    P = R * K + 1                                               # + gold slot
    path_flat = torch.zeros(P, dtype=torch.long, device=dev)
    path_flat[cnt[valid]] = torch.arange(R * K, device=dev)[valid]
    parent = torch.div(path_flat, K, rounding_mode="floor")
    st_l = starts[l].long()
    row_id = _take(flat, path_flat) + _take(st_l, parent)
    extra = gold_cols[l] == -1
    gold_slot = torch.where(extra, n_paths, _take(
        cnt, gold_rows[l] * K + torch.clamp(gold_cols[l], min=0)))
    slots = torch.arange(P, device=dev)
    is_gold_extra = extra & (slots == gold_slot)
    row_id = torch.where(is_gold_extra,
                         gold[l] + _take(st_l, gold_rows[l]), row_id)
    parent = torch.where(is_gold_extra, gold_rows[l], parent)
    total = scores[l][torch.clamp(row_id, 0, scores[l].shape[0] - 1)]
    for b in range(l - 1, -1, -1):
        idb = ids[b].long().reshape(-1)
        Kb = ids[b].shape[1]
        st_b = starts[b].long()
        # row r of expansion b+1 is the flat candidate slot r of b
        pidx = torch.clamp(parent, 0, idb.shape[0] - 1)
        prow = torch.div(pidx, Kb, rounding_mode="floor")
        rid = idb[pidx] + st_b[prow]
        rid = torch.where(is_gold_extra,
                          gold[b] + _take(st_b, gold_rows[b]), rid)
        parent = torch.where(is_gold_extra, gold_rows[b], prow)
        total = total + scores[b][torch.clamp(rid, 0, scores[b].shape[0] - 1)]
    live = slots < (n_paths + extra.long())
    logits = torch.where(live, total, torch.full_like(total, _NEG))
    return torch.logsumexp(logits, 0) - _take(logits, gold_slot)


def _segment_starts(seg_ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """First position of each segment id 0..n_rows-1 in [S] ids."""
    eq = seg_ids.long()[None, :] == torch.arange(
        n_rows, device=seg_ids.device)[:, None]
    return torch.argmax(eq.to(torch.int32), dim=1)


@register_layer("cross_entropy_over_beam")
class CrossEntropyOverBeamLayer:
    """Cross entropy over all candidate paths of a multi-step beam
    search. Inputs come in triples per expansion: candidate scores (a
    sequence or nested sequence of scalars), the selected candidate ids
    (a kmax_seq_score output), and the gold id. One sample at a time:
    which expansion is the last one depends on the data."""

    @staticmethod
    def build(name, cfg, input_metas):
        assert len(input_metas) % 3 == 0, \
            "cross_entropy_over_beam takes triples of inputs"
        cfg["n_beams"] = len(input_metas) // 3
        return LayerMeta(size=1), [], []

    @staticmethod
    def apply(ctx, name, cfg, params, inputs):
        per = []
        for e in range(cfg["n_beams"]):
            sc, sel, gd = inputs[3 * e: 3 * e + 3]
            assert isinstance(sc, SequenceBatch), \
                "candidate_scores must be a sequence"
            b = sc.batch_size
            sel_d = sel.data if isinstance(sel, SequenceBatch) else sel
            if sel_d.dim() == 2:
                sel_d = sel_d[:, None, :]                       # [b, 1, K]
            R = sel_d.shape[1]
            gd_d = gd.data if isinstance(gd, SequenceBatch) else gd
            per.append((sc.data.reshape(b, sc.max_len),
                        sc.segment_ids if sc.is_nested else None, R,
                        sel_d, gd_d.reshape(b).long()))
        costs = []
        for i in range(per[0][0].shape[0]):
            costs.append(_beam_cost_one_sequence(
                [s[i] for s, _, _, _, _ in per],
                [_segment_starts(seg[i], R) if seg is not None else
                 torch.zeros(R, dtype=torch.long, device=s.device)
                 for s, seg, R, _, _ in per],
                [sel[i] for _, _, _, sel, _ in per],
                [g[i] for _, _, _, _, g in per]))
        return torch.stack(costs)


class BeamInput:
    """One beam expansion triple for cross_entropy_over_beam."""

    def __init__(self, candidate_scores, selected_candidates, gold):
        self.candidate_scores = candidate_scores
        self.selected_candidates = selected_candidates
        self.gold = gold


def cross_entropy_over_beam(input, name=None, **kw) -> LayerOutput:
    beams = input if isinstance(input, (list, tuple)) else [input]
    nodes = []
    for bi in beams:
        nodes += [bi.candidate_scores, bi.selected_candidates, bi.gold]
    return make_layer("cross_entropy_over_beam", name, nodes)
