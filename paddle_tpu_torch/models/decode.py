"""Incremental (KV-cache) decoding for the transformer LM — the port of
``paddle_tpu/models/decode.py``.

``TransformerDecoder`` reimplements ``transformer_lm``'s forward over
the SAME parameter table (names, ``[in, out]`` layouts, dtype — see
params.py), with a dense per-batch KV cache: the reference decoder the
paged path is held against. ``PagedDecoder`` is the serving step: K/V
live in a shared preallocated pool of fixed-size pages
``[L, n_pages, page_size, g, dh]``, each slot of a fixed slot batch
owns a page-table row, and attention reads the pool through
``ops/paged_decode.paged_window_attention`` — the hand-written Hopper
kernel on the card, the plain gather/einsum version on the CPU.

Numerics follow the reference: the same layer norm formula, the same
grouped-query einsum strings and ``-1e30`` mask, and a shared ``_ffn``
so the dense and paged paths cannot drift. PyTorch runs eagerly, so
there is no jit and no per-shape compile; pools are updated IN PLACE
(the counterpart of the reference's buffer donation) and ``step``
returns the same pool tensors it was given.

``PagedDecoder(kv_quant="int8")`` keeps the two-tier int8 pools
(``{"q": int8, "s": float32 scales}``, read by the dequant path of the
window kernel on the card); ``read_page`` / ``write_page`` are the
host spill tier's device legs. ``DraftDecoder`` is the speculative
draft over slot-private dense caches.

MoE blocks are found in the parameter table and route through
``ops/moe.moe_ffn`` in the shared ``_ffn``, so the paged engine serves
an MoE table too. A prefill of 256 or more tokens on the card, with
``use_flash_attention`` on, runs its attention through the flash
forward kernel (``ops/flash_attention.py``) instead of the quadratic
einsum. ``beam_search`` is an eager loop over steps: raw summed
log-probabilities, or GNMT length-penalized scores with finished
hypotheses banked.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.config import global_config
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.layers.seq_layers import topk_desc
from paddle_tpu_torch.ops import flash_attention as flash
from paddle_tpu_torch.ops import moe as moe_ops
from paddle_tpu_torch.ops import paged_decode as paged_ops
from paddle_tpu_torch.params import params_from_numpy

_NEG_INF = -1e30


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
        eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * g + b).to(x.dtype)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (h, x.shape[-1] // h))


def tokens_agree(got: Sequence[int], want: Sequence[int],
                 ref_logits: np.ndarray, tol: float) -> bool:
    """Greedy token identity under the tie rule: ``got`` must equal
    ``want`` token for token, except that at the FIRST mismatch the
    run still agrees when ``got``'s token scored within ``tol`` of the
    reference's best logit there (a near-tie that rounding between two
    correct implementations may break either way; past it the
    sequences legitimately diverge). ``ref_logits[j]`` is the
    reference's logit row that produced ``want[j]``."""
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            row = np.asarray(ref_logits[j], np.float64)
            return bool(row[a] >= row.max() - tol)
    return len(got) == len(want)


class TransformerDecoder:
    """Greedy / temperature sampling with per-layer dense KV caches.

    params: the parameter table (numpy arrays or tensors) — the JAX
    package's ``Topology.init_params`` output or a checkpoint tar read
    by ``params.load_params_tar``. Config args mirror transformer_lm.
    ``device`` None is the CUDA card (and an error without one).

    MoE blocks are found in the table (E from the gate's shape), but k
    is not: ``moe_k`` must match the training config. With
    ``moe_capacity_factor`` None routing is drop-free (the capacity is
    each call's token count), so decoding follows the training forward
    wherever training dropped nothing; a float reproduces a training
    capacity limit."""

    def __init__(self, params: Mapping, *, n_layers: int, n_heads: int,
                 name: str = "tfm", moe_k: int = 2,
                 moe_capacity_factor: Optional[float] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        prefix = f"_{name}"
        own = {k: v for k, v in params.items() if k.startswith(prefix)}
        self.moe_k = int(moe_k)
        self.moe_capacity_factor = moe_capacity_factor
        self.p: Dict[str, torch.Tensor] = {
            k: v.to(self.device) for k, v in own.items()
            if isinstance(v, torch.Tensor)}
        self.p.update(params_from_numpy(
            {k: np.asarray(v) for k, v in own.items()
             if not isinstance(v, torch.Tensor)}, self.device))
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.name = name
        n = name
        self.d_model = self.p[f"_{n}_tok_emb.w0"].shape[1]
        self.head_dim = self.d_model // self.n_heads
        self.kv_heads = self.p[f"_{n}_l0_k.w0"].shape[1] // self.head_dim
        self.dtype = self.p[f"_{n}_tok_emb.w0"].dtype

    # ---------------------------------------------------------------- core
    @staticmethod
    def _use_flash_prefill(t: int, pos: int, q: torch.Tensor) -> bool:
        """The flash-prefill gate: q [b, t, h, dh] on a CUDA card with
        ``use_flash_attention`` on and a shape the kernels take, a
        prompt of at least 256 tokens, and the cache empty before this
        call (``pos == 0``)."""
        return (q.device.type == "cuda"
                and global_config().use_flash_attention
                and flash.flash_supported(q, q) and t >= 256 and pos == 0)

    def _embed(self, ids: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        n = self.name
        return self.p[f"_{n}_tok_emb.w0"][ids] + \
            self.p[f"_{n}_pos_emb.w0"][pos]

    def _block(self, i: int, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, pos: int, kv_len: int) -> torch.Tensor:
        """One decoder block over a [b, t, d] slice; writes the
        [b, T, g, dh] caches IN PLACE at positions [pos, pos+t) and
        attends over positions < kv_len, causally."""
        p, n, h = self.p, self.name, self.n_heads
        ln1 = _ln(x, p[f"_{n}_l{i}_ln1.w0"], p[f"_{n}_l{i}_ln1.wbias"])
        q = _heads(ln1 @ p[f"_{n}_l{i}_q.w0"], h)
        dh = q.shape[-1]
        kv_h = k_cache.shape[2]
        k = _heads(ln1 @ p[f"_{n}_l{i}_k.w0"], kv_h)
        v = _heads(ln1 @ p[f"_{n}_l{i}_v.w0"], kv_h)
        t = x.shape[1]
        k_cache[:, pos:pos + t] = k.to(k_cache.dtype)
        v_cache[:, pos:pos + t] = v.to(v_cache.dtype)
        T = k_cache.shape[1]
        rep = h // kv_h
        scale = dh ** -0.5
        if self._use_flash_prefill(t, pos, q):
            # a long prompt into an empty cache: attention is causal over
            # exactly these t positions, so the flash kernel streams K/V
            # instead of the einsum's [b, g, rep, t, T] scores. GQA
            # repeats K/V once for the prefill (q head j reads kv head
            # j // rep, the einsum's grouping)
            kq = k if rep == 1 else torch.repeat_interleave(k, rep, dim=2)
            vq = v if rep == 1 else torch.repeat_interleave(v, rep, dim=2)
            lens = torch.full((x.shape[0],), min(t, kv_len),
                              dtype=torch.int32, device=x.device)
            attn = flash.flash_attention(
                q.to(x.dtype), kq.to(x.dtype), vq.to(x.dtype),
                q_lens=lens, kv_lens=lens, causal=True,
                scale=scale).reshape(x.shape)
        else:
            # grouped-query: q [b,t,(kv_h, rep),dh] against kv_h-head
            # caches — the cache is read at stored width, never repeated
            q5 = q.reshape(q.shape[0], t, kv_h, rep, dh)
            logits = torch.einsum("bqgrd,bkgd->bgrqk", q5,
                                  k_cache.to(q.dtype)) * scale
            qpos = pos + torch.arange(t, device=x.device)[:, None]
            kpos = torch.arange(T, device=x.device)[None, :]
            mask = (kpos <= qpos) & (kpos < kv_len)
            logits = torch.where(mask, logits,
                                 torch.tensor(_NEG_INF, dtype=logits.dtype,
                                              device=x.device))
            w = torch.softmax(logits, dim=-1)
            attn = torch.einsum("bgrqk,bkgd->bqgrd", w,
                                v_cache.to(q.dtype)).reshape(x.shape)
        x = x + attn @ p[f"_{n}_l{i}_proj.w0"]
        return self._ffn(i, x)

    def _ffn(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """ln2 + FFN (dense or MoE) + residual over [b, t, d] — shared
        between the dense-cache block and the paged step."""
        p, n = self.p, self.name
        ln2 = _ln(x, p[f"_{n}_l{i}_ln2.w0"], p[f"_{n}_l{i}_ln2.wbias"])
        gate = p.get(f"_{n}_l{i}_moe.gate")
        if gate is None:
            up = torch.relu(ln2 @ p[f"_{n}_l{i}_up.w0"]
                            + p[f"_{n}_l{i}_up.wbias"])
            return x + up @ p[f"_{n}_l{i}_down.w0"]
        b_, t_, d_ = ln2.shape
        cf = self.moe_capacity_factor
        cap = None
        if cf is None:
            cap = b_ * t_
            # the reference's bound on drop-free routing, whose einsum
            # path would build [n, E, C=n] dispatch tensors: past it,
            # a generous factor instead (the sort path keeps the rule)
            if cap * cap * gate.shape[-1] > (1 << 27):
                warnings.warn(
                    f"moe prefill with {cap} tokens: drop-free routing "
                    f"would need a [{cap},{gate.shape[-1]},{cap}] "
                    "dispatch tensor; falling back to capacity_factor=2.0 "
                    "(set moe_capacity_factor explicitly to choose)",
                    stacklevel=2)
                cap, cf = None, 2.0
        y2d, _ = moe_ops.moe_ffn(
            ln2.reshape(b_ * t_, d_), None, gate,
            p[f"_{n}_l{i}_moe.moe_up"], p[f"_{n}_l{i}_moe.moe_down"],
            k=self.moe_k, capacity_factor=cf if cf is not None else 1.25,
            capacity=cap, dispatch_mode="auto")
        return x + y2d.reshape(b_, t_, d_)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        p, n = self.p, self.name
        x = _ln(x, p[f"_{n}_lnf.w0"], p[f"_{n}_lnf.wbias"])
        if f"_{n}_head.w0" in p:
            logits = x @ p[f"_{n}_head.w0"]
        else:  # tie_embeddings: the head IS the token table, transposed
            logits = x @ p[f"_{n}_tok_emb.w0"].T
        if f"_{n}_head.wbias" in p:  # older checkpoints carried a bias
            logits = logits + p[f"_{n}_head.wbias"]
        return logits

    def _forward(self, ids, pos, caches, cache_pos: int, kv_len: int):
        """ids [b, t] -> logits [b, t, V]; extends ``caches`` in place."""
        x = self._embed(ids, pos)
        for i, (kc, vc) in enumerate(caches):
            x = self._block(i, x, kc, vc, cache_pos, kv_len)
        return self._logits(x)

    def _prefill(self, prompt: torch.Tensor, max_len: int):
        """Allocate the fixed-size caches and run the one batched causal
        pass over the prompt -> (logits [b, plen, V], caches)."""
        b, plen = prompt.shape
        caches = [(torch.zeros((b, max_len, self.kv_heads, self.head_dim),
                               dtype=self.dtype, device=self.device),
                   torch.zeros((b, max_len, self.kv_heads, self.head_dim),
                               dtype=self.dtype, device=self.device))
                  for _ in range(self.n_layers)]
        pos = torch.arange(plen, device=self.device)[None, :].expand(b, -1)
        return self._forward(prompt, pos, caches, 0, plen), caches

    def _validate(self, prompt: torch.Tensor, max_len: int) -> int:
        plen = int(prompt.shape[1])
        if max_len <= plen:
            raise ValueError(f"max_len {max_len} <= prompt length {plen}")
        pos_rows = self.p[f"_{self.name}_pos_emb.w0"].shape[0]
        if max_len > pos_rows:
            raise ValueError(f"max_len {max_len} exceeds the position "
                             f"table ({pos_rows} rows)")
        return plen

    def _ids(self, prompt) -> torch.Tensor:
        return torch.as_tensor(np.asarray(prompt, np.int64),
                               device=self.device)

    @torch.no_grad()
    def prefill_logits(self, ids) -> np.ndarray:
        """Teacher-forced logits [b, t, V] (float32, host) of one causal
        pass over ``ids`` [b, t] — row j is the model's distribution for
        position j + 1. Tests and the chip smoke read greedy-decode
        near-ties from it (:func:`tokens_agree`)."""
        ids = self._ids(ids)
        logits, _ = self._prefill(ids, int(ids.shape[1]))
        return logits.float().cpu().numpy()

    # ------------------------------------------------------------- generate
    @torch.no_grad()
    def generate(self, prompt, max_len: int,
                 temperature: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 eos_id: Optional[int] = None) -> List[List[int]]:
        """prompt [b, P] int -> per-row generated ids (length
        max_len - P, trimmed after eos_id when given).

        temperature None = greedy argmax; otherwise categorical at that
        temperature, drawing from ``generator`` (a ``torch.Generator``
        on this decoder's device; None uses the global one)."""
        prompt = self._ids(prompt)
        plen = self._validate(prompt, int(max_len))
        b = prompt.shape[0]

        def sample(lg):
            if temperature is None:
                return torch.argmax(lg, dim=-1)
            probs = torch.softmax(lg.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]

        logits, caches = self._prefill(prompt, int(max_len))
        tok = sample(logits[:, -1])
        toks = [tok]
        for pp in range(plen, int(max_len) - 1):
            pos = torch.full((b, 1), pp, dtype=torch.long,
                             device=self.device)
            lg = self._forward(tok[:, None], pos, caches, pp, pp + 1)
            tok = sample(lg[:, -1])
            toks.append(tok)
        out = torch.stack(toks, dim=1).cpu().numpy()
        rows = []
        for row in out:
            row = [int(t) for t in row]
            if eos_id is not None and eos_id in row:
                row = row[:row.index(eos_id) + 1]
            rows.append(row)
        return rows

    # ---------------------------------------------------------- beam search
    def _vocab(self) -> int:
        n = self.name
        head = self.p.get(f"_{n}_head.w0")
        return head.shape[1] if head is not None else \
            self.p[f"_{n}_tok_emb.w0"].shape[0]

    def _beam_prefill(self, prompt, max_len: int, K: int):
        """The prompt's last-position log-probs [b, V] (float32) and the
        caches repeated to K lanes a row ([b*K, T, g, dh])."""
        logits, caches = self._prefill(prompt, max_len)
        lp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)
        caches = [(kc.repeat_interleave(K, dim=0),
                   vc.repeat_interleave(K, dim=0)) for kc, vc in caches]
        return lp0, caches

    def _beam_step(self, tokens, caches, t: int, plen: int):
        """Feed each lane's token t-1 -> log-probs [b, K, V] (float32);
        extends ``caches`` in place."""
        b, K, _ = tokens.shape
        last = tokens[:, :, t - 1].reshape(b * K)
        pos = torch.full((b * K, 1), plen + t - 1, dtype=torch.long,
                         device=self.device)
        lg = self._forward(last[:, None], pos, caches, plen + t - 1,
                           plen + t)
        return torch.log_softmax(lg[:, -1].float(), dim=-1) \
            .reshape(b, K, -1)

    def _beam_advance(self, tokens, caches, total, t: int):
        """Keep the K best of ``total`` [b, K, V] per row: (scores,
        parent lanes, tokens with the winners' histories and token t,
        caches gathered to follow the parents — fresh tensors, so no
        later in-place cache write aliases another lane)."""
        b, K, V = total.shape
        scores, flat = topk_desc(total.reshape(b, K * V), K)
        parent = flat // V
        tokens = torch.take_along_dim(tokens, parent[:, :, None], dim=1)
        tokens[:, :, t] = flat % V
        pflat = (torch.arange(b, device=self.device)[:, None] * K
                 + parent).reshape(-1)
        caches = [(kc[pflat], vc[pflat]) for kc, vc in caches]
        return scores, parent, tokens, caches

    def _beam(self, prompt, plen: int, max_len: int, K: int, eos_id: int):
        """Raw-sum beam search: scores are summed token log-probs; a lane
        that emitted EOS freezes (only the EOS continuation, at no
        cost). -> (tokens [b, K, L], scores [b, K]), best first."""
        b = prompt.shape[0]
        V = self._vocab()
        lp0, caches = self._beam_prefill(prompt, max_len, K)
        scores, tok0 = topk_desc(lp0, K)
        tokens = torch.full((b, K, max_len - plen), eos_id,
                            dtype=torch.long, device=self.device)
        tokens[:, :, 0] = tok0
        alive = tok0 != eos_id
        frozen = torch.full((V,), _NEG_INF, device=self.device)
        frozen[eos_id] = 0.0
        for t in range(1, max_len - plen):
            lp = self._beam_step(tokens, caches, t, plen)
            lp = torch.where(alive[:, :, None], lp, frozen)
            scores, parent, tokens, caches = self._beam_advance(
                tokens, caches, scores[:, :, None] + lp, t)
            alive = torch.gather(alive, 1, parent) & \
                (tokens[:, :, t] != eos_id)
        return tokens, scores

    def _beam_gnmt(self, prompt, plen: int, max_len: int, K: int,
                   eos_id: int, alpha: float):
        """GNMT beam search: a hypothesis that emits EOS leaves the beam
        and is BANKED with raw / len^alpha, freeing its lane for live
        continuations over non-EOS tokens; at length L the live lanes
        are drained into the bank. -> (tokens [b, K, L], penalized
        scores [b, K]), best first."""
        b = prompt.shape[0]
        V = self._vocab()
        if K >= V:
            raise ValueError(f"gnmt beam needs beam_size={K} < "
                             f"vocab_size={V}")
        L = max_len - plen
        is_eos = torch.arange(V, device=self.device) == eos_id
        lp0, caches = self._beam_prefill(prompt, max_len, K)
        bank_s = torch.full((b, K), _NEG_INF, device=self.device)
        bank_t = torch.full((b, K, L), eos_id, dtype=torch.long,
                            device=self.device)
        # immediate EOS is the first banked candidate (length 1)
        bank_s[:, 0] = lp0[:, eos_id]
        scores, tok0 = topk_desc(lp0.masked_fill(is_eos, _NEG_INF), K)
        tokens = torch.full((b, K, L), eos_id, dtype=torch.long,
                            device=self.device)
        tokens[:, :, 0] = tok0

        def merge_bank(bank_s, bank_t, cand_s, cand_t):
            top_s, idx = topk_desc(torch.cat([bank_s, cand_s], dim=1), K)
            top_t = torch.take_along_dim(torch.cat([bank_t, cand_t], dim=1),
                                         idx[:, :, None], dim=1)
            return top_s, top_t

        for t in range(1, L):
            lp = self._beam_step(tokens, caches, t, plen)
            # bank each lane's EOS continuation (length t + 1)
            cand_t = tokens.clone()
            cand_t[:, :, t] = eos_id
            bank_s, bank_t = merge_bank(
                bank_s, bank_t,
                (scores + lp[:, :, eos_id]) / (t + 1.0) ** alpha, cand_t)
            total = scores[:, :, None] + lp.masked_fill(is_eos, _NEG_INF)
            scores, _, tokens, caches = self._beam_advance(
                tokens, caches, total, t)
        bank_s, bank_t = merge_bank(bank_s, bank_t,
                                    scores / float(L) ** alpha, tokens)
        return bank_t, bank_s

    @torch.no_grad()
    def beam_search(self, prompt, max_len: int, beam_size: int = 4,
                    eos_id: int = 0, num_results: Optional[int] = None,
                    length_penalty: float = 0.0):
        """prompt [b, P] -> per-sample n-best [(score, tokens), ...],
        best first; each row is trimmed after its first EOS.

        ``length_penalty`` 0 is the raw-sum search (summed token
        log-probs; finished beams freeze at their EOS). alpha > 0 is
        GNMT: hypotheses that emit EOS are banked with raw / len^alpha,
        and the returned scores are those penalized ones."""
        prompt = self._ids(prompt)
        plen = self._validate(prompt, int(max_len))
        n_keep = num_results if num_results is not None else beam_size
        if not 1 <= n_keep <= beam_size:
            raise ValueError(f"num_results={num_results} must be in "
                             f"[1, beam_size={beam_size}]")
        if length_penalty < 0.0:
            raise ValueError(f"length_penalty={length_penalty} must be "
                             ">= 0")
        if length_penalty > 0.0:
            toks, scores = self._beam_gnmt(prompt, plen, int(max_len),
                                           beam_size, eos_id,
                                           float(length_penalty))
        else:
            toks, scores = self._beam(prompt, plen, int(max_len),
                                      beam_size, eos_id)
        toks, scores = toks.cpu().numpy(), scores.cpu().numpy()
        out = []
        for bi in range(toks.shape[0]):
            rows = []
            for ki in range(toks.shape[1]):
                row = [int(x) for x in toks[bi, ki]]
                if eos_id in row:
                    row = row[:row.index(eos_id) + 1]
                rows.append((float(scores[bi, ki]), row))
            out.append(rows[:n_keep])
        return out

    def paged(self, *, num_slots: int, page_size: int, num_pages: int,
              max_pages_per_slot: int,
              temperature: Optional[float] = None, window: int = 1,
              kv_quant: Optional[str] = None,
              warm_start: bool = True) -> "PagedDecoder":
        """A fixed-shape paged-KV decode step over this decoder's
        parameter table (the serving engine's hot path)."""
        return PagedDecoder(self, num_slots=num_slots, page_size=page_size,
                            num_pages=num_pages,
                            max_pages_per_slot=max_pages_per_slot,
                            temperature=temperature, window=window,
                            kv_quant=kv_quant, warm_start=warm_start)


class PagedDecoder:
    """One slot-batched decode step over a PAGED KV cache.

    K/V live in a shared preallocated POOL of fixed-size pages
    ([L, n_pages, page_size, g, dh]); each slot of the fixed slot batch
    owns a page-table row mapping its logical positions to physical
    pages. Requests join and leave by editing the small int32 inputs
    (tokens / positions / page tables / active mask); the step's shapes
    never change. Physical page 0 is RESERVED as the null page:
    inactive slots write their (discarded) K/V there and unassigned
    page-table entries point at it, which keeps the scatter and the
    attention unconditional.

    ``window`` W tokens per slot per step: every window token's K/V is
    scattered into the pool BEFORE attention and each token's kv_len
    masks later positions, so the window is causal; output column w is
    the model's next-token choice after feeding tokens 0..w.

    ``kv_quant="int8"`` switches the pools to the two-tier int8 layout:
    each pool is ``{"q": int8 [L, N, ps, g, dh], "s": float32 [L, N,
    ps, g]}``; the scatter quantizes each K/V row per (token, kv-head)
    with ``ops/paged_decode.quantize_kv`` (a pure function of the row,
    so prefix-shared pages stay bit-identical across owners) and
    attention reads through the dequant path of the window kernel.

    On a CUDA card the window kernel must take the step's shapes
    (``paged_kernel_supported``, with the scale blocks under int8):
    construction raises ``ValueError`` for a shape it refuses. The TPU
    engine falls back to a dequantizing gather there (and journals
    ``dequant_fallback``); the port never runs the plain version on the
    card.

    Scheduling (which slot holds which request, page alloc/free,
    eviction) is host policy in serving/engine.py; this class is only
    the device step.

    ``warm_start`` (the artifact plane, paddle_tpu_torch/artifacts):
    on a CUDA card the step's kernel library resolves through the warm
    ladder — in-process cache, artifact store, then the compile cache
    or ``nvcc`` — at :meth:`load_kernels` (the engine's ``warmup()``,
    else the first step); with ``warm_start=False`` the store is not
    read and the compile cache alone serves."""

    #: the kernel libraries the step launches on a CUDA card
    KERNEL_LIBRARIES = ("paged_window_attention",)

    def __init__(self, dense: TransformerDecoder, *, num_slots: int,
                 page_size: int, num_pages: int, max_pages_per_slot: int,
                 temperature: Optional[float] = None, window: int = 1,
                 kv_quant: Optional[str] = None, warm_start: bool = True):
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', got "
                             f"{kv_quant!r}")
        if num_pages < 2:
            raise ValueError("need at least the null page + one real")
        pos_rows = dense.p[f"_{dense.name}_pos_emb.w0"].shape[0]
        if max_pages_per_slot * page_size > pos_rows:
            raise ValueError(
                "slot capacity exceeds the position table — positions "
                "past it have no embedding row")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.dense = dense
        self.device = dense.device
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.temperature = temperature
        self.window = int(window)
        self.kv_quant = kv_quant
        self.warm_start = bool(warm_start)
        self._kernels_loaded = False
        self.head_dim = dense.head_dim
        self.kv_heads = dense.kv_heads
        self.dtype = dense.dtype
        if self.device.type == "cuda":
            probe_q = torch.empty((0, self.window, dense.n_heads,
                                   self.head_dim), dtype=self.dtype)
            kv_dtype = torch.int8 if kv_quant else self.dtype
            probe_k = torch.empty((0, self.page_size, self.kv_heads,
                                   self.head_dim), dtype=kv_dtype)
            probe_s = torch.empty((0, self.page_size, self.kv_heads),
                                  dtype=torch.float32) if kv_quant else None
            if not paged_ops.paged_kernel_supported(probe_q, probe_k,
                                                    probe_s):
                raise ValueError(
                    f"the paged window kernel does not take W "
                    f"{self.window}, {dense.n_heads} heads over "
                    f"{self.kv_heads} kv heads of dim {self.head_dim}, "
                    f"page {self.page_size}, {self.dtype}"
                    + (" with int8 pages" if kv_quant else "")
                    + " (paged_kernel_supported)")

    def load_kernels(self) -> Tuple[str, ...]:
        """Resolve the step's kernel libraries now (module doc of
        artifacts/runtime.py); a no-op off the card. Returns the names
        resolved."""
        if self.device.type != "cuda":
            return ()
        from paddle_tpu_torch.ops import _build
        for name in self.KERNEL_LIBRARIES:
            _build.load(name, warm=self.warm_start)
        self._kernels_loaded = True
        return self.KERNEL_LIBRARIES

    def init_pools(self):
        """Zeroed (k_pool, v_pool), each [L, n_pages, page_size, g, dh]
        at the parameters' dtype, on the decoder's device — or, under
        ``kv_quant="int8"``, dicts ``{"q": int8 values, "s": float32
        per-row scales [L, n_pages, page_size, g]}``."""
        shape = (self.dense.n_layers, self.num_pages, self.page_size,
                 self.kv_heads, self.head_dim)
        if self.kv_quant == "int8":
            def one():
                return {"q": torch.zeros(shape, dtype=torch.int8,
                                         device=self.device),
                        "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                         device=self.device)}
            return one(), one()
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    def pool_bytes(self) -> int:
        rows = self.dense.n_layers * self.num_pages * self.page_size * \
            self.kv_heads
        if self.kv_quant == "int8":
            # 1 byte an element + one float32 scale a row, per pool
            return 2 * rows * (self.head_dim + 4)
        esize = torch.empty((), dtype=self.dtype).element_size()
        return 2 * esize * rows * self.head_dim

    def _paged_block(self, i, x, k_pool, v_pool, page_idx, offs,
                     page_tables, kv_lens):
        d0 = self.dense
        p, n, h = d0.p, d0.name, d0.n_heads
        S, W = x.shape[0], x.shape[1]
        g = self.kv_heads
        ln1 = _ln(x, p[f"_{n}_l{i}_ln1.w0"], p[f"_{n}_l{i}_ln1.wbias"])
        q = _heads(ln1 @ p[f"_{n}_l{i}_q.w0"], h)       # [S, W, h, dh]
        k = _heads(ln1 @ p[f"_{n}_l{i}_k.w0"], g)        # [S, W, g, dh]
        v = _heads(ln1 @ p[f"_{n}_l{i}_v.w0"], g)
        # unconditional in-place scatter of every window token's K/V at
        # (physical page, in-page offset) — BEFORE attention, so later
        # window tokens attend to earlier ones. Masked tokens were
        # routed to the null page by the caller.
        if self.kv_quant == "int8":
            kq, ks = paged_ops.quantize_kv(k.reshape(S * W, g, -1))
            vq, vs = paged_ops.quantize_kv(v.reshape(S * W, g, -1))
            k_pool["q"][i, page_idx, offs] = kq
            k_pool["s"][i, page_idx, offs] = ks
            v_pool["q"][i, page_idx, offs] = vq
            v_pool["s"][i, page_idx, offs] = vs
            attn = paged_ops.paged_window_attention(
                q.contiguous(), k_pool["q"][i], v_pool["q"][i],
                page_tables, kv_lens, k_scales=k_pool["s"][i],
                v_scales=v_pool["s"][i])
        else:
            k_pool[i, page_idx, offs] = k.reshape(S * W, g, -1) \
                .to(k_pool.dtype)
            v_pool[i, page_idx, offs] = v.reshape(S * W, g, -1) \
                .to(v_pool.dtype)
            attn = paged_ops.paged_window_attention(
                q.contiguous(), k_pool[i], v_pool[i], page_tables, kv_lens)
        x = x + attn.reshape(x.shape) @ p[f"_{n}_l{i}_proj.w0"]
        return d0._ffn(i, x)

    def _forward(self, k_pool, v_pool, tokens, positions, page_tables,
                 active):
        """tokens/positions/active [S, W]; page_tables [S, P] int32 ->
        logits [S, W, V] (on the device); the pools change in place."""
        d0 = self.dense
        ps = self.page_size
        x = d0._embed(tokens, positions)                 # [S, W, d]
        page_idx = torch.gather(page_tables.long(), 1, positions // ps)
        page_idx = torch.where(active, page_idx, 0).reshape(-1)
        offs = torch.where(active, positions % ps, 0).reshape(-1)
        kv_lens = (positions + 1).to(torch.int32).contiguous()
        for i in range(d0.n_layers):
            x = self._paged_block(i, x, k_pool, v_pool, page_idx, offs,
                                  page_tables, kv_lens)
        return d0._logits(x)

    @torch.no_grad()
    def _step_impl(self, k_pool, v_pool, tokens, positions, page_tables,
                   active, generator):
        """tokens/positions/active [S, W]; page_tables [S, P] int32 ->
        next_tokens [S, W] (on the device); the pools change in place."""
        logits = self._forward(k_pool, v_pool, tokens, positions,
                               page_tables, active)       # [S, W, V]
        if self.temperature is None:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        flat = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                 generator=generator)
        return flat.reshape(logits.shape[:2])

    def step(self, k_pool, v_pool, tokens, positions, page_tables, active,
             generator: Optional[torch.Generator] = None):
        """Run one decode step. Accepts the classic [S] one-token arrays
        (returns next tokens [S]) or the [S, W] window contract (returns
        [S, W]); inputs are numpy arrays or tensors. Returns
        ``(next_tokens as numpy int32, k_pool, v_pool)`` — the pools are
        the objects passed in, updated in place; reading the tokens back
        is the one host sync of the step."""
        dev = self.device
        if not self._kernels_loaded:
            self.load_kernels()
        tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
        squeeze = tokens.dim() == 1
        positions = torch.as_tensor(np.asarray(positions),
                                    device=dev).long()
        active = torch.as_tensor(np.asarray(active), device=dev).bool()
        if squeeze:
            if self.window != 1:
                raise ValueError("one-token [S] arrays only drive a "
                                 "window=1 decoder")
            tokens, positions, active = \
                tokens[:, None], positions[:, None], active[:, None]
        tables = torch.as_tensor(np.asarray(page_tables, np.int32),
                                 device=dev).contiguous()
        nxt = self._step_impl(k_pool, v_pool, tokens, positions, tables,
                              active, generator)
        nxt = nxt.to(torch.int32).cpu().numpy()
        return (nxt[:, 0] if squeeze else nxt), k_pool, v_pool

    @torch.no_grad()
    def prefill_logits(self, ids) -> np.ndarray:
        """Teacher-forced logits [t, V] (float32, host) of one sequence
        ``ids`` [t] through this paged step, in fresh pools: slot 0,
        physical pages 1, 2, ..., W tokens a call. Row j is the
        distribution for position j + 1 under the paged numerics
        (int8 pages included) — the near-tie reference of
        :func:`tokens_agree` for an engine that runs them."""
        ids = [int(t) for t in np.asarray(ids).reshape(-1)]
        n_pages = -(-len(ids) // self.page_size)
        if n_pages > min(self.max_pages_per_slot, self.num_pages - 1):
            raise ValueError(f"{len(ids)} tokens need {n_pages} pages")
        k_pool, v_pool = self.init_pools()
        S, W, dev = self.num_slots, self.window, self.device
        tables = torch.zeros((S, self.max_pages_per_slot),
                             dtype=torch.int32, device=dev)
        tables[0, :n_pages] = torch.arange(1, n_pages + 1)
        rows = []
        for c in range(0, len(ids), W):
            chunk = ids[c:c + W]
            tokens = torch.zeros((S, W), dtype=torch.long, device=dev)
            positions = torch.zeros((S, W), dtype=torch.long, device=dev)
            active = torch.zeros((S, W), dtype=torch.bool, device=dev)
            tokens[0, :len(chunk)] = torch.tensor(chunk)
            positions[0, :len(chunk)] = torch.arange(c, c + len(chunk))
            active[0, :len(chunk)] = True
            logits = self._forward(k_pool, v_pool, tokens, positions,
                                   tables, active)
            rows.append(logits[0, :len(chunk)].float().cpu())
        return torch.cat(rows).numpy()

    @staticmethod
    def _leaves(pool) -> List[torch.Tensor]:
        """The pool's tensors: the bare float pool, or the int8 layout's
        values and scales (sorted keys)."""
        if isinstance(pool, dict):
            return [pool[key] for key in sorted(pool)]
        return [pool]

    @torch.no_grad()
    def copy_page(self, k_pool, v_pool, src: int, dst: int):
        """Copy physical page ``src`` -> ``dst`` in both pools, all
        layers, in place (values AND scales of the int8 layout) — the
        copy-on-write step behind partial-page prefix reuse
        (serving/prefix.py)."""
        for leaf in self._leaves(k_pool) + self._leaves(v_pool):
            leaf[:, int(dst)] = leaf[:, int(src)]
        return k_pool, v_pool

    @torch.no_grad()
    def read_page(self, k_pool, v_pool, page: int):
        """One physical page of both pools as [L, 1, ...] copies (same
        structure as the pools) — the spill tier's device -> host
        read (serving/engine.py)."""
        page = int(page)

        def rd(pool):
            if isinstance(pool, dict):
                return {key: leaf[:, page:page + 1].clone()
                        for key, leaf in pool.items()}
            return pool[:, page:page + 1].clone()

        return rd(k_pool), rd(v_pool)

    @torch.no_grad()
    def write_page(self, k_pool, v_pool, k_page, v_page, page: int):
        """Write [L, 1, ...] pages (the structure :meth:`read_page`
        returns) back into physical ``page`` of both pools, in place —
        the restore leg of page spill."""
        page = int(page)

        def wr(pool, data):
            if isinstance(pool, dict):
                for key, leaf in pool.items():
                    leaf[:, page:page + 1] = data[key].to(leaf.device,
                                                          leaf.dtype)
            else:
                pool[:, page:page + 1] = data.to(pool.device, pool.dtype)

        wr(k_pool, k_page)
        wr(v_pool, v_page)
        return k_pool, v_pool


class DraftDecoder:
    """The DRAFT side of speculative decoding: a small decoder over
    slot-PRIVATE dense caches, window-batched like PagedDecoder.

    The draft never shares the paged pool or the prefix trie — each
    slot owns a [T+1]-row dense cache lane (row T is the null row that
    masked tokens write to, mirroring the paged null page), and the
    engine teacher-forces the slot's committed tokens through it before
    asking for proposals. The engine only tracks how many committed
    tokens the draft has FED (``draft_pos``), rolls it back past
    rejected proposals, and re-feeds — every cache row is rewritten
    before any query's kv_len can reach it. Greedy argmax only.

    One [S, W] step serves catch-up (feed up to W committed tokens)
    and proposal (feed 1 token, read its argmax). Its attention is the
    reference's einsum outside any kernel (plain ``torch.einsum``), as
    the JAX draft step runs no Pallas kernel: it has no kernel library
    to resolve, and ``warm_start`` is kept for the engine's one flag."""

    KERNEL_LIBRARIES: Tuple[str, ...] = ()

    def __init__(self, dense: TransformerDecoder, *, num_slots: int,
                 max_seq_len: int, window: int = 1,
                 warm_start: bool = True):
        pos_rows = dense.p[f"_{dense.name}_pos_emb.w0"].shape[0]
        if max_seq_len > pos_rows:
            raise ValueError(f"max_seq_len {max_seq_len} exceeds the "
                             f"position table ({pos_rows} rows)")
        self.dense = dense
        self.device = dense.device
        self.num_slots = int(num_slots)
        self.max_seq_len = int(max_seq_len)
        self.window = int(window)
        self.warm_start = bool(warm_start)
        self.head_dim = dense.head_dim
        self.kv_heads = dense.kv_heads
        self.dtype = dense.dtype

    def load_kernels(self) -> Tuple[str, ...]:
        return self.KERNEL_LIBRARIES

    def init_caches(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zeroed (k, v), each [L, S, T+1, g, dh] — row T is the null
        row masked tokens write to (never read: kv_len <= T)."""
        shape = (self.dense.n_layers, self.num_slots,
                 self.max_seq_len + 1, self.kv_heads, self.head_dim)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    def cache_bytes(self) -> int:
        esize = torch.empty((), dtype=self.dtype).element_size()
        return 2 * esize * self.dense.n_layers * self.num_slots * \
            (self.max_seq_len + 1) * self.kv_heads * self.head_dim

    @torch.no_grad()
    def _step_impl(self, kc, vc, tokens, positions, active):
        """tokens/positions/active [S, W] -> argmax [S, W]; the caches
        change in place."""
        d0 = self.dense
        p, n, h, g = d0.p, d0.name, d0.n_heads, self.kv_heads
        S, W = tokens.shape
        rep = h // g
        rows = torch.arange(S, device=self.device)[:, None].expand(S, W)
        wpos = torch.where(active, positions, self.max_seq_len)
        x = d0._embed(tokens, torch.where(active, positions, 0))
        kv_lens = positions + 1                          # [S, W]
        tpos = torch.arange(self.max_seq_len + 1, device=self.device)
        mask = tpos[None, None, :] < kv_lens[:, :, None]  # [S, W, T+1]
        for i in range(d0.n_layers):
            ln1 = _ln(x, p[f"_{n}_l{i}_ln1.w0"], p[f"_{n}_l{i}_ln1.wbias"])
            q = _heads(ln1 @ p[f"_{n}_l{i}_q.w0"], h)    # [S, W, h, dh]
            k = _heads(ln1 @ p[f"_{n}_l{i}_k.w0"], g)
            v = _heads(ln1 @ p[f"_{n}_l{i}_v.w0"], g)
            kc[i, rows, wpos] = k.to(kc.dtype)
            vc[i, rows, wpos] = v.to(vc.dtype)
            dh = q.shape[-1]
            q5 = q.reshape(S, W, g, rep, dh)
            logits = torch.einsum("swgrd,stgd->sgrwt", q5,
                                  kc[i].to(q.dtype)) * (dh ** -0.5)
            logits = torch.where(mask[:, None, None], logits,
                                 torch.tensor(_NEG_INF, dtype=logits.dtype,
                                              device=self.device))
            w_ = torch.softmax(logits, dim=-1)
            attn = torch.einsum("sgrwt,stgd->swgrd", w_,
                                vc[i].to(q.dtype))
            x = x + attn.reshape(x.shape) @ p[f"_{n}_l{i}_proj.w0"]
            x = d0._ffn(i, x)
        return torch.argmax(d0._logits(x), dim=-1)

    def step(self, kc, vc, tokens, positions, active):
        """One [S, W] draft step over numpy arrays or tensors. Returns
        ``(argmax as numpy int32 [S, W], kc, vc)`` — the caches are the
        tensors passed in, updated in place."""
        dev = self.device
        tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
        positions = torch.as_tensor(np.asarray(positions),
                                    device=dev).long()
        active = torch.as_tensor(np.asarray(active), device=dev).bool()
        out = self._step_impl(kc, vc, tokens, positions, active)
        return out.to(torch.int32).cpu().numpy(), kc, vc
