#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, serves,
trains and infers.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. build — compile every hand-written kernel from the sources in this
   checkout (one nvcc per source, all at once, sm_90a), print the
   ptxas report.
2. kernel vs plain — paged window attention at full width (dh 64,
   page 16, 8 slots, 34 pages a slot, lengths up to 544), h/g in
   {8/8, 8/2, 8/1}, W in {1, 4}, float32 and bfloat16, against the
   plain PyTorch version on the same inputs: rtol 2e-4 / atol 2e-5 in
   float32 (the JAX package's bound for its kernel against its
   einsum), atol 2e-2 in bfloat16 (bf16 output rounding); a row with
   kv_len 0 against the TPU kernel's value for it, the mean of V over
   the slot's used pages; and the allocated-pages contract — NaN
   written into every page past each slot's used count changes
   nothing.
3. engine — the main path through the entry points a user calls: a
   full-width transformer_lm (vocab 32000, d_model 512, 8 heads, 6
   layers, d_ff 2048, max_len 544, float32, random weights from seed
   0) in a DecodeEngine with 8 slots, 16-token pages, 273 pages and
   the prefix cache on, serving 16 seeded requests (prompts 16-96
   tokens, 16-64 new tokens). Kernel launch counts are zeroed just
   before and read just after. Asserts: every request finishes with
   its tokens, zero step failures, launches == steps x 6 layers,
   balanced page accounting, and greedy tokens of 4 requests
   identical to the port's dense TransformerDecoder.generate on the
   card under the tie rule.
4. timings — engine tokens/s and p50 inter-token ms; the kernel's
   median device time per call at the engine's shapes (CUDA-graph
   replay timed with CUDA events; pool slices cycled
   over the 6 layers, so the 107 MB of K/V defeat the 50 MB L2), its
   byte/flop bound, the plain version's time, and
   torch.nn.functional.scaled_dot_product_attention on the gathered
   view as a yardstick (library_ms; the port never calls it).
5. trace — 8 more requests under torch.profiler: device busy time by
   kernel against the wall clock, per engine step.
6. flash vs plain — the flash attention forward, dq and dk/dv kernels
   at full width ([8, T, 8, 64]): causal T 1024 with ragged kv_lens,
   and non-causal T 1000 (not a block multiple) with q_lens below T
   and fully-masked rows; out, lse, dq, dk, dv against autograd of the
   plain version in float32 on the same values: float32
   assert_close(rtol 2e-4, atol 2e-5 max(1, max|ref|)), bfloat16
   max |err| <= 2e-2 max(1, max|ref|).
7. train — the main training path: the full-width tied transformer_lm
   (vocab 32000, d_model 512, 8 heads, 6 layers, d_ff 2048, 1024
   tokens) built with the port's DSL, Parameters.create, and
   SGD.train_batch with Adam(1e-4) in bfloat16 on one seeded batch of
   8 full-length rows: 2 warm-up steps, then 8 timed steps with the
   flash launch counts zeroed just before and read just after. Asserts
   finite, falling losses, finite parameters and launches == steps x
   6 for each flash kernel. Then, in float32 from one table, the
   gradients of one Topology.forward cost with use_flash_attention
   True against False: the worst per-parameter ||diff|| / ||g|| at
   most max(1e-3, twice the plain path's own spread under a 2^-22
   input perturbation) — the ReLU makes the gradient discontinuous, so
   at this width two correct float32 runs differ by ~1e-3.
8. train -> serve — the trained table through Parameters.to_tar,
   load_params_tar, TransformerDecoder (tied head) and DecodeEngine:
   4 seeded requests, zero step failures, tokens identical to the
   dense generate under the tie rule.
9. flash timings — each flash kernel's device time per call at the
   training shapes, bf16 and f32 (CUDA-graph replay over 6 input
   sets), its bound, the plain version's time, and SDPA as a yardstick
   (forward; autograd backward against dq + dk/dv together).
10. train trace — one bfloat16 train step under torch.profiler (run
   right after phase 7): device busy time against the wall clock, the
   top kernels, the flash share.
11. rnn vs plain — the fused LSTM forward (with and without residuals)
   and backward kernels and the GRU forward kernel against their plain
   versions on the same inputs: the LSTM at full width (b 128, h 1280,
   T 128, ragged lengths with 100, 1 and 128) and at b 6, h 48, T 13
   (a multiple of no tile), the GRU at b 64, h 128, T 64 ragged;
   h_seq, hT, cT, cseq, gates, dz, and through the autograd Function
   dx4, dw, dbias, dpeep against autograd of the plain version in
   float32; float32 and bfloat16 at the tolerances of phase 6.
12. lstm train — the sequence slice's main path: stacked_lstm_net at
   the RNN benchmark's widest row (vocab 30000, emb 128, hidden 1280,
   one LSTM, 2 classes; 11,060,482 parameters) built with the port's
   DSL, Parameters.create from a seeded generator, SGD.train_batch
   with Adam(5e-4) (the benchmark's 2e-3 overshoots at this width, see
   LSTM_LR) in bfloat16 on one seeded batch of 128 rows of 100
   tokens: 2 warm-up steps, then 8 timed steps with the launch counts
   zeroed just before. Asserts finite, falling losses, finite
   parameters and 8 launches each of the LSTM forward (with residuals)
   and backward kernels. Then, in float32 from one table on 16 of the
   rows, the gradients of one cost through the kernels against the
   plain scan of the CPU port: worst per-parameter ||diff|| / ||g|| <=
   1e-3.
13. lstm infer — paddle.infer of the probabilities over 512 seeded
   ragged samples in batches of 128, float32, from the trained table:
   4 forward launches without residuals, probabilities within 1e-4 of
   the CPU port's.
14. tagger — rnn_crf_tagger at its defaults (vocab 20000, 45 labels,
   emb 128, hidden 128): 3 float32 train steps on 64 sentences of 8-64
   tokens (the plain GRU scans, no kernel launch), then infer of the
   Viterbi path over 256 sentences in batches of 64: 4 GRU kernel
   launches, labels identical to the CPU port's.
15. rnn timings — each recurrent kernel's device time per call and per
   run step at the main path's shapes in bfloat16 and float32
   (CUDA-graph replay), its bound, the plain version's time, and
   cuDNN's LSTM forward as a labelled near-yardstick (printed only).
16. lstm train trace — one bfloat16 LSTM train step under
   torch.profiler (run right after phase 12): device busy against the
   wall clock, the top kernels, the LSTM kernels' share.
17. int8 kernel vs plain — the int8 path of the paged window kernel
   at phase 2's widths (q float32 and bfloat16, h/g 8/8, 8/2, 8/1, W
   1, 3 and 4, pages quantized on the card) against its plain version
   at phase 2's tolerances; NaN scales past each slot's used pages
   change nothing; a kv_len-0 row returns the mean of dequantized V;
   quantize_kv on the card is bit-equal to the CPU port's.
18. decode kernel vs plain — decode_attention at b 8, h 8, g 8/2/1, dh
   64, T 544, shared and per-row lengths (one of them 0), float32 and
   bfloat16, against decode_reference; paged_attention(use_kernel=True)
   against the einsum path over phase 3's engine pages. These calls
   are the kernel's launches: no engine route reaches it.
19. int8 engine — phase 3's 16 requests with kv_quant="int8": launches
   of the int8 kernel == steps x 6 and of the float kernel 0, balanced
   pages, the first 4 requests' tokens against the CPU port's int8
   engine on the same table under the tie rule (the tie reference is
   the CPU int8 paged step's teacher-forced logits); prints how many
   requests match the float engine token for token.
20. speculation — phase 3's requests with spec_k 2 (W 3): the
   same-weights draft, then a 2-layer draft from another seed; tokens
   of the first 4 requests agree with the dense reference (tie rule),
   float kernel launches == target steps x 6, same-weights tokens per
   step > 1; prints accepted/proposed and tokens/s against phase 3.
21. two-tier — int8 pages + speculation on a pool cut to 72 pages
   with a 256-page host spill store: waves of 8 prompts sharing a
   two-page prefix push cold pages to host and a revisit restores
   them; spills and restores > 0, revisit tokens equal the first
   visit's, both tiers balance.
22. two-tier timings and trace — the int8 kernel at the int8 engine's
   shapes (W 1 and 3) and the decode kernel at b 8, h 8, g 8, T 544
   over the same 8 lengths, float32 and bfloat16, by CUDA-graph replay,
   with their bounds (the decode kernel's counts each row's live
   columns only), plain times and SDPA yardsticks; then 8 requests
   through the int8 + speculative engine under torch.profiler.

Prints the kernel table as one JSON line (the flash and LSTM kernels at
their bfloat16 times, the training dtype; the GRU kernel at float32, the
dtype the tagger decodes in; the int8 and decode kernels at float32, the
serving dtype, W 1), the card's name and power limit (nvidia-smi), and
last {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM, non-tensor float32
FULL = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
            d_ff=2048, max_len=544)
SLOTS, PAGE, N_REQ = 8, 16, 16
SPEC_K = 2                         # bench.py decode_speculative: W = 3
F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_ATOL = 2e-2
TIE_RTOL, TIE_ATOL = 1e-4, 1e-5    # the logits tolerance of the tests
BF16_FLOPS_PER_S = 989e12          # H100 SXM, dense bf16 tensor cores
FLASH_SHAPE = (8, 8, 64)           # batch, heads, head dim of the LM
FLASH_KV_LENS = [1024, 1000, 777, 513, 512, 300, 64, 17]
# the train step bench.py:245-286 runs: tied transformer_lm, 8 x 1024
TRAIN = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
             d_ff=2048, max_len=1024, tie_embeddings=True)
TRAIN_ROWS, TRAIN_WARMUP, TRAIN_STEPS = 8, 2, 8
# (name, line of the TPU kernel in ops/pallas_attention.py, source)
FLASH_KERNELS = [("fwd", 43, "flash_attention_fwd.cu"),
                 ("dq", 225, "flash_attention_bwd.cu"),
                 ("dkv", 264, "flash_attention_bwd.cu")]


_T0 = time.perf_counter()


def log(msg):
    """A progress line, stamped with the seconds since the start."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, iters, reps=5):
    """Median device milliseconds per call: ``iters`` calls captured in
    one CUDA graph, the replay timed with CUDA events. Eager
    back-to-back calls would time the host's Python issue rate, not
    the card, at these microsecond sizes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / iters)
    return float(np.median(per))


def host_ms(fn, iters=50):
    """Wall milliseconds per eager call, synchronised at the end — the
    rate at which the host issues the call."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


# ------------------------------------------------------------ phase 1
def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    secs = time.perf_counter() - t0
    for name, rep in reports.items():
        lines = [ln.strip() for ln in rep.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "bytes stack" in ln]
        log(f"build {name}: " + ("; ".join(lines) or "reused"))
    log(f"build seconds: {secs:.3f}")
    return secs


# ------------------------------------------------------------ phase 2
def _window_case(h, g, W, dtype, seed):
    """Full-width paged-attention inputs: out-of-order pages, ragged
    lengths up to 544, one idle slot on the null page."""
    rng = np.random.RandomState(seed)
    dh, P = 64, FULL["max_len"] // PAGE
    n_pages = SLOTS * P + 1
    dev = torch.device("cuda")
    k = torch.from_numpy(rng.randn(n_pages, PAGE, g, dh).astype(np.float32))
    v = torch.from_numpy(rng.randn(n_pages, PAGE, g, dh).astype(np.float32))
    q = torch.from_numpy(rng.randn(SLOTS, W, h, dh).astype(np.float32))
    tables = np.zeros((SLOTS, P), np.int32)
    tables[1:] = (rng.permutation(n_pages - 1)[:(SLOTS - 1) * P] + 1) \
        .reshape(SLOTS - 1, P)
    base = np.array([1, 17, 100, 255, 256, 300, 513, 544 - W + 1])
    lens = np.minimum(base[:, None] + np.arange(W)[None, :],
                      FULL["max_len"]).astype(np.int32)
    args = [q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(lens).to(dev)]
    return args, tables, lens


def phase_kernel_vs_plain():
    from paddle_tpu_torch.ops import paged_decode as ops
    worst = 0.0
    for (h, g) in ((8, 8), (8, 2), (8, 1)):
        for W in (1, 4):
            for dtype in (torch.float32, torch.bfloat16):
                args, tables, lens = _window_case(h, g, W, dtype,
                                                  seed=h * 10 + g + W)
                got = ops.paged_window_attention(*args)
                torch.cuda.synchronize()
                # the plain version on the same values, in float32
                f32 = [a.float() if a.is_floating_point() else a
                       for a in args]
                want = ops.paged_window_reference(*f32)
                err = (got.float() - want).abs().max().item()
                if dtype == torch.float32:
                    torch.testing.assert_close(got, want, **F32_TOL)
                    worst = max(worst, err)
                elif err > BF16_ATOL:
                    raise AssertionError(
                        f"bf16 kernel off by {err} > {BF16_ATOL}")
                zero_err = _check_zero_len_row(ops, args, tables, lens,
                                               dtype)
                # allocated-pages contract: pages past each slot's used
                # count are never read — poison them, nothing changes
                P = tables.shape[1]
                used = np.clip(-(-lens.max(axis=1) // PAGE), 1, P)
                tail = np.concatenate([tables[s, used[s]:]
                                       for s in range(SLOTS)])
                tail = torch.from_numpy(tail[tail > 0].astype(np.int64))
                args[1][tail.cuda()] = float("nan")
                args[2][tail.cuda()] = float("nan")
                again = ops.paged_window_attention(*args)
                torch.cuda.synchronize()
                if not torch.equal(again, got):
                    raise AssertionError("kernel read a page past a "
                                         "slot's used count")
                log(f"kernel vs plain h={h} g={g} W={W} "
                    f"{str(dtype)[6:]}: max_abs_err {err:.3e}, kv_len-0 "
                    f"row {zero_err:.3e}")
    return worst


def _check_zero_len_row(ops, args, tables, lens, dtype):
    """Window token 0 of slot 2 with kv_len 0 must return what the TPU
    kernel returns for it: the mean of V over every column of the
    slot's used pages (pallas_decode.py:297-314 does not zero masked
    weights). The other rows keep the plain version's values."""
    s = 2
    lens0 = lens.copy()
    lens0[s, 0] = 0
    ln = torch.from_numpy(lens0).to(args[4].device)
    got = ops.paged_window_attention(*args[:4], ln)
    torch.cuda.synchronize()
    q, v_pages = args[0], args[2]
    h, g = q.shape[2], v_pages.shape[2]
    used = min(max(-(-int(lens0[s].max()) // PAGE), 1), tables.shape[1])
    pages = torch.from_numpy(tables[s, :used].astype(np.int64)).cuda()
    mean_v = v_pages[pages].float().reshape(-1, g, q.shape[3]).mean(dim=0)
    want = mean_v.repeat_interleave(h // g, dim=0)         # [h, dh]
    err = (got[s, 0].float() - want).abs().max().item()
    if err > (F32_TOL["atol"] if dtype == torch.float32 else BF16_ATOL):
        raise AssertionError(f"kv_len-0 row off the mean of V by {err}")
    keep = torch.ones(got.shape[:2], dtype=torch.bool, device=got.device)
    keep[s, 0] = False
    want_rest = ops.paged_window_reference(
        *[a.float() if a.is_floating_point() else a for a in args[:4]], ln)
    if dtype == torch.float32:
        torch.testing.assert_close(got[keep], want_rest[keep], **F32_TOL)
    elif (got[keep].float() - want_rest[keep]).abs().max() > BF16_ATOL:
        raise AssertionError("a kv_len-0 row changed the other rows")
    return err


# ------------------------------------------------------------ phase 3
def phase_engine():
    from paddle_tpu_torch.models.decode import TransformerDecoder
    from paddle_tpu_torch.ops import paged_decode as ops
    from paddle_tpu_torch.params import init_transformer_lm_params
    from paddle_tpu_torch.serving import DecodeEngine

    dec = TransformerDecoder(init_transformer_lm_params(FULL, seed=0),
                             n_layers=FULL["n_layers"],
                             n_heads=FULL["n_heads"])
    eng = DecodeEngine(dec, num_slots=SLOTS, page_size=PAGE,
                       max_seq_len=FULL["max_len"])
    assert eng.pool.num_pages == SLOTS * (FULL["max_len"] // PAGE) + 1
    eng.warmup()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, FULL["vocab_size"],
                           (int(rng.randint(16, 97)),)).astype(np.int32)
               for _ in range(N_REQ)]
    news = [int(rng.randint(16, 65)) for _ in range(N_REQ)]
    torch.cuda.synchronize()
    ops.paged_window_attention.launches = 0
    reqs, wall = _serve(eng, prompts, news)
    launches = ops.paged_window_attention.launches
    st = eng.stats()
    for i, r in enumerate(reqs):
        if not all(0 <= t < FULL["vocab_size"] for t in r.get(timeout=1)):
            raise AssertionError(f"request {i}: token out of range")
    if launches != st["steps"] * FULL["n_layers"] or launches == 0:
        raise AssertionError(f"kernel launches {launches} != steps "
                             f"{st['steps']} x {FULL['n_layers']}")
    dense = []
    for i in range(4):
        p = prompts[i]
        want = dec.generate(p[None, :], max_len=len(p) + news[i])[0]
        ref = dec.prefill_logits(np.concatenate([p, want])[None, :])[0]
        dense.append((want, ref[len(p) - 1:]))
    _check_dense(reqs, dense, "engine")
    gen = st["tokens_out"]
    log(f"engine: {N_REQ} requests, {gen} tokens, {st['steps']} steps, "
        f"{wall:.3f} s, {gen / wall:.1f} tokens/s, p50 inter-token "
        f"{st['token_latency_p50_ms']} ms, p99 "
        f"{st['token_latency_p99_ms']} ms, kernel launches {launches}, "
        f"prefix hit pages {st['prefix_hit_pages']}")
    return dict(eng=eng, dec=dec, prompts=prompts, news=news,
                launches=launches, tokens=[r.get(timeout=1) for r in reqs],
                dense=dense, tokens_per_s=gen / wall,
                pool_bytes=eng.paged.pool_bytes())


def _check_dense(reqs, dense, label):
    """The first requests' tokens against the dense decoder's greedy
    rows under the tie rule (``dense``: (tokens, logits) pairs)."""
    from paddle_tpu_torch.models.decode import tokens_agree
    for i, (want, ref) in enumerate(dense):
        tol = TIE_ATOL + TIE_RTOL * float(np.abs(ref).max())
        if not tokens_agree(reqs[i].get(timeout=1), want, ref, tol):
            raise AssertionError(f"{label} request {i}: tokens differ "
                                 "from the dense reference")


# ------------------------------------------------------------ phase 4
def phase_timings(eng, prompts, news):
    """The kernel at the engine's shapes: the first 8 requests at their
    final lengths, one token each, over the engine's real pools."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import paged_decode as ops

    k_pool, v_pool = eng.k_pool, eng.v_pool
    L, n_pages, ps, g, dh = k_pool.shape
    h, P = FULL["n_heads"], FULL["max_len"] // PAGE
    lens = np.array([len(p) + n for p, n in
                     zip(prompts[:SLOTS], news[:SLOTS])], np.int32)
    used = -(-lens // ps)
    rng = np.random.RandomState(1)
    tables = np.zeros((SLOTS, P), np.int32)
    pages = rng.permutation(n_pages - 1) + 1
    at = 0
    for s in range(SLOTS):
        tables[s, :used[s]] = pages[at:at + used[s]]
        at += used[s]
    dev = k_pool.device
    q = torch.randn(SLOTS, 1, h, dh, device=dev)
    tb = torch.from_numpy(tables).to(dev)
    ln = torch.from_numpy(lens[:, None]).to(dev)
    ks = [k_pool[i] for i in range(L)]
    vs = [v_pool[i] for i in range(L)]

    def kernel(i):
        return ops.paged_window_attention(q, ks[i % L], vs[i % L], tb, ln)

    def plain(i):
        return ops.paged_window_reference(q, ks[i % L], vs[i % L], tb, ln)

    kernel_ms = device_ms(kernel, iters=60)
    plain_ms = device_ms(plain, iters=12)
    kernel_host_ms = host_ms(kernel)
    # yardstick: one library call on the gathered [S, h, T, dh] view
    kg = [ops.gather_pages(ks[i], tb).permute(0, 2, 1, 3) for i in range(L)]
    vg = [ops.gather_pages(vs[i], tb).permute(0, 2, 1, 3) for i in range(L)]
    mask = (torch.arange(P * ps, device=dev)[None, :] < ln)[:, None, None]
    qs = q.permute(0, 2, 1, 3)

    gqa = {} if g == h else {"enable_gqa": True}

    def sdpa(i):
        return F.scaled_dot_product_attention(
            qs, kg[i % L], vg[i % L], attn_mask=mask, **gqa)

    want = ops.paged_window_reference(q, ks[0], vs[0], tb, ln)
    torch.testing.assert_close(sdpa(0).permute(0, 2, 1, 3), want,
                               **F32_TOL)
    library_ms = device_ms(sdpa, iters=60)

    esize = k_pool.element_size()
    kv_bytes = 2 * int(used.sum()) * ps * g * dh * esize
    io_bytes = 2 * q.numel() * q.element_size() + tb.numel() * 4 + \
        ln.numel() * 4
    flops = 4.0 * float(lens.sum()) * h * dh
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"kernel at engine shapes (lens {lens.tolist()}): "
        f"{kernel_ms * 1e3:.2f} us/call on the device "
        f"({kernel_host_ms * 1e3:.2f} us/call issued eagerly), "
        f"bound {bound_ms * 1e3:.3f} us "
        f"({kv_bytes + io_bytes} bytes), plain {plain_ms * 1e3:.2f} us, "
        f"sdpa {library_ms * 1e3:.2f} us")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ phase 5
def phase_trace(eng):
    """Where an engine step's time goes: 8 fresh requests served under
    torch.profiler; device busy time by kernel against the wall clock
    (the profiler slows the host, so the idle share is an upper
    bound)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(7)
    steps0 = eng.stats()["steps"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reqs = [eng.submit(rng.randint(0, FULL["vocab_size"], (32,)), 16)
                for _ in range(SLOTS)]
        eng.run(timeout=600)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for r in reqs:
        r.get(timeout=1)
    steps = eng.stats()["steps"] - steps0
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA" and ev.self_device_time_total > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + \
                ev.self_device_time_total / 1e3
    busy_ms = sum(by_kernel.values())
    paged_ms = sum(v for k, v in by_kernel.items() if "paged_window" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    log(f"trace: {steps} steps, wall {wall_ms:.3f} ms "
        f"({wall_ms / steps:.3f} ms/step), device busy {busy_ms:.3f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f}), paged window kernel "
        f"{paged_ms:.3f} ms ({paged_ms / steps * 1e3:.2f} us/step)")
    for name, ms in top:
        log(f"trace top kernel: {ms:.3f} ms  {name[:90]}")


# ------------------------------------------------------------ phase 6
def _flash_inputs(T, dtype, seed):
    rng = np.random.RandomState(seed)
    b, h, d = FLASH_SHAPE
    return [torch.from_numpy(rng.randn(b, T, h, d).astype(np.float32))
            .to("cuda", dtype) for _ in range(4)]            # q, k, v, dO


def _flash_kernels(q, k, v, do, lens2, causal):
    """Forward, D = rowsum(dO*O), dq and dk/dv through the three kernel
    wrappers, as the autograd Function runs them."""
    from paddle_tpu_torch.ops import flash_attention as fa
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_forward(q, k, v, lens2, causal, scale)
    dd = fa.rowsum_do_o(do, out)
    dq = fa.flash_backward_dq(q, k, v, do, lse, dd, lens2, causal, scale)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, dd, lens2, causal,
                                   scale)
    return out, lse, dd, dq, dk, dv


def _held(name, got, want, dtype):
    """float32: assert_close(rtol 2e-4, atol 2e-5 * max(1, max|ref|));
    bfloat16: max |err| <= 2e-2 * max(1, max|ref|). Returns max |err|."""
    got, want = got.float(), want.float()
    bound = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=F32_TOL["rtol"],
                                   atol=F32_TOL["atol"] * bound,
                                   msg=lambda m: f"{name}: {m}")
    elif err > BF16_ATOL * bound:
        raise AssertionError(f"bf16 {name} off by {err} > "
                             f"{BF16_ATOL} x {bound}")
    return err


def phase_flash_vs_plain():
    """The three flash kernels against autograd of the plain version in
    float32 on the same (rounded) values, at full width: causal T 1024
    with ragged kv_lens, and non-causal T 1000 (not a block multiple)
    with q_lens below T, fully-masked batch rows included."""
    from paddle_tpu_torch.ops import flash_attention as fa
    cases = [("causal T1024", 1024, True, [1024] * 8, FLASH_KV_LENS),
             ("non-causal T1000", 1000, False,
              [1000, 999, 640, 513, 100, 1, 0, 64],
              [1000, 1000, 777, 1, 512, 300, 64, 0])]
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for ci, (label, T, causal, q_lens, kv_lens) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = _flash_inputs(T, dtype, seed=60 + ci)
            lens2 = torch.tensor(np.stack([q_lens, kv_lens], 1),
                                 dtype=torch.int32, device="cuda")
            out, lse, _, dq, dk, dv = _flash_kernels(q, k, v, do, lens2,
                                                     causal)
            torch.cuda.synchronize()
            qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
            ql, kl = lens2[:, 0], lens2[:, 1]
            scale = q.shape[-1] ** -0.5
            ref = fa.flash_attention_reference(qf, kf, vf, ql, kl, causal,
                                               scale)
            gq, gk, gv = torch.autograd.grad(ref, (qf, kf, vf), do.float())
            lse_ref = fa.flash_lse_reference(qf.detach(), kf.detach(), ql,
                                             kl, causal, scale)
            live = lse_ref > fa.NEG_INF / 2
            if not torch.all(lse[~live] == fa.NEG_INF):
                raise AssertionError(f"{label}: lse of a fully-masked row "
                                     "is not NEG_INF")
            errs = {"out": _held("out", out, ref, dtype),
                    "lse": _held("lse", lse[live], lse_ref[live],
                                 torch.float32),
                    "dq": _held("dq", dq, gq, dtype),
                    "dk": _held("dk", dk, gk, dtype),
                    "dv": _held("dv", dv, gv, dtype)}
            if dtype == torch.float32:
                worst["fwd"] = max(worst["fwd"], errs["out"], errs["lse"])
                worst["dq"] = max(worst["dq"], errs["dq"])
                worst["dkv"] = max(worst["dkv"], errs["dk"], errs["dv"])
            log(f"flash vs plain {label} {str(dtype)[6:]}: " + ", ".join(
                f"{n} {e:.3e}" for n, e in errs.items()))
            del ref, gq, gk, gv
    return worst


# ------------------------------------------------------------ phase 7
def _lm_spec(compute_dtype):
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.registry import reset_name_counters
    from paddle_tpu_torch.models import transformer_lm
    config.init(seed=0, compute_dtype=compute_dtype)
    reset_name_counters()
    return transformer_lm(**TRAIN)


def _lm_batch(seed=0):
    """TRAIN_ROWS full-length rows of seeded tokens: (tokens, positions,
    next tokens)."""
    rng = np.random.RandomState(seed)
    T = TRAIN["max_len"]
    toks = rng.randint(0, TRAIN["vocab_size"], (TRAIN_ROWS, T + 1)) \
        .astype(np.int32)
    return [(toks[i, :-1], np.arange(T, dtype=np.int32), toks[i, 1:])
            for i in range(TRAIN_ROWS)]


def _flash_counts(fa, zero=False):
    fns = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)
    if zero:
        for fn in fns:
            fn.launches = 0
    return [fn.launches for fn in fns]


def phase_train():
    """The main training path: SGD.train_batch with Adam(1e-4) on the
    full-width tied transformer_lm in bfloat16, 8 x 1024 tokens."""
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import SGD, create

    spec = _lm_spec("bfloat16")
    topo = Topology(spec.cost, extra_outputs=[spec.output])
    params = create(topo, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in params.raw.values())
    trainer = SGD(spec.cost, params, Adam(learning_rate=1e-4))
    batch = _lm_batch()
    losses = [trainer.train_batch(batch)[0] for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _flash_counts(fa, zero=True)
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(trainer.train_batch(batch)[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _flash_counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: "
                             f"{losses}")
    bad = [k for k, p in params.raw.items()
           if not bool(torch.isfinite(p).all())]
    if bad:
        raise AssertionError(f"non-finite parameters after training: {bad}")
    want = TRAIN_STEPS * TRAIN["n_layers"]
    if launches != [want] * 3:
        raise AssertionError(f"flash launches {launches} != steps x layers "
                             f"= {want} each")
    step_ms = wall / TRAIN_STEPS * 1e3
    tokens = TRAIN_ROWS * TRAIN["max_len"]
    log(f"train: {n_params} parameters, bf16, {TRAIN_STEPS} timed steps "
        f"after {TRAIN_WARMUP}: {step_ms:.3f} ms/step, "
        f"{tokens / (step_ms / 1e3):.1f} tokens/s, peak "
        f"{peak_gb:.3f} GB; losses {[round(x, 4) for x in losses]}; "
        f"flash launches fwd/dq/dkv {launches}")
    return trainer, batch, launches


def phase_flash_grad_check(batch):
    """float32, full width, one table: the gradients of one
    Topology.forward cost with use_flash_attention True (the kernels)
    against False (the plain version): the worst per-parameter
    ||g_kernel - g_plain|| / ||g_plain|| at most max(1e-3, twice the
    plain version's own spread), and the costs within 1e-5.

    Not elementwise: the FFN's ReLU makes the gradient discontinuous,
    and among the 8192 x 2048 pre-activations of a layer some lie
    within float32 rounding of 0, so any two correct float32 runs that
    round differently flip a few of them: single gradient entries move
    by up to ~1e-2 of max|g| and whole parameters by ~1e-3 in norm.
    The same measures between the plain version and itself with the
    token table scaled by (1 + 2^-22) give that noise floor."""
    from paddle_tpu_torch.config import global_config
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.trainer import DataFeeder, create

    spec = _lm_spec("float32")
    topo = Topology(spec.cost)
    params = create(topo, torch.Generator().manual_seed(1)).raw
    feed = DataFeeder(topo.data_type(), device="cuda")(batch)
    n_real = feed.pop("__batch_size__")
    names = sorted(params)
    leaves = [params[k].requires_grad_() for k in names]

    def grads(flag):
        global_config().use_flash_attention = flag
        try:
            outs, _ = topo.forward(params, {}, feed, n_real=n_real)
            cost = outs[spec.cost.name].sum() / n_real
            return cost.item(), torch.autograd.grad(cost, leaves)
        finally:
            global_config().use_flash_attention = True

    def worst(ga, gb):
        rel = max(((a - b).norm() / b.norm()).item() for a, b in
                  zip(ga, gb))
        ent = max(((a - b).abs().max() / b.abs().max()).item() for a, b in
                  zip(ga, gb))
        return rel, ent

    cost_k, g_k = grads(True)
    cost_p, g_p = grads(False)
    tok = params["_tfm_tok_emb.w0"]
    saved = tok.detach().clone()
    with torch.no_grad():
        tok.mul_(1.0 + 2.0 ** -22)
    _, g_floor = grads(False)
    with torch.no_grad():
        tok.copy_(saved)
    rel, ent = worst(g_k, g_p)
    rel_floor, ent_floor = worst(g_floor, g_p)
    log(f"f32 grads at full width over {len(names)} parameters: cost "
        f"{cost_k:.6f} (kernels) vs {cost_p:.6f} (plain); kernels vs plain "
        f"worst ||diff||/||g|| {rel:.3e}, worst max|diff|/max|g| {ent:.3e};"
        f" plain vs plain at a 2^-22 input perturbation {rel_floor:.3e} and "
        f"{ent_floor:.3e}")
    if not rel <= max(1e-3, 2.0 * rel_floor) or \
            abs(cost_k - cost_p) > 1e-5 * abs(cost_p):
        raise AssertionError(f"flash-path gradients off the plain path: "
                             f"||diff||/||g|| {rel} > max(1e-3, 2 x "
                             f"{rel_floor}) or cost {cost_k} vs {cost_p}")


# ------------------------------------------------------------ phase 8
def phase_train_to_serve(trainer):
    """The trained table: Parameters.to_tar -> load_params_tar ->
    TransformerDecoder (tied head) -> DecodeEngine, 4 seeded requests,
    tokens identical to the dense generate under the tie rule."""
    import io
    from paddle_tpu_torch.models.decode import (TransformerDecoder,
                                                tokens_agree)
    from paddle_tpu_torch.params import load_params_tar
    from paddle_tpu_torch.serving import DecodeEngine

    buf = io.BytesIO()
    trainer.save_parameter_to_tar(buf)
    buf.seek(0)
    table = load_params_tar(buf)
    if "_tfm_head.w0" in table:
        raise AssertionError("a tied table carries a separate head")
    dec = TransformerDecoder(table, n_layers=TRAIN["n_layers"],
                             n_heads=TRAIN["n_heads"])
    eng = DecodeEngine(dec, num_slots=4, page_size=PAGE, max_seq_len=128)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, TRAIN["vocab_size"],
                           (int(rng.randint(16, 49)),)).astype(np.int32)
               for _ in range(4)]
    reqs = [eng.submit(p, 16) for p in prompts]
    eng.run(timeout=600)
    st = eng.stats()
    if st["step_failures"]:
        raise AssertionError(f"{st['step_failures']} step failures: "
                             f"{eng.last_step_error}")
    for i, (p, r) in enumerate(zip(prompts, reqs)):
        got = r.get(timeout=1)
        want = dec.generate(p[None, :], max_len=len(p) + 16)[0]
        ref = dec.prefill_logits(np.concatenate([p, want])[None, :])[0]
        tol = TIE_ATOL + TIE_RTOL * float(np.abs(ref).max())
        if len(got) != 16 or not tokens_agree(got, want, ref[len(p) - 1:],
                                               tol):
            raise AssertionError(f"served request {i} differs from the "
                                 "dense decoder")
    log(f"train -> serve: 4 requests x 16 tokens from the trained table, "
        f"{st['steps']} engine steps, zero step failures, tokens identical "
        "to the dense decoder")


# ------------------------------------------------------------ phase 9
def _flash_bound(kernel, dtype, T, kv_lens, causal=True):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    at 3.35 TB/s and its operations at the dtype's peak. Operations
    count the valid (query, key) pairs of these inputs: the forward
    does two products of 2 d flops a pair (S = QK^T, PV), dq three
    (S, dO V^T, dS K) and dk/dv four (S, dO V^T, P^T dO, dS^T Q)."""
    b, h, d = FLASH_SHAPE
    pairs = sum(min(L, T) * (min(L, T) + 1) // 2 + (T - min(L, T)) * min(L, T)
                if causal else T * L for L in kv_lens) * h
    esize = 2 if dtype == torch.bfloat16 else 4
    tensor = b * T * h * d * esize
    rows = b * h * T * 4                       # one float32 per row
    products, n_tensors, n_rows = {"fwd": (2, 4, 1), "dq": (3, 5, 2),
                                   "dkv": (4, 6, 2)}[kernel]
    flops = products * 2.0 * d * pairs
    t_ops = flops / (BF16_FLOPS_PER_S if esize == 2 else FP32_FLOPS_PER_S)
    t_bytes = (n_tensors * tensor + n_rows * rows + b * 8) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_flash_timings():
    """Each flash kernel's device time per call at the training shapes
    (8 x 1024 tokens, 8 heads, dh 64, causal, full-length rows), bf16
    and f32, by CUDA-graph replay over 6 input sets (one per layer, so
    the inputs do not sit in L2); its bound; the plain version's time;
    and, as a yardstick the port never calls, SDPA (forward for the
    forward kernel, its autograd backward for dq + dk/dv together)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    T = TRAIN["max_len"]
    kv_lens = [T] * FLASH_SHAPE[0]
    lens2 = torch.tensor([[T, T]] * FLASH_SHAPE[0], dtype=torch.int32,
                         device="cuda")
    scale = FLASH_SHAPE[2] ** -0.5
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        sets = []
        for i in range(TRAIN["n_layers"]):
            q, k, v, do = _flash_inputs(T, dtype, seed=90 + i)
            o, lse = fa.flash_forward(q, k, v, lens2, True, scale)
            sets.append((q, k, v, do, lse, fa.rowsum_do_o(do, o)))
        L = len(sets)

        def fwd(i):
            q, k, v = sets[i % L][:3]
            return fa.flash_forward(q, k, v, lens2, True, scale)

        def dq(i):
            return fa.flash_backward_dq(*sets[i % L], lens2, True, scale)

        def dkv(i):
            return fa.flash_backward_dkv(*sets[i % L], lens2, True, scale)

        def fwd_plain(i):
            q, k, v = sets[i % L][:3]
            return (fa.flash_attention_reference(q, k, v, None, lens2[:, 1],
                                                 True, scale),
                    fa.flash_lse_reference(q, k, None, lens2[:, 1], True,
                                           scale))

        def dq_plain(i):
            return fa.flash_dq_reference(*sets[i % L], None, lens2[:, 1],
                                         True, scale)

        def dkv_plain(i):
            return fa.flash_dkv_reference(*sets[i % L], None, lens2[:, 1],
                                          True, scale)

        heads = [[x.transpose(1, 2) for x in s[:4]] for s in sets]

        def sdpa(i):
            q, k, v = heads[i % L][:3]
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        lib_fwd = device_ms(sdpa, iters=12)
        leaves = [[x.detach().requires_grad_() for x in h_[:3]]
                  for h_ in heads]
        outs = [F.scaled_dot_product_attention(*lv, is_causal=True)
                for lv in leaves]

        def sdpa_bwd(i):
            return torch.autograd.grad(outs[i % L], leaves[i % L],
                                       heads[i % L][3], retain_graph=True)

        lib_bwd = event_ms(sdpa_bwd, iters=12)
        for name, kern, plain, lib in (("fwd", fwd, fwd_plain, lib_fwd),
                                       ("dq", dq, dq_plain, lib_bwd),
                                       ("dkv", dkv, dkv_plain, lib_bwd)):
            bound_ms, bound_by = _flash_bound(name, dtype, T, kv_lens)
            out[(name, dtype)] = dict(
                ms=device_ms(kern, iters=12),
                plain_ms=device_ms(plain, iters=3), bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib)
            r = out[(name, dtype)]
            log(f"flash {name} {str(dtype)[6:]} at train shapes: "
                f"{r['ms'] * 1e3:.2f} us/call, bound {bound_ms * 1e3:.3f} "
                f"us ({bound_by}), plain {r['plain_ms'] * 1e3:.2f} us, "
                f"sdpa {'fwd' if name == 'fwd' else 'bwd (dq+dkv)'} "
                f"{lib * 1e3:.2f} us")
        del sets, heads, leaves, outs
    return out


def event_ms(fn, iters):
    """Milliseconds per call between CUDA events around ``iters`` eager
    calls (for work that cannot be captured in a CUDA graph, at sizes
    where the host's issue time hides behind the device)."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ phase 10
def phase_train_trace(trainer, batch, label="train", what="flash kernels",
                      marks=("flash_",)):
    """One train step under torch.profiler: device busy time against
    the wall clock, the top device kernels, and the share of the
    kernels whose names hold one of ``marks`` (phases 10 and 16)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_batch(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA" and ev.self_device_time_total > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + \
                ev.self_device_time_total / 1e3
    busy_ms = sum(by_kernel.values())
    ours_ms = sum(v for k, v in by_kernel.items()
                  if any(m in k for m in marks))
    log(f"{label} trace: 1 step, wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.3f}), {what} "
        f"{ours_ms:.3f} ms ({ours_ms / busy_ms:.3f} of busy)")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"{label} trace top kernel: {ms:.3f} ms  {name[:90]}")


# ------------------------------------------------------------ phase 11
def _ragged_lens(b, T, seed, must=()):
    """Seeded lengths in [1, T] that include each of ``must``."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, size=b)
    lens[:len(must)] = must
    return torch.tensor(lens, dtype=torch.int32, device="cuda")


def _randn(gen, *shape, scale=1.0, dtype=torch.float32):
    """Seeded normal draws made on the card (a numpy draw of the
    full-width streams costs seconds of host time)."""
    return (torch.randn(shape, generator=gen, device="cuda") * scale) \
        .to(dtype)


def _rnn_inputs(b, h, T, gates, dtype, seed):
    """x [b, T, gates*h], w [h, gates*h] in ``dtype``; bias, peep float32.
    Weights at the layer's smart init scale, 1/sqrt(h)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (_randn(gen, b, T, gates * h, scale=0.5, dtype=dtype),
            _randn(gen, h, gates * h, scale=h ** -0.5, dtype=dtype),
            _randn(gen, gates * h, scale=0.1), _randn(gen, 3 * h, scale=0.1))


def _lstm_function_check(x4, lens, w, bias, peep, dtype, seed):
    """dx4, dw, dbias, dpeep of lstm_sequence (the autograd Function: the
    forward and backward kernels plus the contractions) against autograd
    of the plain version in float32 on the same (rounded) values."""
    from paddle_tpu_torch import config
    from paddle_tpu_torch.ops import fused_rnn as fr
    b, T, four_h = x4.shape
    h = four_h // 4
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_out, g_h, g_c = (_randn(gen, *s) for s in ((b, T, h), (b, h), (b, h)))

    def grads(fn, dt):
        leaves = [t.float().clone().requires_grad_() for t in
                  (x4, w, bias, peep)]
        out, hT, cT = fn(*leaves)
        loss = (out.float() * g_out).sum() + (hT * g_h).sum() + \
            (cT * g_c).sum()
        return torch.autograd.grad(loss, leaves)

    config.init(seed=0, compute_dtype="bfloat16" if dtype == torch.bfloat16
                else "float32")
    try:
        got = grads(lambda x, w_, b_, p_: fr.lstm_sequence(x, lens, w_, b_,
                                                           p_), dtype)
    finally:
        config.init(seed=0, compute_dtype="float32")
    want = grads(lambda x, w_, b_, p_: fr.lstm_reference(x, lens, w_, b_, p_),
                 torch.float32)
    torch.cuda.synchronize()
    return {n: _held(n, g, r, dtype) for n, g, r in
            zip(("dx4", "dw", "dbias", "dpeep"), got, want)}


def phase_rnn_vs_plain():
    """The LSTM forward (both modes) and backward kernels and the GRU
    kernel against their plain versions on the same inputs: the LSTM at
    full width (b 128, h 1280, T 128, ragged lengths with 100, 1 and
    128) and at a shape that is a multiple of no tile (b 6, h 48, T 13);
    the GRU at b 64, h 128, T 64, ragged. float32 and bfloat16, the
    tolerances of _held."""
    from paddle_tpu_torch.ops import fused_rnn as fr
    worst = {"lstm_fwd": 0.0, "lstm_bwd": 0.0, "gru_fwd": 0.0}
    lstm_cases = [("b128 h1280 T128", 128, 1280, 128, (100, 1, 128)),
                  ("b6 h48 T13", 6, 48, 13, (13, 1, 7))]
    for ci, (label, b, h, T, must) in enumerate(lstm_cases):
        lens = _ragged_lens(b, T, seed=110 + ci, must=must)
        for dtype in (torch.float32, torch.bfloat16):
            x4, w, bias, peep = _rnn_inputs(b, h, T, 4, dtype, 120 + ci)
            out, hT, cT = fr.lstm_forward(x4, lens, w, bias, peep)
            res = fr.lstm_forward(x4, lens, w, bias, peep, save_res=True)
            torch.cuda.synchronize()
            ref = fr.lstm_reference(x4, lens, w, bias, peep, save_res=True)
            errs = {}
            for name, a, r in (("out", out, ref[0]), ("hT", hT, ref[1]),
                               ("cT", cT, ref[2]), ("out/res", res[0], ref[0]),
                               ("hT/res", res[1], ref[1]),
                               ("cT/res", res[2], ref[2]),
                               ("cseq", res[3], ref[3]),
                               ("gates", res[4], ref[4])):
                errs[name] = _held(name, a, r, dtype)
            gen = torch.Generator(device="cuda").manual_seed(130 + ci)
            d_out = _randn(gen, b, T, h, dtype=dtype)
            dhT, dcT = _randn(gen, b, h), _randn(gen, b, h)
            cseq, gates = res[3], res[4]
            dz = fr.lstm_backward(w, peep, lens, gates, cseq, d_out, dhT, dcT)
            torch.cuda.synchronize()
            dz_ref = fr.lstm_backward_reference(w, peep, lens, gates, cseq,
                                                d_out, dhT, dcT)
            errs["dz"] = _held("dz", dz, dz_ref, dtype)
            errs.update(_lstm_function_check(x4, lens, w, bias, peep, dtype,
                                             140 + ci))
            if dtype == torch.float32:
                worst["lstm_fwd"] = max(worst["lstm_fwd"], *(
                    errs[k] for k in ("out", "hT", "cT", "out/res", "hT/res",
                                      "cT/res", "cseq", "gates")))
                worst["lstm_bwd"] = max(worst["lstm_bwd"], *(
                    errs[k] for k in ("dz", "dx4", "dw", "dbias", "dpeep")))
            log(f"lstm vs plain {label} {str(dtype)[6:]}: " + ", ".join(
                f"{n} {e:.3e}" for n, e in errs.items()))
    b, h, T = 64, 128, 64
    lens = _ragged_lens(b, T, seed=150, must=(64, 1, 33))
    for dtype in (torch.float32, torch.bfloat16):
        x3, w, bias, _ = _rnn_inputs(b, h, T, 3, dtype, 160)
        out, hT = fr.gru_forward(x3, lens, w, bias)
        torch.cuda.synchronize()
        ref_out, ref_hT = fr.gru_reference(x3, lens, w, bias)
        errs = {"out": _held("gru out", out, ref_out, dtype),
                "hT": _held("gru hT", hT, ref_hT, dtype)}
        if dtype == torch.float32:
            worst["gru_fwd"] = max(errs.values())
        log(f"gru vs plain b{b} h{h} T{T} {str(dtype)[6:]}: " + ", ".join(
            f"{n} {e:.3e}" for n, e in errs.items()))
    return worst


# ------------------------------------------------------------ phase 12
# the RNN benchmark bench.py:214-242 trains (benchmark/paddle/rnn/rnn.py
# shape), at its widest row lstm_bs128_h1280
LSTM_NET = dict(vocab_size=30000, emb_size=128, hidden_size=1280,
                lstm_num=1, num_classes=2)
LSTM_PARAMS = 11060482
LSTM_ROWS, LSTM_TOKENS, LSTM_WARMUP, LSTM_STEPS = 128, 100, 2, 8
# bench.py trains this model with Adam(2e-3); at hidden 1280 that rate
# overshoots at the third step on this table and batch and the loss is
# not falling after 10 steps (phase 12 prints it, PERF.md). The step's
# work does not depend on the rate.
LSTM_LR = 5e-4
TAGGER = dict(vocab_size=20000, num_labels=45, emb_size=128, hidden_size=128)
# (name, line of the TPU kernel in ops/pallas_rnn.py, source)
RNN_KERNELS = [("lstm_fwd", 62, "lstm_fwd.cu"), ("lstm_bwd", 121, "lstm_bwd.cu"),
               ("gru_fwd", 371, "gru_fwd.cu")]


def _rnn_counts(fr, zero=False):
    fns = (fr.lstm_forward, fr.lstm_backward, fr.gru_forward)
    if zero:
        for fn in fns:
            fn.launches = 0
        fr.lstm_forward.res_launches = 0
    return {"lstm_fwd": fr.lstm_forward.launches,
            "lstm_res": fr.lstm_forward.res_launches,
            "lstm_bwd": fr.lstm_backward.launches,
            "gru_fwd": fr.gru_forward.launches}


def _lstm_spec(compute_dtype):
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.registry import reset_name_counters
    from paddle_tpu_torch.models import stacked_lstm_net
    config.init(seed=0, compute_dtype=compute_dtype)
    reset_name_counters()
    return stacked_lstm_net(**LSTM_NET)


def _lstm_samples(n, seed, ragged=False):
    """n seeded (word ids, label) samples: LSTM_TOKENS tokens each, or
    1..LSTM_TOKENS with ``ragged``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        L = int(rng.randint(1, LSTM_TOKENS + 1)) if ragged else LSTM_TOKENS
        out.append((rng.randint(0, LSTM_NET["vocab_size"], (L,))
                    .astype(np.int32), int(rng.randint(0, 2))))
    return out


def phase_lstm_train():
    """The sequence slice's main training path: stacked_lstm_net at the
    benchmark's widest row, SGD.train_batch with Adam(LSTM_LR) in
    bfloat16 on one seeded batch of 128 rows of 100 tokens."""
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.ops import fused_rnn as fr
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import SGD, create

    spec = _lstm_spec("bfloat16")
    topo = Topology(spec.cost, extra_outputs=[spec.output])
    params = create(topo, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in params.raw.values())
    if n_params != LSTM_PARAMS:
        raise AssertionError(f"{n_params} parameters, expected {LSTM_PARAMS}")
    trainer = SGD(spec.cost, params, Adam(learning_rate=LSTM_LR))
    batch = _lstm_samples(LSTM_ROWS, seed=0)
    losses = [trainer.train_batch(batch)[0] for _ in range(LSTM_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _rnn_counts(fr, zero=True)
    t0 = time.perf_counter()
    for _ in range(LSTM_STEPS):
        losses.append(trainer.train_batch(batch)[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _rnn_counts(fr)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"LSTM losses not finite and falling: {losses}")
    bad = [k for k, p in params.raw.items()
           if not bool(torch.isfinite(p).all())]
    if bad:
        raise AssertionError(f"non-finite parameters after training: {bad}")
    if not (counts["lstm_fwd"] == counts["lstm_res"] == counts["lstm_bwd"]
            == LSTM_STEPS):
        raise AssertionError(f"LSTM launches {counts} != {LSTM_STEPS} each")
    step_ms = wall / LSTM_STEPS * 1e3
    log(f"lstm train: {n_params} parameters, bf16, {LSTM_STEPS} timed steps "
        f"after {LSTM_WARMUP}: {step_ms:.3f} ms/step, "
        f"{LSTM_ROWS / (step_ms / 1e3):.1f} samples/s, "
        f"{LSTM_ROWS * LSTM_TOKENS / (step_ms / 1e3):.1f} tokens/s, peak "
        f"{peak_gb:.3f} GB; losses {[round(x, 5) for x in losses]}; "
        f"launches {counts}")
    # the record behind LSTM_LR: the benchmark's rate on the same table
    # and batch
    bench = SGD(spec.cost, create(topo, torch.Generator().manual_seed(0)),
                Adam(learning_rate=2e-3))
    log("lstm train at the benchmark's Adam(2e-3), same table and batch: "
        f"losses {[round(bench.train_batch(batch)[0], 5) for _ in range(6)]}")
    return spec, trainer, batch, counts


def phase_lstm_grad_check(batch):
    """float32, full width, one table, the first 16 rows of the train
    batch (the CPU side is the slow one): the gradients of one cost
    through the kernels on the card against the same cost through the
    plain scan of the CPU port; worst per-parameter ||diff|| / ||g|| <=
    1e-3 and the costs within 1e-5 (relative)."""
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.ops import fused_rnn as fr
    from paddle_tpu_torch.trainer import DataFeeder, create

    spec = _lstm_spec("float32")
    topo = Topology(spec.cost)
    table = create(topo, torch.Generator().manual_seed(1), device="cpu").raw

    def grads(device):
        params = {k: v.detach().to(device).requires_grad_()
                  for k, v in table.items()}
        feed = DataFeeder(topo.data_type(), device=device)(batch)
        n_real = feed.pop("__batch_size__")
        outs, _ = topo.forward(params, {}, feed, n_real=n_real)
        cost = outs[spec.cost.name].sum() / n_real
        names = sorted(params)
        g = torch.autograd.grad(cost, [params[k] for k in names])
        return cost.item(), {k: v.detach().cpu() for k, v in zip(names, g)}

    before = _rnn_counts(fr)
    cost_k, g_k = grads("cuda")
    after = _rnn_counts(fr)
    if after["lstm_bwd"] - before["lstm_bwd"] != 1:
        raise AssertionError("the card's gradient did not run the kernels")
    cost_p, g_p = grads("cpu")
    rel = {k: ((g_k[k] - g_p[k]).norm() / g_p[k].norm()).item()
           for k in g_p}
    name, worst = max(rel.items(), key=lambda kv: kv[1])
    log(f"lstm f32 grads at full width over {len(rel)} parameters: cost "
        f"{cost_k:.7f} (kernels, card) vs {cost_p:.7f} (plain, CPU); worst "
        f"||diff||/||g|| {worst:.3e} ({name})")
    if worst > 1e-3 or abs(cost_k - cost_p) > 1e-5 * abs(cost_p):
        raise AssertionError(f"kernel-path gradients off the plain path: "
                             f"{name} {worst} or cost {cost_k} vs {cost_p}")


# ------------------------------------------------------------ phase 13
def phase_lstm_infer(spec, trainer):
    """paddle.infer of the classifier's probabilities over 512 seeded
    ragged samples in batches of 128, float32, from the trained table:
    one forward launch per batch, none with residuals; probabilities
    within 1e-4 of the CPU port's on the same table and samples."""
    from paddle_tpu_torch import config
    from paddle_tpu_torch.ops import fused_rnn as fr
    from paddle_tpu_torch.trainer import Parameters, infer

    config.init(seed=0, compute_dtype="float32")
    samples = [(w,) for w, _ in _lstm_samples(512, seed=13, ragged=True)]
    params = trainer.parameters
    infer(output_layer=spec.output, parameters=params, input=samples[:128],
          batch_size=128)                                      # warm-up
    torch.cuda.synchronize()
    _rnn_counts(fr, zero=True)
    t0 = time.perf_counter()
    probs = infer(output_layer=spec.output, parameters=params, input=samples,
                  batch_size=128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _rnn_counts(fr)
    if counts["lstm_fwd"] != 4 or counts["lstm_res"] or counts["lstm_bwd"]:
        raise AssertionError(f"infer launches {counts}: expected 4 forward "
                             "launches without residuals")
    cpu = Parameters({k: v.detach().cpu() for k, v in params.raw.items()},
                     device="cpu")
    want = infer(output_layer=spec.output, parameters=cpu, input=samples,
                 batch_size=128, device="cpu")
    err = float(np.abs(probs - want).max())
    if probs.shape != (512, LSTM_NET["num_classes"]) or not err <= 1e-4:
        raise AssertionError(f"card probabilities {probs.shape} off the CPU "
                             f"port's by {err}")
    log(f"lstm infer: 512 samples in 4 batches, {wall * 1e3:.3f} ms, "
        f"{512 / wall:.1f} samples/s, launches {counts}, max |p - p_cpu| "
        f"{err:.3e}")
    return counts


# ------------------------------------------------------------ phase 14
def _tagger_sentences(n, seed):
    """n seeded (words, labels) sentences of 8-64 tokens; every group of
    64 holds a 64-token one, so each infer batch pads to 64."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        L = 64 if i % 64 == 0 else int(rng.randint(8, 65))
        out.append((rng.randint(0, TAGGER["vocab_size"], (L,)).astype(np.int32),
                    rng.randint(0, TAGGER["num_labels"], (L,))
                    .astype(np.int32)))
    return out


def phase_tagger():
    """rnn_crf_tagger at its defaults: 3 float32 train steps on 64
    sentences (the plain GRU scans under autograd, no kernel launch),
    then infer of the Viterbi path over 256 sentences in batches of 64:
    one GRU kernel launch per batch (forward direction only), labels
    identical to the CPU port's on the same table."""
    from paddle_tpu_torch import config
    from paddle_tpu_torch.core.registry import reset_name_counters
    from paddle_tpu_torch.core.topology import Topology
    from paddle_tpu_torch.models import rnn_crf_tagger
    from paddle_tpu_torch.ops import fused_rnn as fr
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.trainer import SGD, Parameters, create, infer

    config.init(seed=0, compute_dtype="float32")
    reset_name_counters()
    spec = rnn_crf_tagger(**TAGGER)
    topo = Topology(spec.cost, extra_outputs=[spec.decoded])
    params = create(topo, torch.Generator().manual_seed(2))
    trainer = SGD(spec.cost, params, Adam(learning_rate=2e-3))
    _rnn_counts(fr, zero=True)
    train = _tagger_sentences(64, seed=20)
    losses = [trainer.train_batch(train)[0] for _ in range(3)]
    if not all(np.isfinite(losses)) or _rnn_counts(fr)["gru_fwd"]:
        raise AssertionError(f"tagger training: losses {losses}, GRU kernel "
                             f"launches {_rnn_counts(fr)['gru_fwd']} (the "
                             "training path runs the plain scan)")
    words = [(w,) for w, _ in _tagger_sentences(256, seed=21)]
    infer(output_layer=spec.decoded, parameters=params, input=words[:64],
          batch_size=64)                                       # warm-up
    torch.cuda.synchronize()
    _rnn_counts(fr, zero=True)
    t0 = time.perf_counter()
    paths = infer(output_layer=spec.decoded, parameters=params, input=words,
                  batch_size=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _rnn_counts(fr)
    if counts["gru_fwd"] != 4:
        raise AssertionError(f"GRU kernel launches {counts['gru_fwd']} != 4 "
                             "infer batches")
    cpu = Parameters({k: v.detach().cpu() for k, v in params.raw.items()},
                     device="cpu")
    want = infer(output_layer=spec.decoded, parameters=cpu, input=words,
                 batch_size=64, device="cpu")
    if paths.shape != want.shape or not np.array_equal(paths, want):
        n_diff = int((paths != want).sum()) if paths.shape == want.shape \
            else -1
        raise AssertionError(f"decoded labels differ from the CPU port's "
                             f"({n_diff} positions)")
    log(f"tagger: losses {[round(x, 4) for x in losses]}; infer 256 "
        f"sentences in 4 batches, {wall * 1e3:.3f} ms, {256 / wall:.1f} "
        f"sentences/s, GRU launches {counts['gru_fwd']}, labels identical "
        "to the CPU port's")
    return counts["gru_fwd"]


# ------------------------------------------------------------ phase 15
def _rnn_bound(kind, dtype, b, h, T, lens):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    (each input read once, each output written once) at 3.35 TB/s and
    its products on the valid row-steps at the dtype's peak: the LSTM
    forward 2 * h * 4h flops a row-step (h @ W), the backward the same
    (dz W^T), the GRU 2 * h * 3h (two products)."""
    e = 2 if dtype == torch.bfloat16 else 4
    valid = float(sum(lens))
    lens_b = 4 * b
    if kind == "lstm_fwd":        # the training call, with residuals
        flops = 2.0 * h * 4 * h * valid
        nbytes = (b * T * 4 * h * e + h * 4 * h * e + 7 * h * 4 + lens_b
                  + 2 * b * T * h * e + b * T * 4 * h * e + 2 * b * h * 4)
    elif kind == "lstm_bwd":
        flops = 2.0 * h * 4 * h * valid
        nbytes = (h * 4 * h * e + 3 * h * 4 + lens_b + b * T * 4 * h * e
                  + 2 * b * T * h * e + 2 * b * h * 4 + b * T * 4 * h * e)
    else:
        flops = 2.0 * h * 3 * h * valid
        nbytes = (b * T * 3 * h * e + h * 3 * h * e + 3 * h * 4 + lens_b
                  + b * T * h * 4 + b * h * 4)
    t_ops = flops / (BF16_FLOPS_PER_S if e == 2 else FP32_FLOPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_rnn_timings():
    """Each recurrent kernel's device time per call at the main path's
    shapes — the LSTM at the train batch (b 128, h 1280, T 128 padded,
    every row 100 tokens), the GRU at a tagger infer batch (b 64, h 128,
    T 64, ragged 8-64) — in bfloat16 and float32, by CUDA-graph replay
    (the kernels' cooperative launches capture like any other), its
    bound, its time per run step, and the plain version's time. No
    PyTorch call computes
    these functions (cuDNN's LSTM has no peepholes and no per-row
    freeze, its GRU resets after the product), so library_ms is null."""
    from paddle_tpu_torch.ops import fused_rnn as fr
    out = {}
    shapes = {"lstm": (128, 1280, 128, [LSTM_TOKENS] * 128)}
    glens = [len(w) for w, _ in _tagger_sentences(64, seed=21)]
    shapes["gru"] = (64, 128, 64, glens)
    for dtype in (torch.bfloat16, torch.float32):
        b, h, T, lens = shapes["lstm"]
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        x4, w, bias, peep = _rnn_inputs(b, h, T, 4, dtype, 170)
        _, _, _, cseq, gates = fr.lstm_forward(x4, ln, w, bias, peep,
                                               save_res=True)
        d_out = _randn(torch.Generator(device="cuda").manual_seed(171), b,
                       T, h, dtype=dtype)
        dhT = torch.zeros((b, h), device="cuda")
        calls = {
            "lstm_fwd": (lambda i: fr.lstm_forward(x4, ln, w, bias, peep,
                                                   save_res=True),
                         lambda i: fr.lstm_reference(x4, ln, w, bias, peep,
                                                     save_res=True),
                         shapes["lstm"]),
            "lstm_bwd": (lambda i: fr.lstm_backward(w, peep, ln, gates, cseq,
                                                    d_out, dhT, dhT),
                         lambda i: fr.lstm_backward_reference(
                             w, peep, ln, gates, cseq, d_out, dhT, dhT),
                         shapes["lstm"])}
        gb, gh, gT, glens_ = shapes["gru"]
        gln = torch.tensor(glens_, dtype=torch.int32, device="cuda")
        x3, gw, gbias, _ = _rnn_inputs(gb, gh, gT, 3, dtype, 172)
        calls["gru_fwd"] = (lambda i: fr.gru_forward(x3, gln, gw, gbias),
                            lambda i: fr.gru_reference(x3, gln, gw, gbias),
                            shapes["gru"])
        for name, (kern, plain, (b_, h_, T_, lens_)) in calls.items():
            ms = device_ms(kern, iters=3, reps=3)
            plain_ms = device_ms(plain, iters=1, reps=3)
            bound_ms, bound_by = _rnn_bound(name, dtype, b_, h_, T_, lens_)
            steps = max(lens_)
            out[(name, dtype)] = dict(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=None)
            log(f"{name} {str(dtype)[6:]} at b{b_} h{h_} T{T_} ({steps} run "
                f"steps): {ms * 1e3:.2f} us/call ({ms / steps * 1e3:.2f} "
                f"us/step), bound {bound_ms * 1e3:.3f} us ({bound_by}), "
                f"plain {plain_ms * 1e3:.2f} us")
        # a labelled near-yardstick the port never calls: cuDNN's LSTM
        # layer (no peepholes, no per-row freeze, and its input
        # projection included) forward over the same 128 x 100 steps
        cudnn = torch.nn.LSTM(LSTM_NET["emb_size"], LSTM_NET["hidden_size"],
                              batch_first=True).to("cuda", dtype)
        xe = torch.randn(128, LSTM_TOKENS, LSTM_NET["emb_size"],
                         device="cuda", dtype=dtype)
        with torch.no_grad():
            cudnn_ms = event_ms(lambda i: cudnn(xe), iters=5)
        log(f"near-yardstick torch.nn.LSTM (cuDNN) forward {str(dtype)[6:]} "
            f"b128 T{LSTM_TOKENS} in {LSTM_NET['emb_size']} h"
            f"{LSTM_NET['hidden_size']}: {cudnn_ms * 1e3:.2f} us/call")
        del x4, w, cseq, gates, d_out, x3, gw, cudnn, xe
    return out


# ------------------------------------------------------------ phase 17
def _quant_window_case(h, g, W, dtype, seed):
    """Phase 2's full-width window inputs with int8 pools: the float
    pages quantized on the card, q in ``dtype``; a tenth of the rows
    scaled down, so scales differ across rows."""
    from paddle_tpu_torch.ops import paged_decode as ops
    args, tables, lens = _window_case(h, g, W, torch.float32, seed)
    q, k, v, tb, ln = args
    rows = torch.rand(k.shape[:3], device=k.device) < 0.1
    k = torch.where(rows[..., None], k * 0.01, k)
    kq, ks = ops.quantize_kv(k)
    vq, vs = ops.quantize_kv(v)
    return dict(q=q.to(dtype), kq=kq, vq=vq, ks=ks, vs=vs, tb=tb, ln=ln,
                k=k, v=v), tables, lens


def phase_dequant_vs_plain():
    """Kernel 8 (the int8 path of paged window attention) against its
    plain version at full width: q float32 and bfloat16, h/g 8/8, 8/2,
    8/1, W 1, 3 and 4, ragged lengths straddling pages; NaN scales in
    every page past each slot's used count change nothing; a kv_len-0
    row returns the mean of dequantized V over the used pages; and
    quantize_kv on the card is bit-equal to the CPU port's."""
    from paddle_tpu_torch.ops import paged_decode as ops
    worst = 0.0
    for (h, g) in ((8, 8), (8, 2), (8, 1)):
        for W in (1, 3, 4):
            for dtype in (torch.float32, torch.bfloat16):
                a, tables, lens = _quant_window_case(h, g, W, dtype,
                                                     seed=h * 10 + g + W)
                kw = dict(k_scales=a["ks"], v_scales=a["vs"])
                got = ops.paged_window_attention(a["q"], a["kq"], a["vq"],
                                                 a["tb"], a["ln"], **kw)
                torch.cuda.synchronize()
                want = ops.paged_window_reference(
                    a["q"].float(), a["kq"], a["vq"], a["tb"], a["ln"], **kw)
                err = (got.float() - want).abs().max().item()
                if dtype == torch.float32:
                    torch.testing.assert_close(got, want, **F32_TOL)
                    worst = max(worst, err)
                elif err > BF16_ATOL:
                    raise AssertionError(
                        f"bf16 int8 kernel off by {err} > {BF16_ATOL}")
                # allocated-pages contract: the scales of pages past each
                # slot's used count are never read — poison them
                P = tables.shape[1]
                used = np.clip(-(-lens.max(axis=1) // PAGE), 1, P)
                tail = np.concatenate([tables[s, used[s]:]
                                       for s in range(SLOTS)])
                tail = torch.from_numpy(tail[tail > 0].astype(np.int64))
                ks, vs = a["ks"].clone(), a["vs"].clone()
                ks[tail.cuda()] = float("nan")
                vs[tail.cuda()] = float("nan")
                again = ops.paged_window_attention(
                    a["q"], a["kq"], a["vq"], a["tb"], a["ln"],
                    k_scales=ks, v_scales=vs)
                torch.cuda.synchronize()
                if not torch.equal(again, got):
                    raise AssertionError("int8 kernel read a page or scale "
                                         "past a slot's used count")
                zero_err = _check_zero_len_row_int8(ops, a, tables, lens,
                                                    dtype)
                log(f"int8 kernel vs plain h={h} g={g} W={W} "
                    f"{str(dtype)[6:]}: max_abs_err {err:.3e}, kv_len-0 "
                    f"row {zero_err:.3e}")
    k = torch.randn(SLOTS * 34 + 1, PAGE, 8, 64, device="cuda") * \
        torch.rand(SLOTS * 34 + 1, PAGE, 8, 1, device="cuda") * 10
    gq, gs = ops.quantize_kv(k)
    cq, cs = ops.quantize_kv(k.cpu())
    if not (torch.equal(gq.cpu(), cq) and torch.equal(gs.cpu(), cs)):
        raise AssertionError(
            f"quantize_kv on the card differs from the CPU port's: "
            f"{int((gq.cpu() != cq).sum())} values, "
            f"{int((gs.cpu() != cs).sum())} scales")
    log(f"quantize_kv: {k.numel()} values bit-equal to the CPU port's")
    return worst


def _check_zero_len_row_int8(ops, a, tables, lens, dtype):
    """Window token 0 of slot 2 with kv_len 0: the mean of dequantized
    V over every column of the slot's used pages (the TPU kernel's
    value); the other rows unchanged."""
    s = 2
    lens0 = lens.copy()
    lens0[s, 0] = 0
    ln = torch.from_numpy(lens0).to(a["ln"].device)
    kw = dict(k_scales=a["ks"], v_scales=a["vs"])
    got = ops.paged_window_attention(a["q"], a["kq"], a["vq"], a["tb"], ln,
                                     **kw)
    torch.cuda.synchronize()
    h, g = a["q"].shape[2], a["vq"].shape[2]
    used = min(max(-(-int(lens0[s].max()) // PAGE), 1), tables.shape[1])
    pages = torch.from_numpy(tables[s, :used].astype(np.int64)).cuda()
    vdq = ops.dequantize_kv(a["vq"][pages], a["vs"][pages])
    want = vdq.reshape(-1, g, vdq.shape[-1]).mean(dim=0) \
        .repeat_interleave(h // g, dim=0)
    err = (got[s, 0].float() - want).abs().max().item()
    if err > (F32_TOL["atol"] if dtype == torch.float32 else BF16_ATOL):
        raise AssertionError(f"int8 kv_len-0 row off the mean of V by {err}")
    keep = torch.ones(got.shape[:2], dtype=torch.bool, device=got.device)
    keep[s, 0] = False
    rest = ops.paged_window_reference(a["q"].float(), a["kq"], a["vq"],
                                      a["tb"], ln, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(got[keep], rest[keep], **F32_TOL)
    elif (got[keep].float() - rest[keep]).abs().max() > BF16_ATOL:
        raise AssertionError("an int8 kv_len-0 row changed the other rows")
    return err


# ------------------------------------------------------------ phase 18
DECODE_T = FULL["max_len"]
DECODE_LENS = [544, 1, 17, 100, 255, 256, 0, 513]


def _decode_case(g, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, dh = FULL["n_heads"], 64
    q = torch.randn(SLOTS, h, dh, generator=gen, device="cuda")
    k = torch.randn(SLOTS, g, dh, DECODE_T, generator=gen, device="cuda")
    v = torch.randn(SLOTS, g, dh, DECODE_T, generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _engine_page_view(eng, lens, seed):
    """Tables over the engine's real pools for rows of the given
    lengths: out-of-order pages, null pages past each row's use."""
    k_pool = eng.k_pool["q"] if isinstance(eng.k_pool, dict) else eng.k_pool
    L, n_pages, ps = k_pool.shape[:3]
    P = FULL["max_len"] // ps
    used = -(-np.asarray(lens) // ps)
    rng = np.random.RandomState(seed)
    tables = np.zeros((len(lens), P), np.int32)
    pages = rng.permutation(n_pages - 1) + 1
    at = 0
    for s, u in enumerate(used):
        tables[s, :u] = pages[at:at + u]
        at += u
    return torch.from_numpy(tables).cuda(), \
        torch.tensor(lens, dtype=torch.int32, device="cuda")


def phase_decode_vs_plain(eng):
    """Kernel 9 (dense-cache decode attention) against decode_reference
    at b 8, h 8, g 8/2/1, dh 64, T 544, one shared length and per-row
    lengths (a kv_len-0 row among them), float32 and bfloat16; then the
    op route paged_attention(use_kernel=True) against use_kernel=False
    over the phase 3 engine's pools (layer 0 and 5, float32). Returns
    the worst float32 error; decode_attention.launches counts these
    calls (no engine route reaches the kernel)."""
    from paddle_tpu_torch.ops import paged_decode as ops
    ops.decode_attention.launches = 0
    worst = 0.0
    for g in (8, 2, 1):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _decode_case(g, dtype, seed=180 + g)
            for lens in ([300], DECODE_LENS):
                ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
                got = ops.decode_attention(q, k, v, ln)
                torch.cuda.synchronize()
                want = ops.decode_reference(q.float(), k.float(), v.float(),
                                            ln)
                err = (got.float() - want).abs().max().item()
                if dtype == torch.float32:
                    torch.testing.assert_close(got, want, **F32_TOL)
                    worst = max(worst, err)
                elif err > BF16_ATOL:
                    raise AssertionError(f"bf16 decode kernel off by {err}")
                log(f"decode kernel vs plain g={g} {str(dtype)[6:]} "
                    f"{'shared' if len(lens) == 1 else 'per-row'} lengths: "
                    f"max_abs_err {err:.3e}")
    lens = [len(p) + n for p, n in zip(eng["prompts"][:SLOTS],
                                       eng["news"][:SLOTS])]
    tb, ln = _engine_page_view(eng["eng"], lens, seed=181)
    q = torch.randn(SLOTS, FULL["n_heads"], 64, device="cuda")
    for layer in (0, FULL["n_layers"] - 1):
        kp, vp = eng["eng"].k_pool[layer], eng["eng"].v_pool[layer]
        ker = ops.paged_attention(q, kp, vp, tb, ln, use_kernel=True)
        ein = ops.paged_attention(q, kp, vp, tb, ln)
        torch.cuda.synchronize()
        torch.testing.assert_close(ker, ein, **F32_TOL)
        worst = max(worst, (ker - ein).abs().max().item())
    log(f"paged_attention(use_kernel=True) vs einsum over the engine's "
        f"pages (lens {lens}): held; decode launches "
        f"{ops.decode_attention.launches}")
    return worst, ops.decode_attention.launches


# ------------------------------------------------------------ phase 19
def _serve(eng, prompts, news, timeout=600):
    """Submit every request, run the engine to the end, check each
    finished with its tokens and balanced pages; returns (requests,
    wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, n) for p, n in zip(prompts, news)]
    eng.run(timeout=timeout)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    if st["step_failures"]:
        raise AssertionError(f"{st['step_failures']} step failures: "
                             f"{eng.last_step_error}")
    for i, (r, n) in enumerate(zip(reqs, news)):
        toks = r.get(timeout=1)
        if r.state != "done" or len(toks) != n:
            raise AssertionError(f"request {i}: state {r.state}, "
                                 f"{len(toks)}/{n} tokens")
    acc = eng.page_accounting()
    if acc["leaked"] or acc["free"] + acc["held_by_trie"] != \
            acc["total_usable"] or acc["refs_total"] != \
            acc["held_by_slots"] + acc["held_by_trie"]:
        raise AssertionError(f"page accounting unbalanced: {acc}")
    if eng.spill is not None and acc["spill_puts"] != (
            acc["spill_restores"] + acc["spill_evicted_lru"]
            + acc["spill_dropped_integrity"] + acc["spill_cleared"]
            + acc["spilled"]):
        raise AssertionError(f"spill tier not conserved: {acc}")
    return reqs, wall


def _first_divergence(a, b):
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def phase_int8_engine(serve):
    """The int8 engine at full width: phase 3's 16 requests with
    kv_quant="int8". Kernel 8 launches == steps x 6 and kernel 7 none;
    balanced pages; the first 4 requests' tokens agree (tie rule) with
    the CPU port's int8 engine on the same table, the near-tie
    reference being the CPU int8 paged step's teacher-forced logits.
    Prints how many requests match the float engine token for token."""
    from paddle_tpu_torch.models.decode import (TransformerDecoder,
                                                tokens_agree)
    from paddle_tpu_torch.ops import paged_decode as ops
    from paddle_tpu_torch.params import init_transformer_lm_params
    from paddle_tpu_torch.serving import DecodeEngine

    prompts, news = serve["prompts"], serve["news"]
    kw = dict(num_slots=SLOTS, page_size=PAGE, max_seq_len=FULL["max_len"],
              kv_quant="int8")
    eng = DecodeEngine(serve["dec"], **kw)
    eng.warmup()
    torch.cuda.synchronize()
    ops.paged_window_attention.launches = 0
    ops.paged_window_attention.dequant_launches = 0
    reqs, wall = _serve(eng, prompts, news)
    launches = ops.paged_window_attention.dequant_launches
    float_launches = ops.paged_window_attention.launches
    st = eng.stats()
    if launches != st["steps"] * FULL["n_layers"] or launches == 0 or \
            float_launches:
        raise AssertionError(
            f"int8 launches {launches} (float {float_launches}) != steps "
            f"{st['steps']} x {FULL['n_layers']}")
    cpu_dec = TransformerDecoder(init_transformer_lm_params(FULL, seed=0),
                                 n_layers=FULL["n_layers"],
                                 n_heads=FULL["n_heads"], device="cpu")
    cpu = DecodeEngine(cpu_dec, **kw)
    cpu_reqs = [cpu.submit(p, n) for p, n in zip(prompts[:4], news[:4])]
    cpu.run(timeout=600)
    ref_step = cpu_dec.paged(num_slots=1, page_size=PAGE, num_pages=36,
                             max_pages_per_slot=FULL["max_len"] // PAGE,
                             window=32, kv_quant="int8")
    for i, r in enumerate(cpu_reqs):
        want = r.get(timeout=1)
        p = prompts[i]
        ref = ref_step.prefill_logits(np.concatenate([p, want]))
        tol = TIE_ATOL + TIE_RTOL * float(np.abs(ref).max())
        if not tokens_agree(reqs[i].get(timeout=1), want, ref[len(p) - 1:],
                            tol):
            raise AssertionError(f"int8 request {i}: card tokens differ "
                                 "from the CPU port's int8 engine")
    same = 0
    firsts = []
    for r, fp in zip(reqs, serve["tokens"]):
        j = _first_divergence(r.get(timeout=1), fp)
        same += j is None
        firsts.append(j)
    gen = st["tokens_out"]
    log(f"int8 engine: {N_REQ} requests, {gen} tokens, {st['steps']} "
        f"steps, {wall:.3f} s, {gen / wall:.1f} tokens/s (float engine "
        f"{serve['tokens_per_s']:.1f}), p50 inter-token "
        f"{st['token_latency_p50_ms']} ms, int8 kernel launches {launches}, "
        f"pool {eng.paged.pool_bytes()} bytes (float "
        f"{serve['pool_bytes']}); 4 requests agree with the "
        f"CPU port's int8 engine")
    log(f"int8 vs float engine: {same}/{N_REQ} requests token-identical; "
        f"first divergence per request {firsts} (random-weight logits "
        "are near-flat: a finding, not a gate)")
    return eng, launches


# ------------------------------------------------------------ phase 20
def phase_speculation(serve):
    """Speculative decoding at full width, spec_k 2 (W 3): the
    same-weights draft, then a disagreeing 2-layer draft from another
    seed. Tokens agree with the dense reference (tie rule, first 4
    requests), kernel 7 launches == target steps x 6, same-weights
    tokens per step > 1."""
    from paddle_tpu_torch.models.decode import TransformerDecoder
    from paddle_tpu_torch.ops import paged_decode as ops
    from paddle_tpu_torch.params import init_transformer_lm_params
    from paddle_tpu_torch.serving import DecodeEngine

    small = dict(FULL, n_layers=2)
    drafts = {"same-weights": serve["dec"],
              "disagreeing 2-layer": TransformerDecoder(
                  init_transformer_lm_params(small, seed=1), n_layers=2,
                  n_heads=FULL["n_heads"])}
    out = {}
    for label, draft in drafts.items():
        eng = DecodeEngine(serve["dec"], num_slots=SLOTS, page_size=PAGE,
                           max_seq_len=FULL["max_len"], draft=draft,
                           spec_k=SPEC_K)
        eng.warmup()
        torch.cuda.synchronize()
        ops.paged_window_attention.launches = 0
        reqs, wall = _serve(eng, serve["prompts"], serve["news"])
        st = eng.stats()
        launches = ops.paged_window_attention.launches
        if launches != st["steps"] * FULL["n_layers"]:
            raise AssertionError(f"{label}: kernel 7 launches {launches} != "
                                 f"target steps {st['steps']} x "
                                 f"{FULL['n_layers']}")
        _check_dense(reqs, serve["dense"], f"speculative ({label})")
        per_step = st["tokens_out"] / st["steps"]
        if label == "same-weights" and per_step <= 1.0:
            raise AssertionError(f"same-weights draft: {per_step} tokens "
                                 "per step")
        gen = st["tokens_out"]
        out[label] = dict(tokens_per_s=gen / wall, per_step=per_step)
        log(f"speculation ({label} draft, spec_k {SPEC_K}): {gen} tokens, "
            f"{st['steps']} target steps, {per_step:.3f} tokens/step, "
            f"accepted {st['spec_accepted_tokens']} of "
            f"{st['spec_proposed_tokens']} proposed, {wall:.3f} s, "
            f"{gen / wall:.1f} tokens/s (phase 3: "
            f"{serve['tokens_per_s']:.1f}), kernel 7 launches {launches}")
        del eng
    return out


# ------------------------------------------------------------ phase 21
# 72 usable pages (phase 3 serves with 272): wave B alone fills them,
# so every trie page of wave A has to leave the device
SPILL_PAGES_POOL = 73
SPILL_CAPACITY = 256


def _spill_waves(seed):
    """Two waves of 8 prompts: within a wave the prompts share a
    32-token (two-page) prefix and differ after it; wave A 64 tokens
    (+16 new: 5 pages a request), wave B 96 tokens (+48 new: 9 pages
    a request, 72 in all — every cold page of A spills host-ward);
    wave C then revisits A's prompts."""
    rng = np.random.RandomState(seed)
    waves = []
    for length in (64, 96):
        shared = rng.randint(0, FULL["vocab_size"], 32)
        waves.append([np.concatenate([shared, rng.randint(
            0, FULL["vocab_size"], length - 32)]).astype(np.int32)
            for _ in range(SLOTS)])
    return waves


def phase_two_tier(serve):
    """int8 pages + host spill + speculation at full width on a pool
    cut to 72 pages with a 256-page spill store: wave A, wave B (cold
    A pages spill host-ward), wave C revisits A (spilled pages restore
    before prefill). spills > 0, restores > 0, revisit tokens equal
    first-visit tokens, both tiers balance. Returns the engine (phase
    22 traces it)."""
    from paddle_tpu_torch.serving import DecodeEngine
    eng = DecodeEngine(serve["dec"], num_slots=SLOTS, page_size=PAGE,
                       max_seq_len=FULL["max_len"],
                       num_pages=SPILL_PAGES_POOL, kv_quant="int8",
                       kv_spill_pages=SPILL_CAPACITY, draft=serve["dec"],
                       spec_k=SPEC_K)
    eng.warmup()
    wave_a, wave_b = _spill_waves(seed=210)
    first, wall_a = _serve(eng, wave_a, [16] * SLOTS)
    _, wall_b = _serve(eng, wave_b, [48] * SLOTS)
    spilled = eng.stats()["kv_pages_spilled"]
    again, wall_c = _serve(eng, wave_a, [16] * SLOTS)
    st = eng.stats()
    acc = eng.page_accounting()
    if not (spilled > 0 and st["kv_pages_restored"] > 0):
        raise AssertionError(f"no spill round trip: spilled {spilled}, "
                             f"restored {st['kv_pages_restored']}")
    for i, (a, b) in enumerate(zip(first, again)):
        if a.get(timeout=1) != b.get(timeout=1):
            raise AssertionError(f"revisit {i}: tokens differ from the "
                                 "first visit")
    hits = sum(r.prefix_hit_pages for r in again)
    log(f"two-tier: pool {SPILL_PAGES_POOL - 1} pages + spill "
        f"{SPILL_CAPACITY}, int8, spec_k {SPEC_K}: spilled "
        f"{st['kv_pages_spilled']}, restored {st['kv_pages_restored']}, "
        f"integrity drops {st['kv_spill_integrity_drops']}, revisit prefix "
        f"hit pages {hits}; waves {wall_a:.3f} / {wall_b:.3f} / "
        f"{wall_c:.3f} s; revisit tokens identical; accounting {acc}")
    return eng


# ------------------------------------------------------------ phase 22
def _int8_timing(int8_eng, tb, lens, W, dtype):
    """Kernel 8 at the int8 engine's shapes (the phase 19 pools, the
    first 8 requests at their final lengths, W tokens, q of ``dtype``):
    device time per call by CUDA-graph replay, its byte bound, the
    plain version's time, and SDPA on the dequantized view."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import paged_decode as ops
    k_pool, v_pool = int8_eng.k_pool, int8_eng.v_pool
    L, n_pages, ps, g, dh = k_pool["q"].shape
    h = FULL["n_heads"]
    used = -(-lens // ps)
    ln = torch.from_numpy(np.maximum(
        lens[:, None] - W + 1 + np.arange(W)[None, :], 1)
        .astype(np.int32)).cuda()
    q = torch.randn(SLOTS, W, h, dh, device="cuda").to(dtype)
    layers = [(k_pool["q"][i], v_pool["q"][i], k_pool["s"][i],
               v_pool["s"][i]) for i in range(L)]

    def kernel(i):
        kq, vq, ks, vs = layers[i % L]
        return ops.paged_window_attention(q, kq, vq, tb, ln,
                                          k_scales=ks, v_scales=vs)

    def plain(i):
        kq, vq, ks, vs = layers[i % L]
        return ops.paged_window_reference(q, kq, vq, tb, ln,
                                          k_scales=ks, v_scales=vs)

    ms = device_ms(kernel, iters=60)
    plain_ms = device_ms(plain, iters=12)
    # yardstick: SDPA on the dequantized gathered view, in q's dtype
    kg = [ops.dequantize_kv(ops.gather_pages(kq, tb),
                            ops.gather_scales(ks, tb), dtype)
          .permute(0, 2, 1, 3) for kq, _, ks, _ in layers]
    vg = [ops.dequantize_kv(ops.gather_pages(vq, tb),
                            ops.gather_scales(vs, tb), dtype)
          .permute(0, 2, 1, 3) for _, vq, _, vs in layers]
    T = tb.shape[1] * ps
    mask = (torch.arange(T, device="cuda")[None, None, :]
            < ln[:, :, None])[:, None]            # [S, 1, W, T]
    qs = q.permute(0, 2, 1, 3)
    gqa = {} if g == h else {"enable_gqa": True}

    def sdpa(i):
        return F.scaled_dot_product_attention(
            qs, kg[i % L], vg[i % L], attn_mask=mask, **gqa)

    got, want = sdpa(0).permute(0, 2, 1, 3), plain(0)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32_TOL)
    elif (got.float() - want.float()).abs().max().item() > BF16_ATOL:
        raise AssertionError("bf16 SDPA yardstick off the int8 plain path")
    library_ms = device_ms(sdpa, iters=60)
    kv_bytes = 2 * int(used.sum()) * ps * g * (dh + 4)
    io_bytes = 2 * q.numel() * q.element_size() + tb.numel() * 4 + \
        ln.numel() * 4
    flops = 4.0 * float(ln.sum().item()) * h * dh
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOPS_PER_S if dtype == torch.bfloat16
                     else FP32_FLOPS_PER_S) * 1e3
    log(f"int8 kernel at engine shapes W={W} {str(dtype)[6:]} q (lens "
        f"{lens.tolist()}): {ms * 1e3:.2f} us/call, bound "
        f"{max(t_bytes, t_ops) * 1e3:.3f} us ({kv_bytes + io_bytes} "
        f"bytes), plain {plain_ms * 1e3:.2f} us, sdpa on the dequantized "
        f"view {library_ms * 1e3:.2f} us")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _decode_bound(g, dtype, lens):
    """(bound_ms, bound_by) of kernel 9 on this run's lengths: a row
    with kv_len > 0 needs its first kv_len columns of K and V (later
    columns weigh exactly 0); a kv_len-0 row needs all T of V (its
    output is their mean) and no K. Plus q, out and the lengths."""
    h, dh, e = FULL["n_heads"], 64, torch.finfo(dtype).bits // 8
    live = [min(int(n), DECODE_T) if n > 0 else 0 for n in lens]
    vcols = [n if n > 0 else DECODE_T for n in live]
    nbytes = (sum(live) + sum(vcols)) * g * dh * e + \
        2 * SLOTS * h * dh * e + len(lens) * 4
    flops = 2.0 * h * dh * (sum(live) + sum(vcols))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOPS_PER_S if e == 2 else FP32_FLOPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations", nbytes


def _decode_timing(lens, dtype):
    """Kernel 9 at b 8, h 8, g 8, dh 64, T 544 with the given per-row
    lengths, q and cache of ``dtype``: device time per call by
    CUDA-graph replay, its bound, the plain version's time, and SDPA
    on [b, h, 1, T]."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import paged_decode as ops
    g9 = FULL["n_heads"]
    sets = [_decode_case(g9, dtype, seed=230 + i) for i in range(6)]
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")

    def dkernel(i):
        q, k, v = sets[i % 6]
        return ops.decode_attention(q, k, v, ln)

    def dplain(i):
        q, k, v = sets[i % 6]
        return ops.decode_reference(q, k, v, ln)

    ms = device_ms(dkernel, iters=60)
    plain_ms = device_ms(dplain, iters=12)
    sq = [q[:, :, None, :] for q, _, _ in sets]           # [b, h, 1, dh]
    sk = [k.transpose(2, 3) for _, k, _ in sets]           # [b, g, T, dh]
    sv = [v.transpose(2, 3) for _, _, v in sets]
    dmask = (torch.arange(DECODE_T, device="cuda")[None, :]
             < ln[:, None])[:, None, None, :]

    def dsdpa(i):
        return F.scaled_dot_product_attention(sq[i % 6], sk[i % 6],
                                              sv[i % 6], attn_mask=dmask)

    got, want = dsdpa(0)[:, :, 0], dplain(0)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32_TOL)
    elif (got.float() - want.float()).abs().max().item() > BF16_ATOL:
        raise AssertionError("bf16 SDPA yardstick off the decode plain path")
    library_ms = device_ms(dsdpa, iters=60)
    bound_ms, bound_by, nbytes = _decode_bound(g9, dtype, lens)
    log(f"decode kernel at b{SLOTS} h{FULL['n_heads']} g{g9} dh64 "
        f"T{DECODE_T} {str(dtype)[6:]} (lens {list(lens)}): "
        f"{ms * 1e3:.2f} us/call, bound {bound_ms * 1e3:.3f} us "
        f"({bound_by}, {nbytes} bytes), plain {plain_ms * 1e3:.2f} us, "
        f"sdpa {library_ms * 1e3:.2f} us")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_two_tier_timings(int8_eng, serve):
    """Kernel 8 at the int8 engine's shapes (W 1 and W 3) and kernel 9
    at b 8, h 8, g 8, dh 64, T 544 over the same 8 lengths, each with
    float32 and bfloat16 q (kernel 9's cache in q's dtype); keyed by
    (kernel, W or None, dtype)."""
    lens = np.array([len(p) + n for p, n in
                     zip(serve["prompts"][:SLOTS], serve["news"][:SLOTS])],
                    np.int32)
    tb, _ = _engine_page_view(int8_eng, lens, seed=220)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for W in (1, SPEC_K + 1):
            out[("int8", W, dtype)] = _int8_timing(int8_eng, tb, lens, W,
                                                   dtype)
        out[("decode", None, dtype)] = _decode_timing(lens.tolist(), dtype)
    return out


def phase_two_tier_trace(eng):
    """8 fresh requests through the int8 + speculative (+ spill)
    engine under torch.profiler: device busy against the wall clock,
    the top device ops, the int8 kernel's share."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(222)
    steps0 = eng.stats()["steps"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reqs = [eng.submit(rng.randint(0, FULL["vocab_size"], (32,)), 16)
                for _ in range(SLOTS)]
        eng.run(timeout=600)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for r in reqs:
        r.get(timeout=1)
    steps = eng.stats()["steps"] - steps0
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA" and ev.self_device_time_total > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + \
                ev.self_device_time_total / 1e3
    busy_ms = sum(by_kernel.values())
    int8_ms = sum(v for k, v in by_kernel.items() if "paged_window" in k)
    log(f"two-tier trace: {steps} target steps, wall {wall_ms:.3f} ms "
        f"({wall_ms / steps:.3f} ms/step), device busy {busy_ms:.3f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f}), paged window kernel "
        f"{int8_ms:.3f} ms")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"two-tier trace top op: {ms:.3f} ms  {name[:90]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  (fails outside the checkout)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    log(f"card: {nvidia_smi_line()}")
    phase_build()
    max_err = phase_kernel_vs_plain()
    serve = phase_engine()
    eng, prompts, news = serve["eng"], serve["prompts"], serve["news"]
    launches = serve["launches"]
    timing = phase_timings(eng, prompts, news)
    phase_trace(eng)
    flash_err = phase_flash_vs_plain()
    trainer, batch, flash_launches = phase_train()
    phase_train_trace(trainer, batch)      # still in bfloat16
    phase_flash_grad_check(batch)          # switches to float32
    phase_train_to_serve(trainer)
    flash_timing = phase_flash_timings()
    rnn_err = phase_rnn_vs_plain()
    lstm_spec, lstm_trainer, lstm_batch, lstm_counts = phase_lstm_train()
    # phase 16, still in bfloat16
    phase_train_trace(lstm_trainer, lstm_batch, "lstm train", "LSTM kernels",
                      ("lstm_fwd_kernel", "lstm_bwd_kernel"))
    phase_lstm_grad_check(lstm_batch[:16])             # float32
    phase_lstm_infer(lstm_spec, lstm_trainer)
    del lstm_trainer
    gru_launches = phase_tagger()
    rnn_timing = phase_rnn_timings()
    dequant_err = phase_dequant_vs_plain()
    decode_err, decode_launches = phase_decode_vs_plain(serve)
    del serve["eng"], eng
    int8_eng, dequant_launches = phase_int8_engine(serve)
    phase_speculation(serve)
    two_tier = phase_two_tier(serve)
    tt_timing = phase_two_tier_timings(int8_eng, serve)
    phase_two_tier_trace(two_tier)
    del int8_eng, two_tier
    kernels = [dict(
        name="paged_window_attention", route="cuda",
        source="paddle_tpu_torch/csrc/paged_window_attention.cu",
        replaces="paddle_tpu/ops/pallas_decode.py:257",
        launches=launches, max_abs_err=max_err, **timing)]
    for (name, line, src), n in zip(FLASH_KERNELS, flash_launches):
        kernels.append(dict(
            name=f"flash_attention_{name}", route="cuda",
            source=f"paddle_tpu_torch/csrc/{src}",
            replaces=f"paddle_tpu/ops/pallas_attention.py:{line}",
            launches=n, max_abs_err=flash_err[name],
            **flash_timing[(name, torch.bfloat16)]))
    rnn_launches = {"lstm_fwd": lstm_counts["lstm_fwd"],
                    "lstm_bwd": lstm_counts["lstm_bwd"],
                    "gru_fwd": gru_launches}
    for name, line, src in RNN_KERNELS:
        # the LSTM trains in bfloat16 on its main path, the tagger decodes
        # in float32
        dt = torch.float32 if name == "gru_fwd" else torch.bfloat16
        kernels.append(dict(
            name=name, route="cuda", source=f"paddle_tpu_torch/csrc/{src}",
            replaces=f"paddle_tpu/ops/pallas_rnn.py:{line}",
            launches=rnn_launches[name], max_abs_err=rnn_err[name],
            **rnn_timing[(name, dt)]))
    kernels.append(dict(
        name="paged_window_attention_int8", route="cuda",
        source="paddle_tpu_torch/csrc/paged_window_attention.cu",
        replaces="paddle_tpu/ops/pallas_decode.py:322",
        launches=dequant_launches, max_abs_err=dequant_err,
        **tt_timing[("int8", 1, torch.float32)]))
    kernels.append(dict(
        name="decode_attention", route="cuda",
        source="paddle_tpu_torch/csrc/decode_attention.cu",
        replaces="paddle_tpu/ops/pallas_decode.py:112",
        launches=decode_launches, max_abs_err=decode_err,
        **tt_timing[("decode", None, torch.float32)]))
    bad = [k["name"] for k in kernels if k["launches"] < 1]
    if bad:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{bad}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
