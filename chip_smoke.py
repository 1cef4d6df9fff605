#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds and serves.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. build — compile every hand-written kernel of the serving path from
   the sources in this checkout (nvcc, sm_90a), print the ptxas report.
2. kernel vs plain — paged window attention at full width (dh 64,
   page 16, 8 slots, 34 pages a slot, lengths up to 544), h/g in
   {8/8, 8/2, 8/1}, W in {1, 4}, float32 and bfloat16, against the
   plain PyTorch version on the same inputs: rtol 2e-4 / atol 2e-5 in
   float32 (the JAX package's bound for its kernel against its
   einsum), atol 2e-2 in bfloat16 (bf16 output rounding); and the
   allocated-pages contract — NaN written into every page past each
   slot's used count changes nothing.
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

Prints the kernel table as one JSON line, the card's name and power
limit (nvidia-smi), and last {"ok": true, "device": {...}}.
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
F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_ATOL = 2e-2
TIE_RTOL, TIE_ATOL = 1e-4, 1e-5    # the logits tolerance of the tests


def log(msg):
    print(msg, flush=True)


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
                    f"{str(dtype)[6:]}: max_abs_err {err:.3e}")
    return worst


# ------------------------------------------------------------ phase 3
def phase_engine():
    from paddle_tpu_torch.models.decode import (TransformerDecoder,
                                                tokens_agree)
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
    t0 = time.perf_counter()
    reqs = [eng.submit(p, n) for p, n in zip(prompts, news)]
    eng.run(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.paged_window_attention.launches
    st = eng.stats()
    if st["step_failures"]:
        raise AssertionError(f"{st['step_failures']} step failures: "
                             f"{eng.last_step_error}")
    for i, (r, n) in enumerate(zip(reqs, news)):
        toks = r.get(timeout=1)
        if r.state != "done" or len(toks) != n:
            raise AssertionError(f"request {i}: state {r.state}, "
                                 f"{len(toks)}/{n} tokens")
        if not all(0 <= t < FULL["vocab_size"] for t in toks):
            raise AssertionError(f"request {i}: token out of range")
    if launches != st["steps"] * FULL["n_layers"] or launches == 0:
        raise AssertionError(f"kernel launches {launches} != steps "
                             f"{st['steps']} x {FULL['n_layers']}")
    acc = eng.page_accounting()
    if acc["leaked"] or acc["free"] + acc["held_by_trie"] != \
            acc["total_usable"] or acc["refs_total"] != \
            acc["held_by_slots"] + acc["held_by_trie"]:
        raise AssertionError(f"page accounting unbalanced: {acc}")
    for i in range(4):
        p = prompts[i]
        want = dec.generate(p[None, :], max_len=len(p) + news[i])[0]
        ref = dec.prefill_logits(np.concatenate([p, want])[None, :])[0]
        tol = TIE_ATOL + TIE_RTOL * float(np.abs(ref).max())
        if not tokens_agree(reqs[i].get(timeout=1), want,
                            ref[len(p) - 1:], tol):
            raise AssertionError(f"request {i}: engine tokens differ "
                                 "from the dense reference")
    gen = st["tokens_out"]
    log(f"engine: {N_REQ} requests, {gen} tokens, {st['steps']} steps, "
        f"{wall:.3f} s, {gen / wall:.1f} tokens/s, p50 inter-token "
        f"{st['token_latency_p50_ms']} ms, p99 "
        f"{st['token_latency_p99_ms']} ms, kernel launches {launches}, "
        f"prefix hit pages {st['prefix_hit_pages']}")
    return eng, prompts, news, launches


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
    eng, prompts, news, launches = phase_engine()
    timing = phase_timings(eng, prompts, news)
    phase_trace(eng)
    kernels = [dict(
        name="paged_window_attention", route="cuda",
        source="paddle_tpu_torch/csrc/paged_window_attention.cu",
        replaces="paddle_tpu/ops/pallas_decode.py:257",
        launches=launches, max_abs_err=max_err, **timing)]
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
