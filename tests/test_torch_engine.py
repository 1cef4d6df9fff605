"""Port parity: paddle_tpu_torch/serving/engine.py (+ prefix.py) on the
CPU against the JAX package's dense ``TransformerDecoder.generate``.

The acceptance suite of tests/test_paged_decode.py, run through the
port's continuous-batching engine: greedy paged decode must be
token-identical to the reference on ragged batches that straddle page
boundaries, under GQA/MQA, through preemption by an undersized pool,
and through shared-prefix reuse with copy-on-write — with the page
accounting balanced afterwards. Tie rule (``tokens_agree``): a
mismatch fails unless the reference's best two logits at that
position are within the logits tolerance.
"""

import numpy as np
import pytest

import jax
import paddle_tpu as paddle
from paddle_tpu import models

from paddle_tpu_torch.models import decode as pt_decode
from paddle_tpu_torch.serving import DecodeEngine, PagePool, Rejected

CFG = dict(vocab_size=40, d_model=16, n_heads=2, n_layers=2, d_ff=32,
           max_len=32)
TIE_TOL = 1e-4


def _pair(seed=7, **overrides):
    paddle.init(use_tpu=False, seed=0)
    from paddle_tpu.core.registry import reset_name_counters
    reset_name_counters()
    spec = models.transformer_lm(**{**CFG, **overrides})
    costs = spec.cost if isinstance(spec.cost, list) else [spec.cost]
    topo = paddle.Topology(costs, extra_outputs=[spec.output])
    params = topo.init_params(jax.random.PRNGKey(seed))
    jdec = models.TransformerDecoder(params, n_layers=CFG["n_layers"],
                                     n_heads=CFG["n_heads"])
    tdec = pt_decode.TransformerDecoder(
        {k: np.asarray(v) for k, v in params.items()},
        n_layers=CFG["n_layers"], n_heads=CFG["n_heads"], device="cpu")
    return jdec, tdec


def _ragged(rng, n, lo=3, hi=9):
    return [rng.randint(0, CFG["vocab_size"],
                        (int(rng.randint(lo, hi)),)).astype("int32")
            for _ in range(n)]


def _assert_identical(tdec, jdec, reqs, prompts, max_news):
    """Each request's tokens against the JAX dense decoder, one request
    at a time, under the tie rule."""
    for i, (r, p, mn) in enumerate(zip(reqs, prompts, max_news)):
        want = jdec.generate(p[None, :], max_len=len(p) + mn)[0]
        got = r.get(timeout=1)
        ref = tdec.prefill_logits(np.concatenate([p, want])[None, :])[0]
        assert pt_decode.tokens_agree(got, want, ref[len(p) - 1:],
                                      TIE_TOL), (i, got, want)


def _balanced(eng):
    """Zero leaks, zero refcount drift (tests/test_paged_decode.py
    ``_balanced``): with the prefix cache on, a drained engine parks
    finished pages in the trie."""
    acc = eng.page_accounting()
    assert acc["leaked"] == 0
    assert acc["free"] + acc["held_by_trie"] == acc["total_usable"]
    assert acc["refs_total"] == acc["held_by_slots"] + acc["held_by_trie"]
    return acc


def test_ragged_batch_token_identical():
    jdec, tdec = _pair()
    rng = np.random.RandomState(0)
    prompts = _ragged(rng, 6, lo=3, hi=9)
    max_news = [int(rng.randint(4, 12)) for _ in prompts]
    eng = DecodeEngine(tdec, num_slots=3, page_size=4,
                       max_seq_len=CFG["max_len"])
    reqs = [eng.submit(p, mn) for p, mn in zip(prompts, max_news)]
    eng.run(timeout=120)
    _assert_identical(tdec, jdec, reqs, prompts, max_news)
    _balanced(eng)
    st = eng.stats()
    assert st["finished"] == len(prompts)
    assert st["tokens_out"] == sum(max_news)
    assert st["step_failures"] == 0


def test_mqa_token_identical():
    jdec, tdec = _pair(seed=3, n_kv_heads=1)
    assert tdec.kv_heads == 1
    rng = np.random.RandomState(1)
    prompts = _ragged(rng, 4, lo=3, hi=8)
    max_news = [6, 9, 5, 8]
    eng = DecodeEngine(tdec, num_slots=4, page_size=4,
                       max_seq_len=CFG["max_len"])
    reqs = [eng.submit(p, mn) for p, mn in zip(prompts, max_news)]
    eng.run(timeout=120)
    _assert_identical(tdec, jdec, reqs, prompts, max_news)
    _balanced(eng)


def test_preemption_under_tiny_pool_is_output_invariant():
    """Each request needs 5 pages; 7 usable forces a preemption. The
    evicted request replays prompt + generated tokens on re-admission
    and both outputs stay identical to the reference."""
    jdec, tdec = _pair()
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 40, (5,)).astype("int32"),
               rng.randint(0, 40, (6,)).astype("int32")]
    eng = DecodeEngine(tdec, num_slots=2, page_size=4,
                       max_seq_len=CFG["max_len"], num_pages=8)
    reqs = [eng.submit(p, 12) for p in prompts]
    eng.run(timeout=120)
    _assert_identical(tdec, jdec, reqs, prompts, [12, 12])
    st = eng.stats()
    assert st["preemptions"] >= 1
    assert sum(r.evictions for r in reqs) == st["preemptions"]
    _balanced(eng)


def test_prefix_hit_on_same_prompt_resubmit():
    jdec, tdec = _pair()
    prompt = np.random.RandomState(8).randint(0, 40, (13,)).astype("int32")
    eng = DecodeEngine(tdec, num_slots=2, page_size=4,
                       max_seq_len=CFG["max_len"])
    cold = eng.submit(prompt, 5)
    eng.run(timeout=60)
    steps_cold = eng.stats()["steps"]
    warm = eng.submit(prompt, 5)
    eng.run(timeout=60)
    assert cold.prefix_hit_pages == 0
    assert warm.prefix_hit_pages >= 1
    assert eng.stats()["steps"] - steps_cold < steps_cold
    assert warm.get(timeout=1) == cold.get(timeout=1)
    _assert_identical(tdec, jdec, [cold, warm], [prompt, prompt], [5, 5])
    _balanced(eng)


def test_page_straddling_divergence_cow_identity():
    jdec, tdec = _pair()
    rng = np.random.RandomState(9)
    shared = rng.randint(0, 40, (6,)).astype("int32")
    a = np.concatenate([shared, rng.randint(0, 40, (4,))]).astype("int32")
    b = np.concatenate([shared, rng.randint(0, 40, (4,))]).astype("int32")
    b[6] = (a[6] + 1) % 40          # diverge mid-page-1
    eng = DecodeEngine(tdec, num_slots=1, page_size=4,
                       max_seq_len=CFG["max_len"])
    ra = eng.submit(a, 6)
    eng.run(timeout=60)
    rb = eng.submit(b, 6)
    eng.run(timeout=60)
    _assert_identical(tdec, jdec, [ra, rb], [a, b], [6, 6])
    assert rb.prefix_hit_pages >= 1
    assert eng.stats()["prefix_cow_copies"] >= 1
    _balanced(eng)


def test_eos_frees_slot_early():
    jdec, tdec = _pair()
    prompt = np.zeros((2,), "int32")
    dense = jdec.generate(prompt[None, :], max_len=14)[0]
    eos = dense[1] if len(set(dense)) > 1 else dense[0]
    want = jdec.generate(prompt[None, :], max_len=14, eos_id=int(eos))[0]
    eng = DecodeEngine(tdec, num_slots=2, page_size=4,
                       max_seq_len=CFG["max_len"])
    req = eng.submit(prompt, 12, eos_id=int(eos))
    eng.run(timeout=60)
    assert req.get(timeout=1) == [int(t) for t in want]
    _balanced(eng)


def test_prefix_cache_off_frees_everything():
    _, tdec = _pair()
    eng = DecodeEngine(tdec, num_slots=1, page_size=4, max_seq_len=16,
                       prefix_cache=False)
    for _ in range(2):
        r = eng.submit(np.zeros((5,), "int32"), 4)
        eng.run(timeout=60)
        assert len(r.get(timeout=1)) == 4
    acc = eng.page_accounting()
    assert acc["held_by_trie"] == 0
    assert acc["free"] == acc["total_usable"]


def test_admission_rejects_never_satisfiable_and_bounds_queue():
    _, tdec = _pair()
    eng = DecodeEngine(tdec, num_slots=1, page_size=4, max_seq_len=16,
                       max_waiting=2)
    with pytest.raises(Rejected) as ei:
        eng.submit(np.zeros((8,), "int32"), 20)        # 28 > 16
    assert ei.value.reason == "kv_capacity"
    reqs = [eng.submit(np.zeros((3,), "int32"), 2) for _ in range(2)]
    with pytest.raises(Rejected) as ei:
        eng.submit(np.zeros((3,), "int32"), 2)
    assert ei.value.reason == "queue_full" and ei.value.retry_after > 0
    eng.run(timeout=60)
    assert all(len(r.get(timeout=1)) == 2 for r in reqs)
    st = eng.stats()
    assert st["rejected_capacity"] == 1 and st["rejected_queue"] == 1


def test_cancel_and_threaded_loop():
    """Serving mode: the pt-serve-decode thread drives the engine; a
    cancelled request settles with what it had and frees its pages."""
    _, tdec = _pair()
    eng = DecodeEngine(tdec, num_slots=2, page_size=4,
                       max_seq_len=CFG["max_len"]).start()
    try:
        keep = eng.submit(np.arange(4, dtype="int32"), 6)
        gone = eng.submit(np.arange(5, dtype="int32"), 20)
        gone.cancel()
        assert len(keep.get(timeout=30)) == 6
        gone.get(timeout=30)
        assert gone.state == "cancelled"
    finally:
        eng.shutdown(drain=True, timeout=30)
    _balanced(eng)


def test_page_pool_refcounts():
    pool = PagePool(5)
    p = pool.alloc()
    pool.ref(p)
    assert pool.refcount(p) == 2 and pool.shared_pages == 1
    pool.free([p, p])
    assert pool.free_pages == pool.usable
    with pytest.raises(ValueError):
        pool.free([p])


def test_unported_engine_options_raise():
    """What the engine still refuses: a KV quantization other than
    int8. (Beam search and MoE tables are ported: the decoder runs
    both.)"""
    _, tdec = _pair()
    with pytest.raises(ValueError, match="kv_quant"):
        DecodeEngine(tdec, kv_quant="fp8")
