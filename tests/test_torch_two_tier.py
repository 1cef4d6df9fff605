"""Port parity for the two-tier KV plane on the CPU: int8 pages
(paddle_tpu_torch/ops/paged_decode.py quantize/dequantize, the int8
window path, the dense decode path and their kernel gates;
models/decode.py ``PagedDecoder(kv_quant="int8")`` and its page copy /
read / write) and the host spill tier (serving/spill.py, the engine's
spill and restore routes) against the JAX package.

Inputs are made with numpy from fixed seeds and fed to both packages.
Where the JAX function reaches a Pallas kernel it runs in interpret
mode, as the JAX package's own tests run it. Tolerances:

- quantization: bit-equal (a pure per-row function in float32);
- int8 window attention against JAX's dequantizing gather path and its
  interpret-mode dequant kernel: rtol 2e-4 / atol 2e-5 (the JAX
  package's bound for its kernel against its einsum,
  tests/test_paged_decode.py), and against the exact float32 attention
  over the pre-quantization pages: the pinned INT8_KV_RTOL/ATOL;
- dense decode attention against JAX's interpret-mode kernel: rtol
  2e-5 / atol 2e-6 (the same exp2 arithmetic, summed in another
  order), and against the paged einsum path: rtol 2e-4 / atol 2e-5;
- engines: greedy tokens identical (the decoders' logits agree within
  rtol 1e-4, tests/test_torch_decode.py), spill and restore counters
  equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import torch
from paddle_tpu import models
from paddle_tpu.ops import pallas_decode as jax_ops
from paddle_tpu.serving.engine import DecodeEngine as JaxEngine

from paddle_tpu_torch.models import decode as pt_decode
from paddle_tpu_torch.ops import paged_decode as pt_ops
from paddle_tpu_torch.serving import DecodeEngine
from paddle_tpu_torch.serving.spill import (SpillEntry, SpillStore,
                                            entry_checksum)
from tests.test_torch_paged_decode import (CHUNKS, chunked_window_reference,
                                           plan_for)

CFG = dict(vocab_size=40, d_model=16, n_heads=2, n_layers=2, d_ff=32,
           max_len=32)
KERNEL_TOL = dict(rtol=2e-4, atol=2e-5)
INTERPRET_DECODE_TOL = dict(rtol=2e-5, atol=2e-6)


def _pair(seed=7, **overrides):
    paddle.init(use_tpu=False, seed=0)
    from paddle_tpu.core.registry import reset_name_counters
    reset_name_counters()
    spec = models.transformer_lm(**{**CFG, **overrides})
    costs = spec.cost if isinstance(spec.cost, list) else [spec.cost]
    topo = paddle.Topology(costs, extra_outputs=[spec.output])
    params = topo.init_params(jax.random.PRNGKey(seed))
    n_heads = overrides.get("n_heads", CFG["n_heads"])
    jdec = models.TransformerDecoder(params, n_layers=CFG["n_layers"],
                                     n_heads=n_heads)
    tdec = pt_decode.TransformerDecoder(
        {k: np.asarray(v) for k, v in params.items()},
        n_layers=CFG["n_layers"], n_heads=n_heads, device="cpu")
    return jdec, tdec


# ------------------------------------------------------------ quantize
def _rows(kind):
    rng = np.random.RandomState(21)
    if kind == "random":
        return (rng.randn(64, 3, 8) * rng.rand(64, 3, 1) * 20) \
            .astype(np.float32)
    if kind == "zeros":
        return np.zeros((4, 2, 8), np.float32)
    # exact .5 ties: absmax 127 gives scale 1.0, so x / s lands on
    # k + 0.5 exactly — round-half-even must agree
    x = np.tile(np.arange(-3.5, 4.5, 1.0, dtype=np.float32), (6, 2, 1))
    x[..., 0] = 127.0
    return x


@pytest.mark.parametrize("kind", ["random", "zeros", "ties"])
def test_quantize_kv_bit_equal(kind):
    x = _rows(kind)
    jq, js = jax_ops.quantize_kv(jnp.asarray(x))
    tq, ts = pt_ops.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back_j = np.asarray(jax_ops.dequantize_kv(jq, js))
    back_t = pt_ops.dequantize_kv(tq, ts).numpy()
    np.testing.assert_array_equal(back_t, back_j)
    if kind == "zeros":
        assert not back_t.any()


def test_dequantize_kv_to_bfloat16_matches_jax():
    x = _rows("random")
    jq, js = jax_ops.quantize_kv(jnp.asarray(x))
    want = np.asarray(jax_ops.dequantize_kv(jq, js, jnp.bfloat16)
                      .astype(jnp.float32))
    got = pt_ops.dequantize_kv(torch.from_numpy(np.array(jq)),
                               torch.from_numpy(np.array(js)),
                               torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------- int8 window path
def _quant_inputs(h, g, W, seed=13):
    """Int8 pools from quantize_kv rows, out-of-order physical pages,
    ragged mid-page lengths (tests/test_paged_decode.py
    TestDequantWindowKernel)."""
    rng = np.random.RandomState(seed)
    S, dh, ps, npages = 3, 8, 4, 12
    k = rng.randn(npages, ps, g, dh).astype(np.float32)
    v = rng.randn(npages, ps, g, dh).astype(np.float32)
    kq, ks = (np.array(a) for a in jax_ops.quantize_kv(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jax_ops.quantize_kv(jnp.asarray(v)))
    q = rng.randn(S, W, h, dh).astype(np.float32)
    tables = np.array([[3, 1, 7, 0, 0],
                       [2, 9, 4, 11, 8],
                       [5, 6, 0, 0, 0]], np.int32)
    base = np.array([9, 15, 5], np.int32)
    lens = (base[:, None] + np.arange(W)[None, :]).astype(np.int32)
    return dict(q=q, k=k, v=v, kq=kq, ks=ks, vq=vq, vs=vs, tables=tables,
                lens=lens)


@pytest.mark.parametrize("oracle", ["gather", "interpret"])
@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("h,g", [(4, 4), (4, 2), (4, 1)])
def test_int8_window_matches_jax(h, g, W, oracle):
    a = _quant_inputs(h, g, W)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    kern = oracle == "interpret"
    want = np.asarray(jax_ops.paged_window_attention(
        j["q"], j["kq"], j["vq"], j["tables"], j["lens"],
        k_scales=j["ks"], v_scales=j["vs"], use_kernel=kern,
        interpret=kern))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = pt_ops.paged_window_attention(
        t["q"], t["kq"], t["vq"], t["tables"], t["lens"],
        k_scales=t["ks"], v_scales=t["vs"])
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("h,g", [(4, 4), (4, 2), (4, 1)])
def test_int8_chunked_merge_matches_pallas_interpret(h, g, W, chunk):
    """The window kernel's split page walk and merge over int8 pages
    (plain, float32 dequant per element, driven by its chunk plan) equal
    the JAX package's dequant-fused kernel in interpret mode, a kv_len-0
    token included (the mean of dequantized V over the used pages)."""
    a = _quant_inputs(h, g, W)
    a["lens"][1, 0] = 0
    j = {k: jnp.asarray(v) for k, v in a.items()}
    want = np.asarray(jax_ops.paged_window_attention(
        j["q"], j["kq"], j["vq"], j["tables"], j["lens"],
        k_scales=j["ks"], v_scales=j["vs"], use_kernel=True,
        interpret=True))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    plan = plan_for(t["q"], t["kq"], a["tables"], chunk)
    got = chunked_window_reference(t["q"], t["kq"], t["vq"], a["tables"],
                                   a["lens"], plan, k_scales=t["ks"],
                                   v_scales=t["vs"])
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


def test_int8_paths_within_pinned_contract_of_fp32():
    """The port's int8 plain path and the JAX package's interpret-mode
    dequant kernel both sit within INT8_KV_RTOL/ATOL of the exact
    float32 attention over the same pre-quantization pages."""
    a = _quant_inputs(4, 2, 2, seed=14)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    exact = pt_ops.paged_window_attention(t["q"], t["k"], t["v"],
                                          t["tables"], t["lens"]).numpy()
    got_port = pt_ops.paged_window_attention(
        t["q"], t["kq"], t["vq"], t["tables"], t["lens"],
        k_scales=t["ks"], v_scales=t["vs"]).numpy()
    j = {k: jnp.asarray(v) for k, v in a.items()}
    got_jax = np.asarray(jax_ops.paged_window_attention(
        j["q"], j["kq"], j["vq"], j["tables"], j["lens"],
        k_scales=j["ks"], v_scales=j["vs"], use_kernel=True,
        interpret=True))
    assert pt_ops.INT8_KV_RTOL == jax_ops.INT8_KV_RTOL
    assert pt_ops.INT8_KV_ATOL == jax_ops.INT8_KV_ATOL
    assert pt_ops.INT8_KV_SCALE_EPS == jax_ops.INT8_KV_SCALE_EPS
    for got in (got_port, got_jax):
        np.testing.assert_allclose(got, exact, rtol=pt_ops.INT8_KV_RTOL,
                                   atol=pt_ops.INT8_KV_ATOL)


def test_gather_scales_matches_jax():
    rng = np.random.RandomState(2)
    sc = rng.rand(6, 4, 2).astype(np.float32)
    table = np.array([[5, 0, 2], [1, 3, 0]], np.int32)
    want = np.asarray(jax_ops.gather_scales(jnp.asarray(sc),
                                            jnp.asarray(table)))
    got = pt_ops.gather_scales(torch.from_numpy(sc),
                               torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)


# the cases of tests/test_paged_decode.py:198-205 and :303-312
GATE_CASES = [
    ((2, 2, 4, 8), np.float32, (8, 4, 2, 8), False),   # fp pages
    ((2, 2, 4, 8), np.int8, (8, 4, 2, 8), True),       # int8 + scales
    ((2, 2, 4, 8), np.int8, (8, 4, 2, 6), True),       # dh 6: refused
    ((2, 2, 4, 8), np.float32, (8, 4, 2, 6), False),   # dh 6: refused
]


@pytest.mark.parametrize("q_shape,kv_dtype,k_shape,scaled", GATE_CASES)
def test_kernel_gate_agrees_with_jax(q_shape, kv_dtype, k_shape, scaled):
    jq = jnp.zeros(q_shape, jnp.float32)
    jk = jnp.zeros(k_shape, kv_dtype)
    js = jnp.zeros(k_shape[:3], jnp.float32) if scaled else None
    want = jax_ops.paged_kernel_supported(jq, jk, js)
    tq = torch.zeros(q_shape)
    tk = torch.from_numpy(np.zeros(k_shape, kv_dtype))
    ts = torch.zeros(k_shape[:3]) if scaled else None
    assert pt_ops.paged_kernel_supported(tq, tk, ts) == want
    # the port's own limits on top: int8 pages need their scales, and
    # scales of another shape are refused
    if scaled:
        assert not pt_ops.paged_kernel_supported(tq, tk)
        assert not pt_ops.paged_kernel_supported(
            tq, tk, torch.zeros(k_shape[:2] + (k_shape[2] + 1,)))


# ---------------------------------------------------- dense decode path
def _decode_inputs(h, g, seed=2):
    rng = np.random.RandomState(seed)
    b, dh, T = 3, 8, 16
    q = rng.randn(b, h, dh).astype(np.float32)
    kc = rng.randn(b, g, dh, T).astype(np.float32)
    vc = rng.randn(b, g, dh, T).astype(np.float32)
    return q, kc, vc


@pytest.mark.parametrize("lens_kind", ["shared", "per_row"])
@pytest.mark.parametrize("h,g", [(8, 8), (8, 2)])
def test_decode_attention_matches_jax_interpret(h, g, lens_kind):
    q, kc, vc = _decode_inputs(h, g)
    lens = np.array([11], np.int32) if lens_kind == "shared" else \
        np.array([5, 16, 11], np.int32)
    want = np.asarray(jax_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lens), interpret=True))
    t = [torch.from_numpy(a) for a in (q, kc, vc)]
    before = pt_ops.decode_attention.launches
    got = pt_ops.decode_attention(*t, torch.from_numpy(lens))
    ref = pt_ops.decode_reference(*t, torch.from_numpy(lens))
    assert pt_ops.decode_attention.launches == before
    np.testing.assert_allclose(got.numpy(), want, **INTERPRET_DECODE_TOL)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_decode_attention_zero_length_row_is_mean_of_v():
    """kv_len 0: every score is NEG_INF, so the TPU kernel's exp2
    weights are all 1 and the row is the mean of V over T — the port's
    plain version returns the same, as does the JAX interpret run."""
    q, kc, vc = _decode_inputs(4, 2, seed=5)
    lens = np.array([0, 7, 16], np.int32)
    got = pt_ops.decode_attention(*[torch.from_numpy(a)
                                    for a in (q, kc, vc)],
                                  torch.from_numpy(lens)).numpy()
    want = np.asarray(jax_ops.decode_attention(
        *[jnp.asarray(a) for a in (q, kc, vc, lens)], interpret=True))
    np.testing.assert_allclose(got, want, **INTERPRET_DECODE_TOL)
    mean_v = vc[0].mean(axis=-1)                          # [g, dh]
    np.testing.assert_allclose(got[0], np.repeat(mean_v, 2, axis=0),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_use_kernel_equals_einsum(quant):
    """paged_attention(use_kernel=True) — the op route to the decode
    kernel — equals use_kernel=False on the port, float and int8
    pools, per-row ragged lengths."""
    rng = np.random.RandomState(1)
    b, h, g, dh, ps, npages = 2, 4, 2, 8, 4, 8
    k = rng.randn(npages, ps, g, dh).astype(np.float32)
    v = rng.randn(npages, ps, g, dh).astype(np.float32)
    q = torch.from_numpy(rng.randn(b, h, dh).astype(np.float32))
    table = torch.from_numpy(np.array([[1, 4, 2, 0], [3, 5, 0, 0]],
                                      np.int32))
    lens = torch.from_numpy(np.array([10, 7], np.int32))
    kw = {}
    kp, vp = torch.from_numpy(k), torch.from_numpy(v)
    if quant:
        kp, ks = pt_ops.quantize_kv(kp)
        vp, vs = pt_ops.quantize_kv(vp)
        kw = dict(k_scales=ks, v_scales=vs)
    ein = pt_ops.paged_attention(q, kp, vp, table, lens, **kw)
    ker = pt_ops.paged_attention(q, kp, vp, table, lens, use_kernel=True,
                                 **kw)
    np.testing.assert_allclose(ker.numpy(), ein.numpy(), **KERNEL_TOL)
    jkw = {k_: jnp.asarray(v_.numpy()) for k_, v_ in kw.items()}
    want = np.asarray(jax_ops.paged_attention(
        *[jnp.asarray(a.numpy()) for a in (q, kp, vp, table, lens)],
        use_kernel=True, interpret=True, **jkw))
    np.testing.assert_allclose(ker.numpy(), want, **INTERPRET_DECODE_TOL)


def test_decode_gate():
    q = torch.zeros((2, 8, 64))
    assert pt_ops.decode_supported(q, torch.zeros((2, 2, 64, 544)))
    # bfloat16 cache under a float32 query, an odd head dim, more than
    # 32 query heads a kv group, a 32-column chunk's tiles and q rows
    # past shared memory (32 heads a group at dh 1024)
    assert not pt_ops.decode_supported(
        q, torch.zeros((2, 2, 64, 544), dtype=torch.bfloat16))
    assert not pt_ops.decode_supported(torch.zeros((2, 8, 6)),
                                       torch.zeros((2, 2, 6, 16)))
    assert not pt_ops.decode_supported(torch.zeros((2, 64, 8)),
                                       torch.zeros((2, 1, 8, 16)))
    assert not pt_ops.decode_supported(torch.zeros((2, 32, 1024)),
                                       torch.zeros((2, 1, 1024, 64)))


# -------------------------------------------------------- int8 decoder
@pytest.mark.parametrize("variant", [{}, {"n_heads": 4, "n_kv_heads": 2}])
def test_int8_paged_step_matches_jax(variant):
    """PagedDecoder(kv_quant="int8"): two window steps from one table —
    a 3-token prefill chunk, then one token — give the same tokens and
    the same pools as the JAX package: int8 values equal and scales
    within float32 rounding (the K/V projections come out of two
    matmul libraries; the quantizer itself is bit-equal)."""
    jdec, tdec = _pair(**variant)
    kw = dict(num_slots=2, page_size=4, num_pages=8, max_pages_per_slot=4,
              window=3, kv_quant="int8")
    jp = jdec.paged(**kw)
    tp = tdec.paged(**kw)
    jk, jv = jp.init_pools()
    tk, tv = tp.init_pools()
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    feeds = [(np.array([[5, 9, 2], [7, 1, 0]]),
              np.array([[0, 1, 2], [0, 1, 0]]),
              np.array([[1, 1, 1], [1, 1, 0]], bool)),
             (np.array([[3, 0, 0], [4, 0, 0]]),
              np.array([[3, 0, 0], [2, 0, 0]]),
              np.array([[1, 0, 0], [1, 0, 0]], bool))]
    for toks, pos, act in feeds:
        jn, jk, jv = jp.step(jk, jv, toks, pos, tables, act)
        tn, tk, tv = tp.step(tk, tv, toks, pos, tables, act)
        np.testing.assert_array_equal(tn[act], np.asarray(jn)[act])
    for jpool, tpool in ((jk, tk), (jv, tv)):
        np.testing.assert_array_equal(tpool["q"].numpy(),
                                      np.asarray(jpool["q"]))
        np.testing.assert_allclose(tpool["s"].numpy(),
                                   np.asarray(jpool["s"]), rtol=1e-6,
                                   atol=0)
    assert tp.pool_bytes() == jp.pool_bytes()


def test_int8_copy_read_write_page_round_trip():
    _, tdec = _pair()
    tp = tdec.paged(num_slots=2, page_size=4, num_pages=6,
                    max_pages_per_slot=4, kv_quant="int8")
    k, v = tp.init_pools()
    assert k["q"].dtype == torch.int8 and k["s"].dtype == torch.float32
    gen = torch.Generator().manual_seed(0)
    for pool in (k, v):
        q_, s_ = pt_ops.quantize_kv(torch.randn(
            pool["q"].shape, generator=gen))
        pool["q"].copy_(q_)
        pool["s"].copy_(s_)
    before = {n: t.clone() for n, t in
              (("kq", k["q"]), ("ks", k["s"]), ("vq", v["q"]),
               ("vs", v["s"]))}
    k2, v2 = tp.copy_page(k, v, 2, 5)
    assert k2 is k and v2 is v
    for pool in (k, v):
        for leaf in pool.values():
            assert torch.equal(leaf[:, 5], leaf[:, 2])
    kp, vp = tp.read_page(k, v, 3)
    assert kp["q"].shape == (2, 1, 4, 2, 8) and kp["s"].shape == \
        (2, 1, 4, 2)
    tp.write_page(k, v, kp, vp, 4)
    for pool, page in ((k, kp), (v, vp)):
        for key in ("q", "s"):
            assert torch.equal(pool[key][:, 4], pool[key][:, 3])
            assert torch.equal(page[key][:, 0], pool[key][:, 3])
    # every page the three calls did not target is untouched
    for name, t in (("kq", k["q"]), ("ks", k["s"]), ("vq", v["q"]),
                    ("vs", v["s"])):
        for page in (0, 1, 2, 3):
            assert torch.equal(t[:, page], before[name][:, page]), name


# --------------------------------------------------------- spill store
def test_spill_store_lru_checksum_and_corruption():
    payload = {"k.q": np.arange(16, dtype=np.int8),
               "k.s": np.ones(4, np.float32)}
    assert entry_checksum(payload) == entry_checksum(dict(payload))
    store = SpillStore(2)
    for i in range(3):
        store.put((i,), SpillEntry({n: a.copy()
                                    for n, a in payload.items()}))
    assert len(store) == 2 and not store.has((0,)) and store.has((2,))
    store.touch((1,))
    store.put((3,), SpillEntry(dict(payload)))
    assert store.has((1,)) and not store.has((2,))
    acc = store.accounting()
    assert acc["spill_puts"] == 4 and acc["spill_evicted_lru"] == 2
    assert acc["spilled"] == 2 and acc["spill_bytes"] == 2 * 32
    key = store.corrupt_one("bitflip")
    entry = store.pop(key)
    assert entry is not None and not entry.verify()
    assert store.pop(key) is None
    assert store.clear() == 1 and len(store) == 0
    with pytest.raises(ValueError):
        SpillStore(0)


def _storm(eng, seed, waves=5, per_wave=2, gap=4, prompt_len=8,
           max_new=3, vocab=40, revisit_from=2, submitted=None):
    """The spill storm of tests/test_serving_faults.py
    (FaultPlan.spill_storm) driven step by step without the JAX fault
    harness: ``per_wave`` distinct prompts join every ``gap`` device
    steps, and from wave ``revisit_from`` on each wave also resubmits
    one of the earliest prompts, whose pages are by then the coldest.
    Works on either package's engine. Returns (and appends to
    ``submitted`` as they join) the (request, prompt) pairs."""
    rng = np.random.RandomState(seed + 2)
    prompts = [[int(t) for t in rng.randint(0, vocab, prompt_len)]
               for _ in range(waves * per_wave)]
    submitted = [] if submitted is None else submitted

    def fire(w):
        for j in range(per_wave):
            prompt = prompts[(w * per_wave + j) % len(prompts)]
            submitted.append((eng.submit(prompt, max_new), prompt))
        if w >= revisit_from:
            prompt = prompts[w % revisit_from]
            submitted.append((eng.submit(prompt, max_new), prompt))

    fire(0)
    due = {w * gap: w for w in range(1, waves)}
    base = eng._steps
    while eng._has_work():
        w = due.pop(eng._steps - base, None)
        if w is not None:
            fire(w)
        eng.step()
    assert not due, "the engine drained before every wave joined"
    return submitted


def _spill_engine(cls, dec, **over):
    kw = dict(num_slots=2, page_size=4, max_seq_len=20, num_pages=9,
              kv_spill_pages=8)
    kw.update(over)
    return cls(dec, **kw)


def assert_pool_balanced(eng):
    """Both tiers balance (tests/test_serving_faults.py
    ``assert_pool_balanced``): zero leaks, refcounts equal to slot +
    trie holdings, and host-tier conservation."""
    acc = eng.page_accounting()
    assert acc["leaked"] == 0
    assert acc["free"] + acc["held_by_trie"] == acc["total_usable"]
    assert acc["refs_total"] == acc["held_by_slots"] + acc["held_by_trie"]
    if eng.spill is not None:
        assert 0 <= acc["spilled"] <= acc["spill_capacity"]
        assert acc["spill_puts"] == (
            acc["spill_restores"] + acc["spill_evicted_lru"]
            + acc["spill_dropped_integrity"] + acc["spill_cleared"]
            + acc["spilled"]), acc
    return acc


SPILL_KEYS = ("kv_pages_spilled", "kv_pages_restored",
              "kv_spill_integrity_drops", "prefix_evicted_pages",
              "tokens_out", "steps")


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_spill_storm_matches_jax_engine(kv_quant):
    """The storm spills cold trie pages host-ward and restores them on
    revisits; the port's tokens and spill/restore counters equal the
    JAX engine's on the same table and prompts (int8 pages included),
    every revisit repeats its first visit's tokens, and both tiers
    balance."""
    jdec, tdec = _pair()
    j_eng = _spill_engine(JaxEngine, jdec, kv_quant=kv_quant)
    t_eng = _spill_engine(DecodeEngine, tdec, kv_quant=kv_quant)
    j_sub = _storm(j_eng, seed=31)
    t_sub = _storm(t_eng, seed=31)
    assert [p for _, p in t_sub] == [p for _, p in j_sub]
    first = {}
    for (tr, prompt), (jr, _) in zip(t_sub, j_sub):
        got = tr.get(timeout=1)
        assert got == jr.get(timeout=1)
        assert first.setdefault(tuple(prompt), got) == got
    acc = assert_pool_balanced(t_eng)
    assert acc["spill_puts"] >= 1 and acc["spill_restores"] >= 1
    t_st, j_st = t_eng.stats(), j_eng.stats()
    for key in SPILL_KEYS:
        assert t_st[key] == j_st[key], key
    assert t_st["kv_pages_spilled_now"] == acc["spilled"]
    assert t_st["kv_quant_bits"] == (8 if kv_quant else 32)
    assert t_eng.page_accounting() == {
        k: v for k, v in j_eng.page_accounting().items()
        if k in t_eng.page_accounting()}


def test_corrupt_spilled_page_degrades_to_miss():
    """Bit-rot every host-resident entry (CRC left stale), then revisit
    the stormed prompts: each restore fails verification, drops the
    entry and recomputes — tokens unchanged, both tiers balanced."""
    _, tdec = _pair()
    eng = _spill_engine(DecodeEngine, tdec)
    submitted = _storm(eng, seed=33, waves=4, revisit_from=4)
    acc0 = assert_pool_balanced(eng)
    assert acc0["spilled"] >= 1

    class _Rotate:  # deterministic rng stub: hit EVERY entry once
        def __init__(self):
            self.i = 0

        def choice(self, xs):
            xs = sorted(xs)
            v = xs[self.i % len(xs)]
            self.i += 1
            return v

        def randrange(self, n):
            return 0

    rot = _Rotate()
    for _ in range(acc0["spilled"]):
        assert eng.spill.corrupt_one("bitflip", rng=rot) is not None
    first = {}
    for req, p in submitted:
        first.setdefault(tuple(p), req.get(timeout=1))
    reqs = [(eng.submit(list(p), 3), p) for p in first]
    eng.run(timeout=300)
    for req, p in reqs:
        assert req.get(timeout=1) == first[p]
    acc = assert_pool_balanced(eng)
    assert acc["spill_dropped_integrity"] >= 1
    assert eng.stats()["kv_spill_integrity_drops"] >= 1


class _Crash(Exception):
    pass


@pytest.mark.parametrize("stage", ["read", "commit"])
def test_crash_during_spill_stays_balanced(stage):
    """A crash raised from the spill seam at the read point (nothing
    changed yet) or the commit point (trie evicted and page freed,
    entry not yet stored): the accounting stays balanced, the torn
    spill left no store entry, and the engine then drains every
    request with the tokens of an uncrashed run."""
    _, tdec = _pair()
    ref = _spill_engine(DecodeEngine, tdec)
    want = [r.get(timeout=1) for r, _ in
            _storm(ref, seed=34, waves=4, revisit_from=4)]
    eng = _spill_engine(DecodeEngine, tdec)
    hit = {"path": None}

    def seam(point, path, page):
        if point == stage and hit["path"] is None:
            hit["path"] = path
            raise _Crash(f"{stage} page {page}")

    eng._spill_interceptor = seam
    submitted = []
    with pytest.raises(_Crash):
        _storm(eng, seed=34, waves=4, revisit_from=4, submitted=submitted)
    eng._spill_interceptor = None
    acc = eng.page_accounting()
    assert acc["leaked"] == 0
    assert acc["refs_total"] == acc["held_by_slots"] + acc["held_by_trie"]
    assert acc["spill_puts"] == (
        acc["spill_restores"] + acc["spill_evicted_lru"]
        + acc["spill_dropped_integrity"] + acc["spill_cleared"]
        + acc["spilled"])
    assert hit["path"] is not None and not eng.spill.has(hit["path"])
    eng.run(timeout=300)
    # the requests that joined before the crash finish as they would
    # have without it
    got = [r.get(timeout=1) for r, _ in submitted]
    assert len(got) >= 1 and got == want[:len(got)]
    assert_pool_balanced(eng)


def test_spill_requires_prefix_cache():
    _, tdec = _pair()
    with pytest.raises(ValueError, match="prefix"):
        DecodeEngine(tdec, kv_spill_pages=4, prefix_cache=False)


def test_paged_prefill_logits_reproduce_engine_tokens():
    """PagedDecoder.prefill_logits (the near-tie reference for an int8
    engine) gives the int8 engine's greedy tokens back as its argmax
    over prompt + generated tokens; over float pages it matches the
    dense decoder's prefill logits."""
    _, tdec = _pair()
    prompt = np.random.RandomState(4).randint(0, 40, (9,)).astype("int32")
    eng = DecodeEngine(tdec, num_slots=2, page_size=4, max_seq_len=32,
                       kv_quant="int8")
    req = eng.submit(prompt, 7)
    eng.run(timeout=60)
    toks = req.get(timeout=1)
    step = tdec.paged(num_slots=1, page_size=4, num_pages=9,
                      max_pages_per_slot=8, window=5, kv_quant="int8")
    logits = step.prefill_logits(np.concatenate([prompt, toks]))
    assert logits.shape == (len(prompt) + 7, CFG["vocab_size"])
    assert list(logits[len(prompt) - 1:-1].argmax(-1)) == toks
    fp = tdec.paged(num_slots=1, page_size=4, num_pages=9,
                    max_pages_per_slot=8, window=3)
    seq = np.concatenate([prompt, toks])
    np.testing.assert_allclose(fp.prefill_logits(seq),
                               tdec.prefill_logits(seq[None, :])[0],
                               rtol=1e-4, atol=1e-5)


def test_prefix_spill_helpers_match_jax():
    """The prefix index's spill helpers against the JAX package's on
    one insert history: the LRU spill candidates (token path, page),
    evict_exact's refusals and evictions, and flush returning every
    trie reference."""
    from paddle_tpu.serving.engine import PagePool as JaxPool
    from paddle_tpu.serving.prefix import PrefixIndex as JaxIndex
    from paddle_tpu_torch.serving import PagePool, PrefixIndex
    idx = {}
    for name, pool_cls, index_cls in (("jax", JaxPool, JaxIndex),
                                      ("port", PagePool, PrefixIndex)):
        pool = pool_cls(12)
        index = index_cls(pool, 2)
        runs = ([1, 2, 3, 4, 5, 6], [1, 2, 3, 4, 7, 8], [9, 9, 1, 1])
        for toks in runs:
            pages = [pool.alloc() for _ in range(len(toks) // 2)]
            index.insert(toks, pages)
            pool.free(pages)                 # the slot lets go
        index.match([1, 2, 3, 4, 7, 8, 0])  # touch one branch
        pinned = index.spill_candidates(1)[0][1]
        pool.ref(pinned)                     # a slot shares the coldest
        cands = index.spill_candidates(8)
        refused = index.evict_exact(cands[0][0] + (0, 0))
        evicted = index.evict_exact(cands[0][0])
        pool.free([pinned])
        flushed = index.flush()
        idx[name] = (cands, refused, evicted, flushed, pool.accounting())
    assert idx["port"] == idx["jax"]
    cands, refused, evicted, flushed, acc = idx["port"]
    assert refused is None and evicted == cands[0][1]
    assert flushed == 5 and acc["free"] == acc["total_usable"]
