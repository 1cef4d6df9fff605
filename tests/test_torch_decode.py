"""Port parity: paddle_tpu_torch/models/decode.py and params.py against
paddle_tpu/models/decode.py on the CPU.

One JAX ``Topology.init_params`` table (the CFG of
tests/test_paged_decode.py, plus a grouped-query variant) feeds both
packages. Float32 logits must agree within rtol 1e-4 / atol 1e-5 on
prefill and on every decode step (two CPU matmul libraries summing in
different orders); greedy tokens must be identical under the tie rule
(``tokens_agree``: a mismatch counts only where the reference's best
two logits are NOT within the logits tolerance).
"""

import io

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import torch
from paddle_tpu import models

from paddle_tpu_torch import params as pt_params
from paddle_tpu_torch.models import decode as pt_decode

CFG = dict(vocab_size=40, d_model=16, n_heads=2, n_layers=2, d_ff=32,
           max_len=32)
RTOL, ATOL = 1e-4, 1e-5
TIE_TOL = 1e-4


def _jax_params(seed=7, **overrides):
    paddle.init(use_tpu=False, seed=0)
    from paddle_tpu.core.registry import reset_name_counters
    reset_name_counters()
    spec = models.transformer_lm(**{**CFG, **overrides})
    costs = spec.cost if isinstance(spec.cost, list) else [spec.cost]
    topo = paddle.Topology(costs, extra_outputs=[spec.output])
    return topo.init_params(jax.random.PRNGKey(seed))


def _pair(**overrides):
    params = _jax_params(**overrides)
    n_heads = overrides.get("n_heads", CFG["n_heads"])
    jdec = models.TransformerDecoder(params, n_layers=CFG["n_layers"],
                                     n_heads=n_heads)
    table = {k: np.asarray(v) for k, v in params.items()}
    tdec = pt_decode.TransformerDecoder(table, n_layers=CFG["n_layers"],
                                        n_heads=n_heads, device="cpu")
    return jdec, tdec, table


VARIANTS = {"mha": {}, "gqa": {"n_heads": 4, "n_kv_heads": 2}}


def _variant(name):
    return _pair(**VARIANTS[name])


def test_params_from_numpy_keeps_names_layout_dtype():
    table = {k: np.asarray(v) for k, v in _jax_params().items()}
    got = pt_params.params_from_numpy(table, device="cpu")
    assert set(got) == set(table)
    for k, v in table.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).endswith(str(v.dtype)), k
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_init_params_matches_jax_table_names_and_shapes():
    """The seeded numpy init (what chip_smoke.py draws) has exactly the
    JAX table's names and shapes, for MHA and GQA."""
    for ov in ({}, {"n_heads": 4, "n_kv_heads": 2}):
        want = {k: v.shape for k, v in _jax_params(**ov).items()}
        got = pt_params.init_transformer_lm_params({**CFG, **ov}, seed=0)
        assert {k: v.shape for k, v in got.items()} == want
        assert all(v.dtype == np.float32 for v in got.values())


def test_load_params_tar_reads_jax_checkpoint():
    from paddle_tpu.trainer.parameters import Parameters
    params = _jax_params()
    buf = io.BytesIO()
    Parameters(params).to_tar(buf)
    buf.seek(0)
    got = pt_params.load_params_tar(buf)
    assert set(got) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(got[k], np.asarray(v))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_match_on_prefill_and_each_step(variant):
    jdec, tdec, _ = _variant(variant)
    rng = np.random.RandomState(0)
    b, plen, max_len = 2, 5, 12
    prompt = rng.randint(0, CFG["vocab_size"], (b, plen)).astype(np.int32)
    jlog, jcaches = jdec._prefill(jdec.p, jnp.asarray(prompt), plen,
                                  max_len)
    tlog, tcaches = tdec._prefill(torch.from_numpy(prompt).long(), max_len)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=RTOL, atol=ATOL)
    # teacher-force the same token stream through both caches
    for pp in range(plen, max_len - 1):
        tok = rng.randint(0, CFG["vocab_size"], (b, 1)).astype(np.int32)
        jlog, jcaches = jdec._forward(
            jdec.p, jnp.asarray(tok), jnp.full((b, 1), pp, jnp.int32),
            jcaches, pp, pp + 1)
        tlog = tdec._forward(torch.from_numpy(tok).long(),
                             torch.full((b, 1), pp, dtype=torch.long),
                             tcaches, pp, pp + 1)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=RTOL, atol=ATOL, err_msg=str(pp))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_generate_token_identical(variant):
    jdec, tdec, _ = _variant(variant)
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, CFG["vocab_size"], (3, 6)).astype(np.int32)
    want = jdec.generate(prompt, max_len=20)
    got = tdec.generate(prompt, max_len=20)
    ref = tdec.prefill_logits(
        np.concatenate([prompt, np.asarray(want)], axis=1))
    for i in range(len(want)):
        assert pt_decode.tokens_agree(got[i], want[i], ref[i, 5:],
                                      TIE_TOL), i


def test_tied_head_and_eos_trim():
    jdec, tdec, _ = _pair(tie_embeddings=True)
    assert "_tfm_head.w0" not in tdec.p
    prompt = np.zeros((1, 2), np.int32)
    dense = jdec.generate(prompt, max_len=14)[0]
    eos = dense[1] if len(set(dense)) > 1 else dense[0]
    want = jdec.generate(prompt, max_len=14, eos_id=int(eos))[0]
    assert tdec.generate(prompt, max_len=14, eos_id=int(eos))[0] == want


def test_temperature_sampling_uses_the_generator():
    _, tdec, _ = _pair()
    prompt = np.zeros((2, 3), np.int32)
    a = tdec.generate(prompt, max_len=12, temperature=1.0,
                      generator=torch.Generator().manual_seed(5))
    b = tdec.generate(prompt, max_len=12, temperature=1.0,
                      generator=torch.Generator().manual_seed(5))
    assert a == b
    assert all(0 <= t < CFG["vocab_size"] for row in a for t in row)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_step_token_identical_to_jax(variant):
    """The port's PagedDecoder.step against the JAX one (attention
    "gather") on the same tables: a ragged 3-slot batch, one idle slot,
    prefill teacher-forced token by token, then free-running decode."""
    jdec, tdec, _ = _variant(variant)
    S, ps, P, npages = 4, 4, 6, 20
    jp = jdec.paged(num_slots=S, page_size=ps, num_pages=npages,
                    max_pages_per_slot=P, attention="gather",
                    warm_start=False)
    tp = tdec.paged(num_slots=S, page_size=ps, num_pages=npages,
                    max_pages_per_slot=P)
    jk, jv = jp.init_pools()
    tk, tv = tp.init_pools()
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, CFG["vocab_size"], (n,)) for n in (3, 7, 5)]
    tables = np.zeros((S, P), np.int32)
    perm = rng.permutation(np.arange(1, npages))
    tables[:3] = perm[:3 * P].reshape(3, P)      # slot 3 stays idle
    last = [0] * 3
    for t in range(16):
        tokens = np.zeros((S,), np.int32)
        positions = np.zeros((S,), np.int32)
        active = np.zeros((S,), np.bool_)
        for s, pr in enumerate(prompts):
            tokens[s] = pr[t] if t < len(pr) else last[s]
            positions[s] = t
            active[s] = True
        jn, jk, jv = jp.step(jk, jv, tokens, positions, tables, active)
        tn, tk, tv = tp.step(tk, tv, tokens, positions, tables, active)
        jn = np.asarray(jn)
        assert tn.shape == (S,) and tn.dtype == np.int32
        np.testing.assert_array_equal(tn[:3], jn[:3], err_msg=str(t))
        last = [int(x) for x in tn[:3]]
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                               rtol=RTOL, atol=ATOL)


def test_copy_page_copies_all_layers_in_place():
    _, tdec, _ = _pair()
    tp = tdec.paged(num_slots=2, page_size=4, num_pages=6,
                    max_pages_per_slot=4)
    k, v = tp.init_pools()
    k[:, 2] = torch.randn_like(k[:, 2])
    v[:, 2] = torch.randn_like(v[:, 2])
    k2, v2 = tp.copy_page(k, v, 2, 5)
    assert k2 is k and v2 is v
    assert torch.equal(k[:, 5], k[:, 2]) and torch.equal(v[:, 5], v[:, 2])
    assert tp.pool_bytes() == 2 * k.numel() * k.element_size()


def test_unported_features_raise():
    """Every feature of the decoder is ported; what it still refuses
    are the JAX package's argument checks (asserts there)."""
    _, tdec, _ = _pair()
    prompt = np.zeros((1, 2), np.int32)
    with pytest.raises(ValueError, match="num_results"):
        tdec.beam_search(prompt, max_len=6, beam_size=2, num_results=3)
    with pytest.raises(ValueError, match="length_penalty"):
        tdec.beam_search(prompt, max_len=6, length_penalty=-0.5)
    with pytest.raises(ValueError, match="vocab_size"):
        tdec.beam_search(prompt, max_len=6, beam_size=CFG["vocab_size"],
                         length_penalty=0.6)
    with pytest.raises(ValueError, match="prompt length"):
        tdec.beam_search(prompt, max_len=2)


def test_tokens_agree_tie_rule():
    logits = np.array([[0.0, 1.0, 1.0 - 5e-5, -2.0],
                       [0.0, 3.0, 1.0, -2.0]])
    assert pt_decode.tokens_agree([1, 1], [1, 1], logits, TIE_TOL)
    # a near-tie at the first mismatch: both choices are correct
    assert pt_decode.tokens_agree([2, 3], [1, 1], logits, TIE_TOL)
    # a clear winner mismatched: a real fault
    assert not pt_decode.tokens_agree([1, 2], [1, 1], logits, TIE_TOL)
    assert not pt_decode.tokens_agree([1], [1, 1], logits, TIE_TOL)


# ---------------------------------------------------------------- MoE

MOE = dict(moe_experts=4, moe_capacity_factor=8.0)


def _moe_pair(seed=3, **dec_kw):
    params = _jax_params(seed=seed, **MOE)
    table = {k: np.asarray(v) for k, v in params.items()}
    jdec = models.TransformerDecoder(params, n_layers=CFG["n_layers"],
                                     n_heads=CFG["n_heads"], **dec_kw)
    tdec = pt_decode.TransformerDecoder(table, n_layers=CFG["n_layers"],
                                        n_heads=CFG["n_heads"],
                                        device="cpu", **dec_kw)
    return jdec, tdec, table


@pytest.mark.parametrize("factor", [8.0, None])
def test_moe_decode_matches_jax_in_the_no_drop_regime(factor):
    """tests/test_decode.py:123-146's table (4 experts, trained at factor
    8, where nothing drops): prefill and step logits equal JAX's
    decoder's, with the training factor and drop-free (None), and
    greedy decode is token identical under the tie rule."""
    jdec, tdec, _ = _moe_pair(moe_capacity_factor=factor)
    rng = np.random.RandomState(2)
    b, plen, max_len = 2, 3, 8
    prompt = rng.randint(0, CFG["vocab_size"], (b, plen)).astype(np.int32)
    jlog, _ = jdec._prefill(jdec.p, jnp.asarray(prompt), plen, max_len)
    tlog, _ = tdec._prefill(torch.from_numpy(prompt).long(), max_len)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=RTOL,
                               atol=ATOL)
    want = jdec.generate(prompt, max_len=max_len)
    got = tdec.generate(prompt, max_len=max_len)
    ref = tdec.prefill_logits(np.concatenate([prompt, np.asarray(want)], 1))
    for i in range(b):
        assert pt_decode.tokens_agree(got[i], want[i], ref[i, plen - 1:],
                                      TIE_TOL), i


def test_moe_drop_free_fallback_warns_as_jax():
    """Drop-free routing over n tokens past cap^2 E > 2^27 falls back to
    factor 2.0 with the reference's warning; the FFN then equals JAX's
    (which takes the same fallback)."""
    jdec, tdec, _ = _moe_pair()
    x = np.random.RandomState(4).randn(2, 2900, CFG["d_model"]) \
        .astype(np.float32)
    with pytest.warns(UserWarning, match="falling back to "
                      "capacity_factor=2.0"):
        got = tdec._ffn(0, torch.from_numpy(x))
    with pytest.warns(UserWarning, match="falling back"):
        want = jdec._ffn(jdec.p, 0, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_moe_engine_serves_the_dense_decoders_tokens():
    """PagedDecoder reaches the MoE FFN through the shared _ffn: the
    engine's tokens equal the dense decoder's generate (tie rule)."""
    from paddle_tpu_torch.serving import DecodeEngine
    _, tdec, _ = _moe_pair()
    eng = DecodeEngine(tdec, num_slots=2, page_size=4, max_seq_len=24)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, CFG["vocab_size"], (n,)).astype(np.int32)
               for n in (3, 6, 4)]
    reqs = [eng.submit(p, 7) for p in prompts]
    eng.run(timeout=120)
    for p, r in zip(prompts, reqs):
        want = tdec.generate(p[None, :], max_len=len(p) + 7)[0]
        ref = tdec.prefill_logits(np.concatenate([p, want])[None, :])[0]
        assert pt_decode.tokens_agree(r.get(timeout=1), want,
                                      ref[len(p) - 1:], TIE_TOL)


# -------------------------------------------------------- flash prefill

def _flash_gate_on(monkeypatch):
    """Force the flash-prefill gate on the CPU, as tests/test_decode.py
    does: the route then runs flash_attention's plain version."""
    monkeypatch.setattr(pt_decode.TransformerDecoder, "_use_flash_prefill",
                        staticmethod(lambda t, pos, q: pos == 0 and t > 1))


@pytest.mark.parametrize("n_kv_heads,vocab,layers", [(None, 97, 2),
                                                     (2, 61, 1)])
def test_flash_prefill_route_matches_einsum(monkeypatch, n_kv_heads, vocab,
                                            layers):
    """tests/test_decode.py's TestFlashPrefill at its sizes (plen 256, d
    64, 4 heads; GQA with 2 kv heads): the route's prefill logits equal
    the einsum path's and JAX's at rtol 2e-4 / atol 2e-4 (the JAX
    test's bound), and the caches it fills are the einsum path's."""
    plen, max_len, d = 256, 272, 64
    jpaddle_init = dict(vocab_size=vocab, d_model=d, n_heads=4,
                        n_layers=layers, d_ff=2 * d, max_len=max_len,
                        n_kv_heads=n_kv_heads)
    paddle.init(use_tpu=False, seed=0)
    from paddle_tpu.core.registry import reset_name_counters
    reset_name_counters()
    spec = models.transformer_lm(**jpaddle_init)
    topo = paddle.Topology(spec.cost, extra_outputs=[spec.output])
    params = topo.init_params(jax.random.PRNGKey(layers - 1))
    table = {k: np.asarray(v) for k, v in params.items()}
    prompt = np.random.RandomState(layers - 1).randint(
        0, vocab, (2, plen)).astype(np.int32)
    jdec = models.TransformerDecoder(params, n_layers=layers, n_heads=4)
    tdec = pt_decode.TransformerDecoder(table, n_layers=layers, n_heads=4,
                                        device="cpu")
    ids = torch.from_numpy(prompt).long()
    assert not tdec._use_flash_prefill(plen, 0, torch.zeros(2, plen, 4, 16))
    lg_e, c_e = tdec._prefill(ids, max_len)
    jlog, _ = jdec._prefill(jdec.p, jnp.asarray(prompt), plen, max_len)
    _flash_gate_on(monkeypatch)
    lg_f, c_f = tdec._prefill(ids, max_len)
    for got in (lg_f, lg_e):
        np.testing.assert_allclose(got.numpy(), np.asarray(jlog), rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_allclose(lg_f.numpy(), lg_e.numpy(), rtol=2e-4,
                               atol=2e-4)
    for (kf, vf), (ke, ve) in zip(c_f, c_e):
        torch.testing.assert_close(kf, ke, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(vf, ve, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------- beam search

def test_beam1_equals_greedy():
    _, tdec, _ = _pair()
    prompt = np.random.RandomState(4).randint(
        0, CFG["vocab_size"], (2, 3)).astype(np.int32)
    eid = CFG["vocab_size"] - 1
    greedy = tdec.generate(prompt, max_len=10, eos_id=eid)
    beam = tdec.beam_search(prompt, max_len=10, beam_size=1, eos_id=eid)
    for row in range(2):
        assert beam[row][0][1] == greedy[row]


@pytest.mark.parametrize("variant,alpha", [("mha", 0.0), ("gqa", 0.0),
                                           ("mha", 0.6), ("gqa", 1.0)])
def test_beam_search_matches_jax(variant, alpha):
    """Raw-sum (alpha 0) and GNMT (alpha > 0) n-best lists: JAX's paths
    token for token, scores within 1e-5, best first, rows distinct and
    trimmed at the first EOS."""
    jdec, tdec, _ = _variant(variant)
    prompt = np.random.RandomState(5).randint(
        0, CFG["vocab_size"], (2, 3)).astype(np.int32)
    eid = CFG["vocab_size"] - 1
    kw = dict(max_len=12, beam_size=4, eos_id=eid, length_penalty=alpha)
    want = jdec.beam_search(prompt, **kw)
    got = tdec.beam_search(prompt, num_results=4, **kw)
    for g_row, w_row in zip(got, want):
        assert [p for _, p in g_row] == [p for _, p in w_row]
        np.testing.assert_allclose([s for s, _ in g_row],
                                   [s for s, _ in w_row], rtol=0, atol=1e-5)
        scores = [s for s, _ in g_row]
        assert scores == sorted(scores, reverse=True)
        assert len({tuple(p) for _, p in g_row}) == len(g_row)
        assert all(eid not in p[:-1] for _, p in g_row)


def test_moe_beam_search_matches_jax():
    jdec, tdec, _ = _moe_pair()
    prompt = np.zeros((1, 2), np.int32)
    eid = CFG["vocab_size"] - 1
    for alpha in (0.0, 0.6):
        want = jdec.beam_search(prompt, max_len=9, beam_size=3, eos_id=eid,
                                length_penalty=alpha)
        got = tdec.beam_search(prompt, max_len=9, beam_size=3, eos_id=eid,
                               length_penalty=alpha)
        assert [p for _, p in got[0]] == [p for _, p in want[0]]
        np.testing.assert_allclose([s for s, _ in got[0]],
                                   [s for s, _ in want[0]], rtol=0,
                                   atol=1e-5)
