"""Port parity for speculative decoding on the CPU:
paddle_tpu_torch/models/decode.py ``DraftDecoder`` and the engine's
``draft=`` / ``spec_k`` window (serving/engine.py) against the JAX
package, plus the serve CLI's speculation and two-tier flags.

One JAX ``Topology.init_params`` table per model feeds both packages
(numpy seeds). The draft's argmax must be identical to the JAX
draft's and its caches equal within rtol 1e-5 / atol 1e-6 (two CPU
matmul libraries); the engines' greedy tokens must be identical to
the JAX engine's on the same prompts — and therefore to the dense
decoder's — with the same ``spec_proposed_tokens`` /
``spec_accepted_tokens`` (tests/test_paged_decode.py
TestSpeculativeDecoding).
"""

import numpy as np
import pytest

import jax
import paddle_tpu as paddle
from paddle_tpu import models
from paddle_tpu.serving.engine import DecodeEngine as JaxEngine

from paddle_tpu_torch.models import decode as pt_decode
from paddle_tpu_torch.serving import DecodeEngine

CFG = dict(vocab_size=40, d_model=16, n_heads=2, n_layers=2, d_ff=32,
           max_len=32)
SPEC_KEYS = ("spec_proposed_tokens", "spec_accepted_tokens", "tokens_out",
             "steps", "prefill_tokens", "window", "spec_k")


def _params(seed=7, **overrides):
    paddle.init(use_tpu=False, seed=0)
    from paddle_tpu.core.registry import reset_name_counters
    reset_name_counters()
    spec = models.transformer_lm(**{**CFG, **overrides})
    costs = spec.cost if isinstance(spec.cost, list) else [spec.cost]
    topo = paddle.Topology(costs, extra_outputs=[spec.output])
    return topo.init_params(jax.random.PRNGKey(seed))


def _pair(seed=7, **overrides):
    params = _params(seed, **overrides)
    jdec = models.TransformerDecoder(params, n_layers=CFG["n_layers"],
                                     n_heads=CFG["n_heads"])
    tdec = pt_decode.TransformerDecoder(
        {k: np.asarray(v) for k, v in params.items()},
        n_layers=CFG["n_layers"], n_heads=CFG["n_heads"], device="cpu")
    return jdec, tdec


def _ragged(rng, n, lo=3, hi=8):
    return [rng.randint(0, CFG["vocab_size"],
                        (int(rng.randint(lo, hi)),)).astype("int32")
            for _ in range(n)]


def _serve_both(jdec, tdec, jdraft, tdraft, prompts, max_news, **kw):
    """The same prompts through the JAX and the port's engine; returns
    (port tokens, JAX tokens, port stats, JAX stats, port engine)."""
    out = []
    for cls, dec, draft in ((DecodeEngine, tdec, tdraft),
                            (JaxEngine, jdec, jdraft)):
        eng = cls(dec, page_size=4, max_seq_len=CFG["max_len"],
                  draft=draft, **kw)
        reqs = [eng.submit(p, n) for p, n in zip(prompts, max_news)]
        eng.run(timeout=300)
        out.append(([r.get(timeout=1) for r in reqs], eng.stats(), eng,
                    reqs))
    (t_tok, t_st, t_eng, t_reqs), (j_tok, j_st, _, _) = out
    assert t_tok == j_tok
    for key in SPEC_KEYS:
        assert t_st[key] == j_st[key], key
    assert sum(r.accepted_tokens for r in t_reqs) == \
        t_st["spec_accepted_tokens"]
    return t_tok, t_st, t_eng


def _dense_rows(jdec, prompts, max_news):
    return [[int(t) for t in
             jdec.generate(p[None, :], max_len=len(p) + n)[0]]
            for p, n in zip(prompts, max_news)]


def _balanced(eng):
    acc = eng.page_accounting()
    assert acc["leaked"] == 0
    assert acc["free"] + acc["held_by_trie"] == acc["total_usable"]
    assert acc["refs_total"] == acc["held_by_slots"] + acc["held_by_trie"]


@pytest.mark.parametrize("variant", [{}, {"n_heads": 2, "n_kv_heads": 1}])
def test_draft_step_matches_jax(variant):
    """Two [S, W] draft steps — a catch-up chunk, then a chained
    proposal with one inactive slot writing the null row — give the
    JAX draft's argmax and caches."""
    params = _params(11, **variant)
    jdraft = models.decode.DraftDecoder(
        models.TransformerDecoder(params, n_layers=2, n_heads=2),
        num_slots=2, max_seq_len=16, window=3)
    tdraft = pt_decode.DraftDecoder(
        pt_decode.TransformerDecoder(
            {k: np.asarray(v) for k, v in params.items()}, n_layers=2,
            n_heads=2, device="cpu"),
        num_slots=2, max_seq_len=16, window=3)
    jk, jv = jdraft.init_caches()
    tk, tv = tdraft.init_caches()
    assert tuple(tk.shape) == tuple(jk.shape) == (2, 2, 17, tdraft.kv_heads,
                                                  8)
    assert tdraft.cache_bytes() == jdraft.cache_bytes()
    feeds = [(np.array([[4, 8, 15], [16, 23, 0]]),
              np.array([[0, 1, 2], [0, 1, 0]]),
              np.array([[1, 1, 1], [1, 1, 0]], bool)),
             (np.array([[37, 0, 0], [0, 0, 0]]),
              np.array([[3, 0, 0], [0, 0, 0]]),
              np.array([[1, 0, 0], [0, 0, 0]], bool))]
    for toks, pos, act in feeds:
        jo, jk, jv = jdraft.step(jk, jv, toks, pos, act)
        to, tk, tv = tdraft.step(tk, tv, toks, pos, act)
        np.testing.assert_array_equal(to[act], np.asarray(jo)[act])
    # rows 0..T-1 (the null row T takes whichever masked write lands
    # last; it is never read)
    np.testing.assert_allclose(tk.numpy()[:, :, :16],
                               np.asarray(jk)[:, :, :16], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy()[:, :, :16],
                               np.asarray(jv)[:, :, :16], rtol=1e-5,
                               atol=1e-6)


def test_same_weights_draft_multi_token_commits():
    jdec, tdec = _pair()
    rng = np.random.RandomState(5)
    prompts = _ragged(rng, 3)
    max_news = [10, 8, 12]
    toks, st, eng = _serve_both(jdec, tdec, jdec, tdec, prompts, max_news,
                                num_slots=3, spec_k=2)
    assert toks == _dense_rows(jdec, prompts, max_news)
    assert st["window"] == 3 and st["spec_k"] == 2
    assert st["spec_accepted_tokens"] > 0
    # a perfect draft makes multi-token commits the norm
    assert st["tokens_out"] > st["steps"]
    _balanced(eng)


def test_disagreeing_draft_still_token_identical():
    """A draft from another seed proposes mostly-wrong tokens:
    acceptance filters them; rejected rows are masked by kv_len and
    overwritten before they can be read."""
    jdec, tdec = _pair()
    jdraft, tdraft = _pair(seed=11)
    rng = np.random.RandomState(6)
    prompts = _ragged(rng, 3)
    max_news = [8, 10, 6]
    toks, st, eng = _serve_both(jdec, tdec, jdraft, tdraft, prompts,
                                max_news, num_slots=2, spec_k=2)
    assert toks == _dense_rows(jdec, prompts, max_news)
    assert st["spec_proposed_tokens"] >= st["spec_accepted_tokens"]
    assert st["spec_proposed_tokens"] > 0
    _balanced(eng)


def test_mqa_spec_identity():
    jdec, tdec = _pair(seed=3, n_kv_heads=1)
    jdraft, tdraft = _pair(seed=3, n_kv_heads=1)
    assert tdec.kv_heads == 1
    rng = np.random.RandomState(7)
    prompts = _ragged(rng, 2, lo=3, hi=7)
    toks, st, eng = _serve_both(jdec, tdec, jdraft, tdraft, prompts,
                                [9, 7], num_slots=2, spec_k=2)
    assert toks == _dense_rows(jdec, prompts, [9, 7])
    assert st["spec_accepted_tokens"] > 0
    _balanced(eng)


def test_int8_pages_with_speculation_match_jax():
    """Both options together: int8 pages under the W = 3 verify
    window, tokens and counters equal to the JAX engine's."""
    jdec, tdec = _pair()
    rng = np.random.RandomState(9)
    prompts = _ragged(rng, 3, lo=4, hi=10)
    toks, st, eng = _serve_both(jdec, tdec, jdec, tdec, prompts,
                                [7, 9, 5], num_slots=2, spec_k=2,
                                kv_quant="int8")
    assert st["kv_quant"] == "int8" and st["kv_quant_bits"] == 8
    assert eng.paged.kv_quant == "int8"
    assert st["spec_accepted_tokens"] > 0
    _balanced(eng)


def test_speculation_requires_greedy():
    _, tdec = _pair()
    with pytest.raises(ValueError, match="greedy"):
        DecodeEngine(tdec, draft=tdec, spec_k=2, temperature=0.8,
                     max_seq_len=16)


def test_spec_k_without_draft_is_plain_decode():
    _, tdec = _pair()
    eng = DecodeEngine(tdec, spec_k=3, max_seq_len=16)
    assert eng.spec_k == 0 and eng.window == 1 and eng.draft is None


def test_cli_passes_spec_and_two_tier_flags(tmp_path):
    """``serve --draft_config --spec_k --kv_quant --kv_spill_pages``
    reach the engine through ``_build_engine``."""
    from paddle_tpu_torch import cli
    params = {k: np.asarray(v) for k, v in _params().items()}
    np.savez(tmp_path / "w.npz", **params)
    body = ("import numpy as np\n"
            "from paddle_tpu_torch.models import TransformerDecoder\n"
            f"w = dict(np.load({str(tmp_path / 'w.npz')!r}))\n"
            "decoder = TransformerDecoder(w, n_layers=2, n_heads=2,\n"
            "                             device='cpu')\n")
    (tmp_path / "target.py").write_text(body)
    (tmp_path / "draft.py").write_text(body)
    args = cli.build_parser().parse_args(
        ["serve", "--decode_config", str(tmp_path / "target.py"),
         "--draft_config", str(tmp_path / "draft.py"), "--spec_k", "2",
         "--kv_quant", "int8", "--kv_spill_pages", "6",
         "--gen_slots", "2", "--gen_page_size", "4"])
    eng = cli._build_engine(args)
    assert eng.spec_k == 2 and eng.window == 3 and eng.draft is not None
    assert eng.kv_quant == "int8" and eng.spill.capacity == 6
    r = eng.submit([1, 2, 3], 5)
    eng.run(timeout=60)
    assert len(r.get(timeout=1)) == 5
    plain = cli._build_engine(cli.build_parser().parse_args(
        ["serve", "--decode_config", str(tmp_path / "target.py")]))
    assert plain.draft is None and plain.kv_quant is None
    assert plain.spill is None
