"""The port's copied metrics (``eval/*``) and its coverage penalties against
the JAX package's on seeded inputs, and ``beam_search`` with a coverage
penalty on a CARS logits step against the JAX ``beam_search``: tokens equal,
scores within 1e-5 (f32; the penalty sums logs of f32 attention masses).

Metrics are numpy / pure-Python copies, so they must agree exactly.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cars import port_batch, port_model, tiny_setup

from context_attentive_ir_tpu import eval as jeval
from context_attentive_ir_tpu.decode import beam_search as jax_beam_search
from context_attentive_ir_tpu.decode import penalties as jpen
from context_attentive_ir_tpu.eval.rouge import (
    rouge_l_sentence as jax_rouge_l_sentence,
)
from context_attentive_ir_tpu_torch import eval as peval
from context_attentive_ir_tpu_torch.decode import beam_search
from context_attentive_ir_tpu_torch.decode import penalties as ppen
from context_attentive_ir_tpu_torch.eval.rouge import rouge_l_sentence

SEEDS = (0, 1, 2)


def _ranking_inputs(seed, rows=17, n=9):
    rng = np.random.RandomState(seed)
    scores = rng.normal(size=(rows, n)).astype(np.float32)
    scores[3, 2] = scores[3, 5]            # a tie
    labels = (rng.rand(rows, n) < 0.25).astype(np.float32)
    labels[1] = 0                          # a row without a positive
    cand = rng.rand(rows, n) < 0.8
    cand[:, 0] = True
    row_mask = rng.rand(rows) < 0.85
    return scores, labels, cand, row_mask


def _texts(seed, n=23):
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(12)]

    def sent(lo=0, hi=8):
        return [words[i] for i in rng.randint(12, size=rng.randint(lo, hi))]

    hyps = [sent() for _ in range(n)]
    refs = [[sent(1)] + ([sent(1)] if rng.rand() < 0.3 else [])
            for _ in range(n)]
    hyps[0] = list(refs[0][0])             # an exact match
    return hyps, refs


def test_same_public_surface():
    assert sorted(peval.__all__) == sorted(jeval.__all__)


@pytest.mark.parametrize("seed", SEEDS)
def test_ranking_metrics_equal(seed):
    args = _ranking_inputs(seed)
    got, want = peval.ranking_metrics(*args), jeval.ranking_metrics(*args)
    assert got == want and {"map", "mrr", "ndcg@10"} <= set(got)
    s, l, c, _ = args
    for name in ("average_precision", "reciprocal_rank"):
        np.testing.assert_array_equal(getattr(peval, name)(s, l, c),
                                      getattr(jeval, name)(s, l, c))
    for k in (1, 3, 10):
        np.testing.assert_array_equal(peval.ndcg_at_k(s, l, c, k),
                                      jeval.ndcg_at_k(s, l, c, k))
        np.testing.assert_array_equal(peval.precision_at_k(s, l, c, k),
                                      jeval.precision_at_k(s, l, c, k))


def _ranker_batches(layout, seed=5):
    """Two host batches and their scores: a ranker's ``[B, N]`` slates
    (``labels``, ``row_mask``) or a session model's ``[B, S, N]`` turns
    (``clicks``, ``turn_mask``), made with numpy."""
    rng = np.random.RandomState(seed)
    out = []
    for b in (6, 4):
        lead = (b,) if layout == "flat" else (b, 3)
        labels = (rng.rand(*lead, 7) < 0.3).astype(np.float32)
        cand = rng.rand(*lead, 7) < 0.85
        cand[..., 0] = True
        row_mask = rng.rand(b) < 0.8
        row_mask[0] = True
        batch = SimpleNamespace(cand_mask=cand, row_mask=row_mask)
        if layout == "flat":
            batch.labels = labels
        else:
            batch.clicks = labels
            batch.turn_mask = rng.rand(b, 3) < 0.7
        out.append((batch, rng.normal(size=(*lead, 7)).astype(np.float32)))
    return out


@pytest.mark.parametrize("layout", ["flat", "session"])
def test_evaluate_ranker_matches_jax(tmp_path, layout):
    """The port's ``evaluate_ranker`` against the JAX one on the same scores
    and batches: ranker slates ``[B, N]`` and session turns ``[B, S, N]``,
    the same metrics and the same dump file."""
    from context_attentive_ir_tpu.train.evaluate import (
        evaluate_ranker as jax_evaluate_ranker,
    )
    from context_attentive_ir_tpu_torch.train import evaluate_ranker

    pairs = _ranker_batches(layout)
    scores = {id(b): s for b, s in pairs}
    batches = [b for b, _ in pairs]
    got = evaluate_ranker(lambda b: scores[id(b)], batches,
                          tmp_path / "port.jsonl")
    want = jax_evaluate_ranker(lambda params, b: jnp.asarray(scores[id(b)]),
                               None, batches, tmp_path / "jax.jsonl")
    assert got == want and got["map"] > 0
    dump = (tmp_path / "port.jsonl").read_text()
    assert dump == (tmp_path / "jax.jsonl").read_text()
    rows = sum(int(b.row_mask.sum() if layout == "flat"
                   else (b.turn_mask & b.row_mask[:, None]).sum())
               for b in batches)
    assert len(dump.splitlines()) == rows


@pytest.mark.parametrize("seed", SEEDS)
def test_text_metrics_equal(seed):
    hyps, refs = _texts(seed)
    for smooth in (False, True):
        assert (peval.bleu_metrics(hyps, refs, smooth)
                == jeval.bleu_metrics(hyps, refs, smooth))
        assert (peval.corpus_bleu(hyps, refs, max_n=4, smooth=smooth)
                == jeval.corpus_bleu(hyps, refs, max_n=4, smooth=smooth))
    assert peval.rouge_metrics(hyps, refs) == jeval.rouge_metrics(hyps, refs)
    assert peval.corpus_rouge_l(hyps, refs) == jeval.corpus_rouge_l(hyps,
                                                                    refs)
    assert [rouge_l_sentence(h, r) for h, r in zip(hyps, refs)] \
        == [jax_rouge_l_sentence(h, r) for h, r in zip(hyps, refs)]
    first = [r[0] for r in refs]
    assert peval.exact_match(hyps, first) == jeval.exact_match(hyps, first)
    assert peval.exact_match(hyps, first) > 0
    assert peval.token_f1(hyps, first) == jeval.token_f1(hyps, first)


@pytest.mark.parametrize("name", ["wu", "summary"])
def test_coverage_penalties_match_jax(name):
    rng = np.random.RandomState(3)
    cov = (rng.rand(4, 3, 7) * 1.6).astype(np.float32)
    cov[0, 0, 0] = 0.0                     # the clip at 1e-6
    mask = rng.rand(4, 1, 7) < 0.7
    want = jpen.COVERAGE_PENALTIES[name](jnp.asarray(cov), jnp.asarray(mask),
                                         0.3)
    got = ppen.COVERAGE_PENALTIES[name](torch.from_numpy(cov),
                                        torch.from_numpy(mask), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (got <= 0).all() and (got < 0).any()


@pytest.fixture(scope="module")
def decode_setup():
    jm, cfg, params, batch, _, _ = tiny_setup()
    var = {"params": params}
    jstate, jmem, jmask = jm.apply(var, batch, method=jm.decode_init)
    pm = port_model(cfg, params)
    pstate, pmem, pmask = pm.decode_init(port_batch(batch))
    return jm, var, (jstate, jmem, jmask), pm, (pstate, pmem, pmask), cfg


K, BETA = 3, 0.4


def _decode(decode_setup, **kw):
    jm, var, (jstate, jmem, jmask), pm, (pstate, pmem, pmask), cfg = \
        decode_setup
    rows, max_len = jmem.shape[0], cfg.max_query_len + 1
    jmem_k, jmask_k = (jnp.repeat(a, K, axis=0) for a in (jmem, jmask))
    want = jax_beam_search(
        lambda st, toks: jm.apply(var, st, toks, jmem_k, jmask_k,
                                  method=jm.decode_step),
        jstate, rows, max_len, K, cov_mask=jmask, return_nbest=True, **kw)
    pmem_k, pmask_k = (a.repeat_interleave(K, dim=0) for a in (pmem, pmask))
    got = beam_search(
        lambda st, toks: pm.decode_step(st, toks, pmem_k, pmask_k),
        pstate, rows, max_len, K, cov_mask=pmask, return_nbest=True, **kw)
    return got, want


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("penalty", ["wu", "summary"])
def test_beam_search_with_coverage_matches_jax(decode_setup, penalty,
                                               early_exit):
    kw = dict(coverage_beta=BETA, coverage_penalty=penalty,
              early_exit=early_exit)
    (seqs, scores), (jseqs, jscores) = _decode(decode_setup, **kw)
    jscores = np.asarray(jscores)
    live = jscores > -1e8      # beams that never left NEG_INF carry no order
    assert live[:, 0].all()
    np.testing.assert_array_equal(seqs.numpy()[live], np.asarray(jseqs)[live])
    np.testing.assert_allclose(scores.numpy()[live], jscores[live], rtol=0,
                               atol=1e-5)


def test_coverage_penalty_moves_the_scores(decode_setup):
    """beta = 0 leaves the port's scores where they were; the Wu penalty
    only lowers them (it is <= 0) and does so for some beam."""
    (_, base), (_, jbase) = _decode(decode_setup)
    (_, off), _ = _decode(decode_setup, coverage_beta=0.0)
    (_, wu), _ = _decode(decode_setup, coverage_beta=BETA)
    assert torch.equal(base, off)
    np.testing.assert_allclose(base.numpy()[:, 0], np.asarray(jbase)[:, 0],
                               rtol=0, atol=1e-5)
    assert float(wu[:, 0].max()) < float(base[:, 0].max())


def test_fused_step_takes_no_coverage():
    """A fused-generator step exposes no attention: with coverage_beta > 0
    the ranking is the plain one."""
    rng = np.random.RandomState(5)
    table = torch.from_numpy(rng.normal(size=(6, 30)).astype(np.float32))

    def step(state, toks):
        logits = state["h"] @ table
        vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        return state, (vals[:, :K + 1], idx[:, :K + 1],
                       torch.logsumexp(logits, -1)), None

    init = {"h": torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))}
    a = beam_search(step, init, 4, 5, K)
    b = beam_search(step, init, 4, 5, K, coverage_beta=BETA)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
