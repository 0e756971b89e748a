"""Cached-document ranking and the suggestion shortlist: the port's
``Engine`` against a JAX ``Engine`` built from the same params.

- ``index_documents`` (states, mask, and the cached pooling projection);
- ``rank_indexed_batch`` in both layouts (one slate broadcast over the
  session, per-turn slates when the history carries clicked ids) and over
  a projection cache, and the JAX package's own identities
  (tests/test_serve.py): indexed equals full, batch equals single, the
  projection cache changes nothing;
- every ``ServeError`` of the indexed path;
- ``build_shortlist`` and ``Engine(suggest_shortlist=C)`` (beam and
  greedy tokens exact at f32; a shortlist covering the whole vocabulary
  reproduces the exact decode).
"""

import types

import numpy as np
import pytest
import torch
from test_torch_serve import REAL, served  # noqa: F401  (fixture)

from context_attentive_ir_tpu.decode.shortlist import (
    build_shortlist as jax_build_shortlist,
)
from context_attentive_ir_tpu.serve import Engine as JaxEngine
from context_attentive_ir_tpu_torch.decode import (
    beam_search,
    build_shortlist,
    make_fused_beam_step,
    make_shortlist_xla_step,
)
from context_attentive_ir_tpu_torch.serve import Engine as PortEngine
from context_attentive_ir_tpu_torch.serve import ServeError

BUCKET = 4
TOL = 1e-4   # as the port's rank_batch against JAX (tests/test_torch_serve)


def _join(tokens):
    return " ".join(tokens)


@pytest.fixture(scope="module")
def indexed(served):  # noqa: F811
    cfg, wd, params, (pcfg, pwd, psd), sessions = served
    jax_eng = JaxEngine(cfg, wd, params, beam_size=1, batch_bucket=BUCKET)
    port_eng = PortEngine(pcfg, pwd, psd, beam_size=1, batch_bucket=BUCKET,
                          device="cpu")
    corpus = [_join(d.tokens) for s in sessions[:4] for q in s.queries
              for d in q.documents]
    return jax_eng, port_eng, corpus, sessions


def _requests(sessions, corpus, clicks):
    """Three requests: one with a history, one without, one past the
    first; with ``clicks`` the history turns carry clicked doc ids."""
    rng = np.random.RandomState(0)
    n = len(corpus)
    reqs = []
    for s in sessions[:3]:
        *hist, cur = s.queries
        history = [(_join(q.tokens),
                    [int(i) for i in rng.choice(n, 2, replace=False)])
                   if clicks else _join(q.tokens) for q in hist]
        reqs.append((_join(cur.tokens),
                     [int(i) for i in rng.choice(n, 6, replace=False)],
                     history))
    reqs[1] = (reqs[1][0], reqs[1][1][:3], ())
    return reqs


def test_index_documents_matches_jax(indexed):
    jax_eng, port_eng, corpus, _ = indexed
    want = jax_eng.index_documents(corpus, cache_pool_proj=True)
    got = port_eng.index_documents(corpus, cache_pool_proj=True)
    assert got["states"].shape == (len(corpus),
                                   *np.asarray(want["states"]).shape[1:])
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    for k in ("states", "proj"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)
    assert port_eng.index_documents(corpus[:3])["proj"] is None


@pytest.mark.parametrize("proj", [False, True], ids=["states", "proj"])
@pytest.mark.parametrize("clicks", [False, True],
                         ids=["broadcast", "per-turn"])
def test_rank_indexed_batch_matches_jax(indexed, clicks, proj):
    jax_eng, port_eng, corpus, sessions = indexed
    reqs = _requests(sessions, corpus, clicks)
    want = jax_eng.rank_indexed_batch(
        reqs, jax_eng.index_documents(corpus, cache_pool_proj=proj))
    got = port_eng.rank_indexed_batch(
        reqs, port_eng.index_documents(corpus, cache_pool_proj=proj))
    assert [len(r) for r in got] == [len(r) for r in want]
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               rtol=0, atol=TOL)


def test_indexed_equals_full_ranking(indexed):
    """JAX identity (tests/test_serve.py:69): the cached path reproduces
    ``rank`` over the same document texts, in any order."""
    _, eng, _, sessions = indexed
    q = sessions[1].queries[-1]
    history = [_join(x.tokens) for x in sessions[1].queries[:-1]]
    docs = [_join(d.tokens) for d in q.documents]
    full = eng.rank(_join(q.tokens), docs, history)
    index = eng.index_documents(docs)
    np.testing.assert_allclose(
        eng.rank_indexed(_join(q.tokens), list(range(len(docs))), index,
                         history), full, rtol=0, atol=1e-5)
    sub = [2, 0, 3]
    np.testing.assert_allclose(
        eng.rank_indexed(_join(q.tokens), sub, index, history),
        [full[i] for i in sub], rtol=0, atol=1e-5)


@pytest.mark.parametrize("clicks", [False, True],
                         ids=["broadcast", "per-turn"])
def test_batch_equals_single(indexed, clicks):
    """JAX identity (tests/test_serve.py:154)."""
    _, eng, corpus, sessions = indexed
    index = eng.index_documents(corpus)
    reqs = _requests(sessions, corpus, clicks)
    batched = eng.rank_indexed_batch(reqs, index)
    for r, b in zip(reqs, batched):
        np.testing.assert_allclose(b, eng.rank_indexed(*r[:2], index, r[2]),
                                   rtol=0, atol=1e-5)


def test_pool_proj_cache_consistent(indexed):
    """JAX identity (tests/test_serve.py:222)."""
    _, eng, corpus, sessions = indexed
    reqs = _requests(sessions, corpus, True)
    a = eng.rank_indexed_batch(reqs, eng.index_documents(corpus, True))
    b = eng.rank_indexed_batch(reqs, eng.index_documents(corpus, False))
    np.testing.assert_allclose(np.concatenate(a), np.concatenate(b),
                               rtol=0, atol=1e-5)


def test_serve_errors(indexed):
    _, eng, corpus, _ = indexed
    index = eng.index_documents(corpus[:5])
    with pytest.raises(ServeError, match="exceed"):
        eng.rank_indexed_batch([("q", list(range(99)))],
                               {"states": None, "mask": None})
    with pytest.raises(ServeError, match="out of range"):
        eng.rank_indexed("q", [0, 5], index)
    with pytest.raises(ServeError, match="out of range"):
        eng.rank_indexed("q", [0], index, [("h", [-1])])
    with pytest.raises(ServeError, match="exceed"):
        eng.rank_indexed("q", [0], index, [("h", [0] * 99)])
    no_cache = PortEngine.__new__(PortEngine)
    no_cache.config = eng.config
    no_cache.model = types.SimpleNamespace()
    for call in (lambda: no_cache.index_documents(corpus),
                 lambda: no_cache.rank_indexed("q", [0], index)):
        with pytest.raises(ServeError, match="cached-doc"):
            call()


@pytest.mark.parametrize("size,source", [
    (16, [5, 9, 9, 200, -3, 10 ** 6]), (3, None), (40, list(range(4, 80))),
    (10 ** 6, [7]), (12, list(range(50, 70)))])
def test_build_shortlist_matches_jax(size, source):
    got = build_shortlist(size, 120, source)
    want = jax_build_shortlist(size, 120, source)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shortlist", [16, 40])
@pytest.mark.parametrize("beam_size", [5, 1])
def test_shortlist_engine_matches_jax(served, beam_size,  # noqa: F811
                                      shortlist):
    cfg, wd, params, (pcfg, pwd, psd), sessions = served
    hists = [[_join(q.tokens) for q in s.queries[:-1]]
             + [(_join(s.queries[-1].tokens),
                 [_join(d.tokens) for d in s.queries[-1].documents[:2]])]
             for s in sessions[:5]]
    ref = JaxEngine(cfg, wd, params, beam_size=beam_size,
                    batch_bucket=BUCKET,
                    suggest_shortlist=shortlist).suggest_batch(hists)
    got = PortEngine(pcfg, pwd, psd, beam_size=beam_size,
                     batch_bucket=BUCKET, suggest_shortlist=shortlist,
                     device="cpu").suggest_batch(hists)
    n_real = 0
    for nb_p, nb_j in zip(got, ref):
        assert len(nb_p) == len(nb_j)
        for (tp, sp), (tj, sj) in zip(nb_p, nb_j):
            if sj > REAL:
                n_real += 1
                assert tp == tj
                assert abs(sp - sj) <= 1e-4
    assert n_real >= len(hists)


def test_full_vocab_shortlist_is_exact(served):  # noqa: F811
    """A shortlist of every vocab id reproduces the exact decode, in the
    fused step and in the plain shortlist step; an Engine asked for a
    shortlist at least the vocabulary's size decodes exactly."""
    _, _, _, (pcfg, pwd, psd), sessions = served
    eng = PortEngine(pcfg, pwd, psd, beam_size=3, batch_bucket=BUCKET,
                     device="cpu")
    hists = [[_join(q.tokens) for q in s.queries] for s in sessions[:4]]
    from context_attentive_ir_tpu_torch.data import build_session_batch
    from context_attentive_ir_tpu_torch.data.objects import Session

    batch = build_session_batch(
        [Session("r", eng._history_queries(h)) for h in hists], pwd,
        eng.shapes, batch_size=4).to("cpu")
    model, K, T = eng.model, 3, eng.shapes.max_target_len
    everything = np.arange(pcfg.vocab_size, dtype=np.int32)
    with torch.inference_mode():
        state, memory, mask = model.decode_init(batch)
        rows = memory.shape[0]
        mem_k = memory.repeat_interleave(K, 0)
        mask_k = mask.repeat_interleave(K, 0)
        outs = [beam_search(make(model, mem_k, mask_k, K + 1, torch.float32,
                                 **kw), state, rows, T, K,
                            return_nbest=True)
                for make, kw in ((make_fused_beam_step, {}),
                                 (make_fused_beam_step,
                                  {"shortlist": everything}),
                                 (make_shortlist_xla_step,
                                  {"shortlist": everything}))]
    for seqs, scores in outs[1:]:
        assert torch.equal(seqs, outs[0][0])
        assert torch.equal(scores, outs[0][1])
    full = PortEngine(pcfg, pwd, psd, beam_size=3, batch_bucket=BUCKET,
                      suggest_shortlist=10 ** 6, device="cpu")
    assert full.suggest_shortlist == pcfg.vocab_size
    assert full.suggest_batch(hists) == eng.suggest_batch(hists)
