"""The port's host data layer against the JAX package's: the synthetic
fixture writers byte for byte, ``load_data`` / ``load_embeddings`` on the
same files, and the batch streams of the Trainer's iterators (plain,
bucketed, packed, packed-bucketed; a short last batch; resume from a later
batch) bit for bit, dtypes included, for the same sessions, seed and epoch.
``prefetch`` keeps order, passes an exception on and stops on an early
close."""

import dataclasses
import time

import numpy as np
import pytest

from context_attentive_ir_tpu import data as jdata
from context_attentive_ir_tpu.config import default_config as jax_config
from context_attentive_ir_tpu.data import synthetic as jsyn
from context_attentive_ir_tpu.train.trainer import (
    make_iterator as jax_make_iterator,
)
from context_attentive_ir_tpu_torch import data as pdata
from context_attentive_ir_tpu_torch.config import default_config
from context_attentive_ir_tpu_torch.data import pipeline as ppipe
from context_attentive_ir_tpu_torch.data import synthetic as psyn
from context_attentive_ir_tpu_torch.train.trainer import make_iterator

DIMS = dict(max_query_len=6, max_doc_len=8, max_session_len=4,
            num_candidates=5)


# -- fixtures and loaders --------------------------------------------------

WRITERS = {
    "write_fixture": dict(n_sessions=7, n_candidates=5, seed=3),
    "write_ambiguous_fixture": dict(n_sessions=6, seed=4),
    "write_suggestion_fixture": dict(n_sessions=6, seed=5),
    "write_aol_scale_fixture": dict(n_sessions=4, n_topics=30,
                                    words_per_topic=5, max_turns=3,
                                    n_candidates=6, seed=6),
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_synthetic_writers_byte_equal(tmp_path, writer):
    kw = WRITERS[writer]
    a = getattr(jsyn, writer)(tmp_path / "jax.jsonl", **kw)
    b = getattr(psyn, writer)(tmp_path / "port.jsonl", **kw)
    blob = a.read_bytes()
    assert blob and blob == b.read_bytes()


def test_synthetic_module_has_the_same_surface():
    names = [n for n in dir(jsyn) if not n.startswith("_")
             and callable(getattr(jsyn, n))]
    assert "generate_aol_scale_sessions" in names
    assert all(hasattr(psyn, n) for n in names)
    assert psyn.aol_scale_vocab(3, 2) == jsyn.aol_scale_vocab(3, 2)
    assert psyn.ambiguous_vocab() == jsyn.ambiguous_vocab()


def test_glove_fixture_and_embeddings_equal(tmp_path):
    words = [f"w{i}" for i in range(20)] + ["zebra"]
    a = jsyn.write_glove_fixture(tmp_path / "jax.txt", 8, 1, words)
    b = psyn.write_glove_fixture(tmp_path / "port.txt", 8, 1, words)
    assert a.read_bytes() == b.read_bytes()
    assert (pdata.load_embedding_words(str(b))
            == jdata.load_embedding_words(str(a)))
    streams = [words[:12], ["unseen", "w3"]]
    jd = jdata.build_dictionary(streams)
    pd_ = pdata.build_dictionary(streams)
    jm, jn = jdata.load_embeddings(str(a), jd, 8)
    pm, pn = pdata.load_embeddings(str(b), pd_, 8)
    assert jn == pn and pm.dtype == jm.dtype
    np.testing.assert_array_equal(pm, jm)


def _load(mod, path, **kw):
    return mod.load_data(str(path), DIMS["max_query_len"],
                         DIMS["max_doc_len"], DIMS["num_candidates"],
                         DIMS["max_session_len"], **kw)


def _flat(sessions):
    return [(s.session_id, [(q.query_id, q.tokens, [(d.doc_id, d.tokens, d.label)
                                              for d in q.documents])
                            for q in s.queries]) for s in sessions]


def test_load_data_equal(tmp_path):
    path = psyn.write_fixture(tmp_path / "s.jsonl", n_sessions=9,
                              n_candidates=7, seed=2)
    assert _flat(_load(pdata, path)) == _flat(_load(jdata, path))
    assert (_flat(_load(pdata, path, max_examples=4))
            == _flat(_load(jdata, path, max_examples=4)))
    assert len(_load(pdata, path, max_examples=4)) == 4


# -- the iterators' batch streams -------------------------------------------


def _setup(tmp_path, model_type, n=13):
    path = psyn.write_fixture(tmp_path / "s.jsonl", n_sessions=n,
                              n_candidates=5, seed=0)
    js, ps = _load(jdata, path), _load(pdata, path)
    streams = [t for s in ps for q in s.queries
               for t in [q.tokens] + [d.tokens for d in q.documents]]
    jd, pd_ = jdata.build_dictionary(streams), pdata.build_dictionary(streams)
    assert jd.to_json() == pd_.to_json()
    jcfg = jax_config(model_type, vocab_size=len(jd), **DIMS)
    pcfg = default_config(model_type, vocab_size=len(pd_), **DIMS)
    return (js, jd, jcfg), (ps, pd_, pcfg)


def _assert_batch_equal(jb, pb):
    for f in dataclasses.fields(pb):
        a, b = np.asarray(getattr(jb, f.name)), getattr(pb, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


MODES = {
    "plain": dict(),
    "packed": dict(pack=True),
    "bucketed": dict(session_buckets=(2, 4)),
    "packed_bucketed": dict(session_buckets=(2, 4), pack=True),
}


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_cars_batch_streams_bit_equal(tmp_path, mode, shuffle):
    (js, jd, jcfg), (ps, pd_, pcfg) = _setup(tmp_path, "cars")
    kw = dict(batch_size=4, shuffle=shuffle, seed=5, **MODES[mode])
    jit = jax_make_iterator(js, jcfg, jd, **kw)
    pit = make_iterator(ps, pcfg, pd_, **kw)
    assert len(jit) == len(pit) and len(ps) % 4 != 0   # a short last batch
    for epoch in (0, 2):
        jbs, pbs = list(jit.epoch(epoch)), list(pit.epoch(epoch))
        assert len(jbs) == len(pbs) == len(pit)
        for jb, pb in zip(jbs, pbs):
            _assert_batch_equal(jb, pb)
        assert sum(int(b.row_mask.sum()) for b in pbs) == len(ps)
    # the (epoch_seed, position) resume contract
    for jb, pb in zip(jit.epoch(1, start_batch=2),
                      pit.epoch(1, start_batch=2)):
        _assert_batch_equal(jb, pb)


@pytest.mark.parametrize("pack", [False, True])
def test_recommender_batch_streams_bit_equal(tmp_path, pack):
    (js, jd, jcfg), (ps, pd_, pcfg) = _setup(tmp_path, "hredqs")
    kw = dict(batch_size=4, shuffle=True, seed=9, pack=pack)
    jit = jax_make_iterator(js, jcfg, jd, **kw)
    pit = make_iterator(ps, pcfg, pd_, **kw)
    assert len(jit) == len(pit) > 1
    for epoch in (0, 1):
        for jb, pb in zip(jit.epoch(epoch), pit.epoch(epoch)):
            _assert_batch_equal(jb, pb)
    assert (pdata.suggest_examples(ps)[3][2].tokens
            == jdata.suggest_examples(js)[3][2].tokens)


def test_packed_equals_unpacked_within_the_port(tmp_path):
    _, (ps, pd_, pcfg) = _setup(tmp_path, "cars", n=11)
    for buckets in ((), (2, 4)):
        base = make_iterator(ps, pcfg, pd_, 4, True, 7,
                             session_buckets=buckets)
        packed = make_iterator(ps, pcfg, pd_, 4, True, 7,
                               session_buckets=buckets, pack=True)
        assert type(base) is not type(packed) and packed.nbytes > 0
        for a, b in zip(base.epoch(1), packed.epoch(1)):
            _assert_batch_equal(a, b)
        assert [int(b.row_mask.sum()) for b in packed.epoch(0)] \
            == [int(b.row_mask.sum()) for b in base.epoch(0)]


def test_ranker_iterator_is_not_ported(tmp_path):
    """The ranker iterator is ported (its streams are held to JAX's in
    ``tests/test_torch_rank_data.py``): a DSSM stream equals JAX's here
    too; an unknown model type raises."""
    (js, jd, _), (ps, pd_, _) = _setup(tmp_path, "cars", n=3)
    jcfg = jax_config("dssm", vocab_size=len(jd), **DIMS)
    cfg = default_config("dssm", vocab_size=len(pd_), **DIMS)
    jbs = list(jax_make_iterator(js, jcfg, jd, 4, False, 0))
    pbs = list(make_iterator(ps, cfg, pd_, 4, False, 0))
    assert len(pbs) == len(jbs) > 0
    for jb, pb in zip(jbs, pbs):
        assert isinstance(pb, pdata.RankBatch) and pb.query_chars is None
        for f in ("query", "query_mask", "docs", "doc_mask", "labels",
                  "cand_mask", "row_mask"):
            np.testing.assert_array_equal(np.asarray(getattr(jb, f)),
                                          getattr(pb, f), err_msg=f)
    with pytest.raises(ValueError, match="unknown model_type"):
        make_iterator(ps, cfg.replace(model_type="bert"), pd_, 4, False, 0)


def test_packed_iterator_needs_a_batch():
    with pytest.raises(TypeError, match="row_mask"):
        ppipe.PackedIterator([1, 2], lambda e, batch_size: {"x": e}, 2)


# -- prefetch -----------------------------------------------------------------


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_preserves_order(depth):
    items = list(range(57))
    assert list(ppipe.prefetch(iter(items), depth=depth)) == items


def test_prefetch_propagates_producer_exception():
    def gen():
        yield 1
        yield 2   # fills depth=2; the raise then meets a full queue
        raise ValueError("late boom")

    it = ppipe.prefetch(gen(), depth=2)
    time.sleep(0.3)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(ValueError, match="late boom"):
        next(it)


def test_prefetch_early_close_stops_producer():
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = ppipe.prefetch(gen(), depth=2)
    for _ in range(3):
        next(it)
    it.close()   # must not hang: the blocked producer observes the stop
    assert len(produced) < 10_000
