"""The port's native vectorizer (``data/fast.py`` over
``native/fastvec.cpp``): ``encode_batch`` / ``encode_targets`` equal the
Python encoders and the JAX package's bindings on the same texts, the
native rank and session batches are bit-equal to the Python vectorizer's
and to the JAX package's native ones, and the ``Trainer`` routes its
collate through the native path when ``native_vectorizer`` is on and the
library builds.  Whether ``g++`` builds the library is decided inside each
test, never at collection."""

import dataclasses

import numpy as np
import pytest

from context_attentive_ir_tpu import data as jdata
from context_attentive_ir_tpu.data import fast as jfast
from context_attentive_ir_tpu.data import vectorize as jvec
from context_attentive_ir_tpu_torch import data as pdata
from context_attentive_ir_tpu_torch.config import RunConfig, default_config
from context_attentive_ir_tpu_torch.data import fast
from context_attentive_ir_tpu_torch.data.objects import Query
from context_attentive_ir_tpu_torch.data.vectorize import (
    _encode_target,
    _pad_ids,
)
from context_attentive_ir_tpu_torch.train import Trainer
from context_attentive_ir_tpu_torch.train.trainer import make_iterator

TEXTS = ["jazz guitar", "MOUNTAIN trail boots hiking pasta",
         "unknownword tomato", "", "jazz " * 20,
         # every ASCII whitespace str.split() splits on
         "jazz\rguitar\vchord\flesson", "  \r\n pasta\ttomato \v "]


@pytest.fixture
def native():
    if not fast.available():
        pytest.skip("g++ cannot build native/fastvec.cpp here")
    return fast


def _vocab(mod):
    words = ["jazz guitar chord lesson", "hiking boots trail Mountain",
             "pasta recipe tomato"]
    return mod.build_dictionary([w.split() for w in words])


def test_the_library_builds_apart_from_the_jax_package(native):
    path = native.build_native("fastvec")
    assert path.parent == native.NATIVE_BUILD
    assert path.name == "libfastvec.so" and path.exists()
    assert native.get_lib() is native.get_lib()


def test_encode_batch_matches_python_and_jax(native):
    vocab = _vocab(pdata)
    fv = native.FastVocab(vocab)
    assert fv.size == len(vocab)
    ids, mask = fv.encode_batch(TEXTS, max_len=8)
    for i, t in enumerate(TEXTS):
        ref_ids, ref_mask = _pad_ids(vocab.encode(t.split()), 8)
        np.testing.assert_array_equal(ids[i], ref_ids, err_msg=t)
        np.testing.assert_array_equal(mask[i], ref_mask, err_msg=t)
    if jfast.available():
        j_ids, j_mask = jfast.FastVocab(_vocab(jdata)).encode_batch(TEXTS, 8)
        np.testing.assert_array_equal(ids, j_ids)
        np.testing.assert_array_equal(mask, j_mask)


def test_encode_targets_matches_python(native):
    vocab = _vocab(pdata)
    fv = native.FastVocab(vocab)
    texts = ["jazz guitar chord", "", "pasta " * 20]
    tin, tout, tmask = fv.encode_targets(texts, max_len=6)
    for i, t in enumerate(texts):
        rin, rout, rmask = _encode_target(Query("x", t.split()), vocab, 6)
        np.testing.assert_array_equal(tin[i], rin, err_msg=t)
        np.testing.assert_array_equal(tout[i], rout, err_msg=t)
        np.testing.assert_array_equal(tmask[i], rmask, err_msg=t)


def _sessions(mod):
    """Ragged sessions: turns past S, slates past N, long texts."""
    sessions = [mod.Session.from_dict(d) for d in
                mod.generate_sessions(n_sessions=7, n_candidates=6, seed=9)]
    sessions[0].queries = sessions[0].queries[:1]
    sessions[1].queries[0].documents = sessions[1].queries[0].documents[:2]
    streams = [q.tokens for s in sessions for q in s.queries]
    streams += [d.tokens for s in sessions for q in s.queries
                for d in q.documents]
    return sessions, mod.build_dictionary(streams)


SHAPES = dict(max_query_len=3, max_doc_len=5, max_session_len=3,
              num_candidates=5)


def _fields(batch):
    return {f.name: getattr(batch, f.name)
            for f in dataclasses.fields(batch)}


def _same(a, b):
    fa, fb = _fields(a), _fields(b)
    assert set(fa) == set(fb)
    for k in fa:
        if fa[k] is None:
            assert fb[k] is None, k
        else:
            assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(fa[k]),
                                          np.asarray(fb[k]), k)


@pytest.mark.parametrize("family", ["rank", "session"])
def test_native_batches_equal_python_and_jax(native, family):
    ps, pwd = _sessions(pdata)
    shapes = pdata.ShapeConfig(**SHAPES)
    fv = native.FastVocab(pwd)
    if family == "rank":
        ex = pdata.rank_examples(ps)
        B = len(ex) + 3
        plain = pdata.build_rank_batch(ex, pwd, shapes, batch_size=B)
        got = pdata.build_rank_batch(ex, pwd, shapes, batch_size=B, fast=fv)
    else:
        B = len(ps) + 2
        plain = pdata.build_session_batch(ps, pwd, shapes, batch_size=B)
        got = pdata.build_session_batch(ps, pwd, shapes, batch_size=B,
                                        fast=fv)
    _same(got, plain)
    if not jfast.available():
        return
    js, jwd = _sessions(jdata)
    jshapes = jvec.ShapeConfig(**SHAPES)
    jfv = jfast.FastVocab(jwd)
    if family == "rank":
        ref = jvec.build_rank_batch(jvec.rank_examples(js), jwd, jshapes,
                                    batch_size=B, fast=jfv)
        # the JAX native rank batch has no character-id fields set
        ref = dataclasses.replace(ref, query_chars=None, doc_chars=None)
    else:
        ref = jvec.build_session_batch(js, jwd, jshapes, batch_size=B,
                                       fast=jfv)
    for k, v in _fields(ref).items():
        if v is not None:
            np.testing.assert_array_equal(getattr(got, k), np.asarray(v), k)


# composed and decomposed accents, non-ASCII capitals, Unicode whitespace
# and the ASCII separators str.split() splits on: the library lowercases
# and splits plain ASCII only, so FastVocab normalizes these first
NON_ASCII = ["Caf\u00e9 cre\u0300me", "CAF\u00c9 \u00c9COLE jazz",
             "cafe\u0301\u00a0Cr\u00e8me\u2003\u00e9cole", "jazz\x1fguitar",
             "\u00e9cole " * 9 + "na\u00efve", "\u00df STRASSE stra\u00dfe"]


def _unicode_vocab(mod):
    return mod.build_dictionary([
        "caf\u00e9 cr\u00e8me \u00e9cole na\u00efve stra\u00dfe".split(),
        ["jazz", "guitar"]])


@pytest.mark.parametrize("what", ["encode_batch", "encode_targets", "rank",
                                  "session"])
def test_non_ascii_text_matches_python(native, what):
    vocab = _unicode_vocab(pdata)
    fv = native.FastVocab(vocab)
    if what == "encode_batch":
        ids, mask = fv.encode_batch(NON_ASCII, max_len=8)
        for i, t in enumerate(NON_ASCII):
            ref_ids, ref_mask = _pad_ids(vocab.encode(t.split()), 8)
            # the words are in the vocabulary: a miss would read UNK
            assert (ids[i][mask[i]] > 3).any(), t
            np.testing.assert_array_equal(ids[i], ref_ids, err_msg=t)
            np.testing.assert_array_equal(mask[i], ref_mask, err_msg=t)
        return
    if what == "encode_targets":
        tin, tout, tmask = fv.encode_targets(NON_ASCII, max_len=6)
        for i, t in enumerate(NON_ASCII):
            rin, rout, rmask = _encode_target(Query("x", t.split()), vocab, 6)
            np.testing.assert_array_equal(tin[i], rin, err_msg=t)
            np.testing.assert_array_equal(tout[i], rout, err_msg=t)
            np.testing.assert_array_equal(tmask[i], rmask, err_msg=t)
        return
    sessions = [pdata.Session.from_dict(
        {"session_id": f"s{i}", "query": [
            {"text": q, "candidates": [
                {"title": d, "label": int(j == 0)}
                for j, d in enumerate(NON_ASCII[i + 1:] + NON_ASCII[:i])]}
            for q in (NON_ASCII[i], NON_ASCII[-1 - i])]})
        for i in range(3)]
    shapes = pdata.ShapeConfig(**SHAPES)
    if what == "rank":
        ex = pdata.rank_examples(sessions)
        plain = pdata.build_rank_batch(ex, vocab, shapes, batch_size=8)
        got = pdata.build_rank_batch(ex, vocab, shapes, batch_size=8,
                                     fast=fv)
    else:
        plain = pdata.build_session_batch(sessions, vocab, shapes,
                                          batch_size=4)
        got = pdata.build_session_batch(sessions, vocab, shapes,
                                        batch_size=4, fast=fv)
    assert (plain.query[plain.query_mask] > 3).any()
    _same(got, plain)


def test_suggest_batch_takes_and_ignores_fast(native):
    ps, pwd = _sessions(pdata)
    shapes = pdata.ShapeConfig(**SHAPES)
    ex = pdata.suggest_examples(ps)
    _same(pdata.build_suggest_batch(ex, pwd, shapes, fast=object()),
          pdata.build_suggest_batch(ex, pwd, shapes))


def test_character_ids_keep_the_python_path(native):
    ps, pwd = _sessions(pdata)
    shapes = pdata.ShapeConfig(**SHAPES, max_word_len=4)
    ex = pdata.rank_examples(ps)
    got = pdata.build_rank_batch(ex, pwd, shapes, fast=native.FastVocab(pwd))
    assert got.query_chars is not None
    _same(got, pdata.build_rank_batch(ex, pwd, shapes))


@pytest.mark.parametrize("model_type,pack", [("cars", True), ("cars", False),
                                             ("dssm", True)])
def test_trainer_collates_natively(native, tmp_path, model_type, pack):
    ps, pwd = _sessions(pdata)
    cfg = default_config(model_type, vocab_size=len(pwd), **SHAPES,
                         emsize=8, nhid=4)
    trainer = Trainer(cfg, RunConfig(model_dir=str(tmp_path)), pwd,
                      device="cpu")
    assert isinstance(trainer.fast, native.FastVocab)
    off = Trainer(cfg, RunConfig(model_dir=str(tmp_path),
                                 native_vectorizer=False), pwd, device="cpu")
    assert off.fast is None
    a = make_iterator(ps, cfg, pwd, 3, True, 7, fast=trainer.fast, pack=pack)
    b = make_iterator(ps, cfg, pwd, 3, True, 7, pack=pack)
    for x, y in zip(a.epoch(1), b.epoch(1)):
        _same(x, y)


def test_trainer_without_the_library_vectorizes_in_python(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(fast, "available", lambda: False)
    _, pwd = _sessions(pdata)
    cfg = default_config("cars", vocab_size=len(pwd), **SHAPES, emsize=8,
                         nhid=4)
    trainer = Trainer(cfg, RunConfig(model_dir=str(tmp_path)), pwd,
                      device="cpu")
    assert trainer.fast is None
