"""The rankers behind the port's ``Engine`` and ``cli.main``, against the
JAX package at f32: ``rank_batch`` for each of the eight rankers (and DSSM
with ``use_charngram``) equal to the JAX ``Engine``'s (1e-5 abs, 1e-5 of
the largest score above 1) over five requests past one bucket of 4, with
history (which a ranker ignores) and a short slate; ``suggest_batch``,
``index_documents`` and ``rank_indexed_batch`` refused with ``ServeError``;
a checkpoint -> ``Engine.from_checkpoint`` round trip with equal scores;
the card asked for without one raises; ``cli.main`` trains each ranker
(MAP validation), tests, and ``--only_test`` reproduces the test
metrics.
"""

import numpy as np
import pytest
import torch
from test_torch_rank_models import port_config, rank_setup

from context_attentive_ir_tpu.serve import Engine as JaxEngine
from context_attentive_ir_tpu_torch.cli.main import main
from context_attentive_ir_tpu_torch.config import RunConfig
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.data import Dictionary as PortDictionary
from context_attentive_ir_tpu_torch.data import write_fixture
from context_attentive_ir_tpu_torch.models import build_model
from context_attentive_ir_tpu_torch.serve import Engine, ServeError
from context_attentive_ir_tpu_torch.train import (
    Checkpointer,
    Trainer,
    create_train_state,
)

BUCKET = 4
VARIANTS = {
    "esm": ("esm", {}),
    "dssm": ("dssm", {}),
    "dssm-charngram": ("dssm", dict(use_charngram=True)),
    "cdssm": ("cdssm", dict(filter_widths=(2, 3))),
    "duet": ("duet", {}),
    "arci": ("arci", dict(filter_widths=(2, 3))),
    "arcii": ("arcii", {}),
    "drmm": ("drmm", {}),
    "match_tensor": ("match_tensor", {}),
}


def _requests(st):
    """Five requests: the setup's queries with their slates (one cut to 2
    documents), history on all but one."""
    join = " ".join
    out = []
    for i, q in enumerate(st.examples[:5]):
        docs = [join(d.tokens) for d in q.documents][:4]
        history = [] if i == 2 else ["an earlier query",
                                     ("another one", [docs[0]])]
        out.append((join(q.tokens), docs[: 2 if i == 1 else 4], history))
    return out


def _engines(st, **kw):
    pcfg = port_config(st.cfg)
    jax_eng = JaxEngine(st.cfg, st.word_dict, st.params,
                        batch_bucket=BUCKET)
    port_eng = Engine(pcfg, PortDictionary.from_json(st.word_dict.to_json()),
                      params_from_jax(st.params, pcfg), batch_bucket=BUCKET,
                      device="cpu", **kw)
    return jax_eng, port_eng


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_engine_rank_batch_matches_jax(variant):
    model_type, overrides = VARIANTS[variant]
    st = rank_setup(model_type, **overrides)
    jax_eng, port_eng = _engines(st)
    assert port_eng.family == "ranker"
    reqs = _requests(st)
    ref, got = jax_eng.rank_batch(reqs), port_eng.rank_batch(reqs)
    assert [len(r) for r in got] == [len(r) for r in ref] == [
        len(r[1]) for r in reqs]
    ref, got = np.concatenate(ref), np.concatenate(got)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    # a ranker is session-blind: the history changes nothing
    bare = [(q, docs, ()) for q, docs, _ in reqs]
    np.testing.assert_array_equal(np.concatenate(port_eng.rank_batch(bare)),
                                  got)
    assert port_eng.rank(*reqs[0]) == port_eng.rank_batch(reqs[:1])[0]


def test_engine_refusals_and_checkpoint_round_trip(tmp_path):
    st = rank_setup("arcii")
    _, eng = _engines(st)
    with pytest.raises(ServeError, match="cannot suggest"):
        eng.suggest_batch([["a query"]])
    with pytest.raises(ServeError, match="cannot suggest"):
        eng.suggest(["a query"])
    with pytest.raises(ServeError, match="cached-doc"):
        eng.index_documents(["a doc"])
    with pytest.raises(ServeError, match="cached-doc"):
        eng.rank_indexed_batch([("a query", [0], ())],
                               {"states": torch.zeros(1, 2, 8)})
    with pytest.raises(ServeError, match="slate size"):
        eng.rank_batch([("a query", ["d"] * 5, ())])
    pcfg = port_config(st.cfg)
    model = build_model(pcfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(st.params, pcfg))
    ckpt = Checkpointer(str(tmp_path), "arcii", async_save=False)
    ckpt.save_best(create_train_state(model, pcfg), pcfg, eng.word_dict,
                   {"epoch": 0})
    loaded = Engine.from_checkpoint(ckpt.best_path, batch_bucket=BUCKET,
                                    device="cpu")
    reqs = _requests(st)
    assert loaded.rank_batch(reqs) == eng.rank_batch(reqs)


def test_ranker_needs_the_card_when_asked(monkeypatch, tmp_path):
    st = rank_setup("match_tensor")
    pcfg = port_config(st.cfg)
    params = params_from_jax(st.params, pcfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Engine(pcfg, PortDictionary(), params)
    with pytest.raises(RuntimeError, match="is_available"):
        Trainer(pcfg, RunConfig(model_dir=str(tmp_path)), PortDictionary())


@pytest.mark.parametrize("model_type", sorted(VARIANTS.keys() - {
    "dssm-charngram"}))
def test_main_end_to_end(tmp_path, model_type):
    """``cli.main`` trains each ranker on a fixture for two epochs (MAP
    validation), the metric table has the ranking columns and no BLEU, the
    rank dump is written and no hypothesis dump, and ``--only_test``
    reproduces the test metrics; ARC-II's train loss falls (an epoch's
    loss on 12 sessions is too noisy to hold the others to)."""
    train = write_fixture(tmp_path / "train.jsonl", n_sessions=12,
                          n_candidates=4, seed=0)
    dev = write_fixture(tmp_path / "dev.jsonl", n_sessions=4,
                        n_candidates=4, seed=1)
    common = ["--model_type", model_type, "--test_file", str(dev),
              "--model_dir", str(tmp_path / "runs"), "--model_name", "m",
              "--emsize", "16", "--nhid_ffnn", "16", "--nfilters", "4",
              "--max_query_len", "5", "--max_doc_len", "7",
              "--num_candidates", "4", "--test_batch_size", "8",
              "--device", "cpu"]
    results = main([*common, "--train_file", str(train), "--dev_file",
                    str(dev), "--num_epochs", "2", "--batch_size", "4",
                    "--learning_rate", "0.01", "--dropout", "0",
                    "--valid_metric", "map", "--prefetch_batches", "0"])
    hist = results["fit"]["history"]
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    if model_type == "arcii":
        assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    for cols in (hist[-1], results["test"]):
        assert {"map", "mrr", "ndcg@10"} <= set(cols)
        assert "bleu-1" not in cols
    runs = tmp_path / "runs"
    assert (runs / "m.test.ranks.jsonl").read_text().strip()
    assert not (runs / "m.test.hyps.jsonl").exists()
    retest = main([*common, "--only_test"])
    assert retest["test"] == results["test"]
