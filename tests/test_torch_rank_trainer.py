"""The port's ``Trainer`` against the JAX package's for the rankers DSSM,
ARC-II and Match-Tensor, from the same fixture file, ``RunConfig`` and
initial parameters (the JAX initialisation, through
``convert.params_from_jax``), at f32 with dropout 0: one JAX ``fit`` per
model (three epochs of Adam steps on ``RankBatch`` rows, MAP validation
each epoch), then ``test`` with its rank dump.  No decoder is built for a
ranker.

Tolerances as ``tests/test_torch_trainer.py``'s: per-epoch train loss 1e-4
relative, every validation and test metric 1e-6 abs, dumped labels equal
and scores 1e-4 abs after centring each row (the listwise loss leaves the
scorer's output bias to rounding noise, which Adam moves by about the
learning rate a step in either package).  Then, for the port alone: a
resumed run equals the uninterrupted one.
"""

import json

import jax
import numpy as np
import pytest

from context_attentive_ir_tpu import data as jdata
from context_attentive_ir_tpu.config import RunConfig as JaxRunConfig
from context_attentive_ir_tpu.config import default_config as jax_config
from context_attentive_ir_tpu.train import Trainer as JaxTrainer
from context_attentive_ir_tpu.train.trainer import (
    make_iterator as jax_make_iterator,
)
from context_attentive_ir_tpu_torch import data as pdata
from context_attentive_ir_tpu_torch.config import RunConfig, default_config
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.train import (
    Checkpointer,
    Trainer,
    create_train_state,
)

DIMS = dict(emsize=16, nhid=8, nhid_ffnn=16, nfilters=4, max_query_len=6,
            max_doc_len=8, max_session_len=3, num_candidates=8, dropout=0.0,
            dropout_emb=0.0, dropout_rnn=0.0)
RUN = dict(batch_size=4, test_batch_size=4, num_epochs=3, display_iter=2,
           early_stop=10, seed=7, async_checkpoint=False,
           native_vectorizer=False, valid_metric="map")
LOSS_REL, METRIC_TOL = 1e-4, 1e-6


def _load(mod, path):
    return mod.load_data(str(path), DIMS["max_query_len"],
                         DIMS["max_doc_len"], DIMS["num_candidates"],
                         DIMS["max_session_len"])


def _dictionary(mod, sessions):
    streams = [t for s in sessions for q in s.queries
               for t in [q.tokens] + [d.tokens for d in q.documents]]
    return mod.build_dictionary(streams)


def _pair(tmp, model_type):
    """A JAX Trainer and the port's over the same files, both fitted and
    tested; the port starts from the JAX trainer's initial parameters."""
    train = pdata.write_fixture(tmp / "train.jsonl", n_sessions=8,
                                n_candidates=8, seed=0)
    dev = pdata.write_fixture(tmp / "dev.jsonl", n_sessions=4,
                              n_candidates=8, seed=1)
    out = {}
    js, jdev = _load(jdata, train), _load(jdata, dev)
    jd = _dictionary(jdata, js)
    jcfg = jax_config(model_type, vocab_size=len(jd), **DIMS)
    jrun = JaxRunConfig(model_dir=str(tmp / "jax"), model_name="m", **RUN)
    jt = JaxTrainer(jcfg, jrun, jd, use_mesh=False)
    first = next(iter(jax_make_iterator(js, jcfg, jd, 4, True, 7).epoch(0)))
    jt.init_state(first)
    init = jax.device_get(jt.state.params)
    out["jax_fit"] = jt.fit(js, jdev)
    out["jax_test"] = jt.test(jdev, dump_prefix=str(tmp / "jax" / "m.test"))

    ps, pdev = _load(pdata, train), _load(pdata, dev)
    pd_ = _dictionary(pdata, ps)
    pcfg = default_config(model_type, vocab_size=len(pd_), **DIMS)
    prun = RunConfig(model_dir=str(tmp / "port"), model_name="m", **RUN)
    pt = Trainer(pcfg, prun, pd_, device="cpu")
    assert pt.decode_fn is None and pt.score_fn is not None
    pt.model.load_state_dict(params_from_jax(init, pcfg))
    pt.state = create_train_state(pt.model, pcfg)
    out["port_fit"] = pt.fit(ps, pdev)
    out["port_test"] = pt.test(pdev, dump_prefix=str(tmp / "port" / "m.test"))
    out.update(port=pt, tmp=tmp, run=prun, init=init, config=pcfg,
               word_dict=pd_, sessions=(ps, pdev))
    return out


@pytest.fixture(scope="module")
def dssm(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("dssm"), "dssm")


@pytest.fixture(scope="module")
def arcii(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("arcii"), "arcii")


@pytest.fixture(scope="module")
def match_tensor(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("match_tensor"), "match_tensor")


@pytest.fixture(params=["dssm", "arcii", "match_tensor"])
def pair(request):
    return request.getfixturevalue(request.param)


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_epoch_losses_match_jax(pair):
    jh, ph = pair["jax_fit"]["history"], pair["port_fit"]["history"]
    assert [h["epoch"] for h in ph] == [h["epoch"] for h in jh] == [0, 1, 2]
    for j, p in zip(jh, ph):
        rel = abs(p["train_loss"] - j["train_loss"]) / abs(j["train_loss"])
        assert rel <= LOSS_REL, (j["epoch"], p["train_loss"],
                                 j["train_loss"])
    assert ph[-1]["train_loss"] < ph[0]["train_loss"]


def test_validation_and_test_metrics_match_jax(pair):
    for j, p in zip(pair["jax_fit"]["history"], pair["port_fit"]["history"]):
        assert set(p) == set(j) and "map" in p and "bleu-1" not in p
        for k in j:
            if k != "train_loss":
                assert abs(p[k] - j[k]) <= METRIC_TOL, (j["epoch"], k, p[k],
                                                        j[k])
    assert abs(pair["port_fit"]["best_valid"]
               - pair["jax_fit"]["best_valid"]) <= METRIC_TOL
    jt, pt = pair["jax_test"], pair["port_test"]
    assert set(pt) == set(jt)
    for k in jt:
        assert abs(pt[k] - jt[k]) <= METRIC_TOL, (k, pt[k], jt[k])


def test_rank_dump_and_checkpoints(pair):
    tmp = pair["tmp"]
    jr = _lines(tmp / "jax" / "m.test.ranks.jsonl")
    pr = _lines(tmp / "port" / "m.test.ranks.jsonl")
    assert len(pr) == len(jr) == int(pair["port_test"]["n_queries"]) > 0
    for j, p in zip(jr, pr):
        assert p["labels"] == j["labels"]
        np.testing.assert_allclose(
            np.asarray(p["scores"]) - np.mean(p["scores"]),
            np.asarray(j["scores"]) - np.mean(j["scores"]), rtol=0,
            atol=1e-4)
    assert not (tmp / "port" / "m.test.hyps.jsonl").exists()
    port_dir = tmp / "port"
    best, latest = port_dir / "m.mdl", port_dir / "m.mdl.checkpoint"
    assert ((best / "state.msgpack").exists()
            and (latest / "state.msgpack").exists())
    assert Checkpointer.peek(latest)[2]["epoch"] == 2


def test_resume_continues_and_equals_uninterrupted(pair, tmp_path):
    """Two epochs, then ``resume=True`` for a third: epoch 2's loss and
    metrics equal the uninterrupted run's."""
    ps, pdev = pair["sessions"]

    def fresh(**kw):
        pt = Trainer(pair["config"], pair["run"].replace(
            model_dir=str(tmp_path), **kw), pair["word_dict"], device="cpu")
        if not kw.get("resume"):
            pt.model.load_state_dict(params_from_jax(pair["init"],
                                                     pair["config"]))
            pt.state = create_train_state(pt.model, pair["config"])
        return pt

    two = fresh(num_epochs=2).fit(ps, pdev)
    assert [h["epoch"] for h in two["history"]] == [0, 1]
    resumed = fresh(num_epochs=3, resume=True)
    more = resumed.fit(ps, pdev)
    assert resumed.start_epoch == 2
    assert [h["epoch"] for h in more["history"]] == [2]
    want = pair["port_fit"]["history"][2]
    for k, v in more["history"][0].items():
        assert v == pytest.approx(want[k], rel=1e-6, abs=1e-9), k
