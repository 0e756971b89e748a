"""The port's ``Trainer`` against the JAX package's, from the same fixture
file, ``RunConfig`` and initial parameters (the JAX initialisation, through
``convert.params_from_jax``), at f32 with dropout 0, for CARS (beam-2
validation), HRED-QS and seq2seq (greedy validation), ACG (beam-2
validation through its copy step), M-NSRF (beam-2) and M-MatchTensor
(greedy): one JAX ``fit`` per model.

Tolerances: per-epoch train loss 1e-4 relative (three epochs of Adam steps
on f32 sums in another order); every validation and test metric 1e-6 abs
(they are functions of rank orders and decoded tokens, which must agree);
decoded hypotheses equal as text.  Then, for the port alone: best / latest
checkpoints, early stopping, resume (equal to an uninterrupted run),
``test(from_best=True)``, the ``decode_init_full`` fallback count, warm
start, pretrained embeddings, and the flags it refuses.
"""

import json

import jax
import numpy as np
import pytest
import torch

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

DIMS = dict(emsize=16, nhid=8, nhid_ffnn=16, max_query_len=6, max_doc_len=8,
            max_session_len=3, num_candidates=8, dropout=0.0,
            dropout_emb=0.0, dropout_rnn=0.0)
RUN = dict(batch_size=4, test_batch_size=4, num_epochs=3, display_iter=2,
           early_stop=10, seed=7, async_checkpoint=False,
           native_vectorizer=False)
FAMILY = {"cars": dict(beam_size=2, valid_metric="map"),
          "hredqs": dict(beam_size=1, valid_metric="bleu-1"),
          "seq2seq": dict(beam_size=1, valid_metric="bleu-1"),
          "acg": dict(beam_size=2, valid_metric="bleu-1"),
          "mnsrf": dict(beam_size=2, valid_metric="map"),
          "m_match_tensor": dict(beam_size=1, valid_metric="map")}
# ACG starts near its fixture's floor (the copy mixture already gives each
# target token p ~ 0.05): at the default lr of 1e-3 three epochs of four
# Adam steps move its epoch loss less than the spread between epochs'
# batches, in both packages alike; at 1e-2 it falls steadily
CONFIG = {"acg": dict(learning_rate=0.01),
          "m_match_tensor": dict(nfilters=4)}
LOSS_REL, METRIC_TOL = 1e-4, 1e-6


def _load(mod, path):
    sessions = mod.load_data(str(path), DIMS["max_query_len"],
                             DIMS["max_doc_len"], DIMS["num_candidates"],
                             DIMS["max_session_len"])
    # one turn clicks more documents than suggest_max_clicks (4)
    for d in sessions[0].queries[0].documents[:6]:
        d.label = 1
    return sessions


def _dictionary(mod, sessions):
    streams = [t for s in sessions for q in s.queries
               for t in [q.tokens] + [d.tokens for d in q.documents]]
    return mod.build_dictionary(streams)


def _pair(tmp, model_type):
    """A JAX Trainer and the port's over the same files, both fitted; the
    port starts from the JAX trainer's initial parameters."""
    train = pdata.write_fixture(tmp / "train.jsonl", n_sessions=14,
                                n_candidates=8, seed=0)
    dev = pdata.write_fixture(tmp / "dev.jsonl", n_sessions=5,
                              n_candidates=8, seed=1)
    out = {}
    js, jdev = _load(jdata, train), _load(jdata, dev)
    jd = _dictionary(jdata, js)
    jcfg = jax_config(model_type, vocab_size=len(jd), **DIMS,
                      **CONFIG.get(model_type, {}))
    jrun = JaxRunConfig(model_dir=str(tmp / "jax"), model_name="m", **RUN,
                        **FAMILY[model_type])
    jt = JaxTrainer(jcfg, jrun, jd, use_mesh=False)
    first = next(iter(jax_make_iterator(js, jcfg, jd, 4, True, 7).epoch(0)))
    jt.init_state(first)
    init = jax.device_get(jt.state.params)
    out["jax_fit"] = jt.fit(js, jdev)
    out["jax_test"] = jt.test(jdev, dump_prefix=str(tmp / "jax" / "m.test"))

    ps, pdev = _load(pdata, train), _load(pdata, dev)
    pd_ = _dictionary(pdata, ps)
    pcfg = default_config(model_type, vocab_size=len(pd_), **DIMS,
                          **CONFIG.get(model_type, {}))
    prun = RunConfig(model_dir=str(tmp / "port"), model_name="m", **RUN,
                     **FAMILY[model_type])
    pt = Trainer(pcfg, prun, pd_, device="cpu")
    pt.model.load_state_dict(params_from_jax(init, pcfg))
    pt.state = create_train_state(pt.model, pcfg)
    out["port_fit"] = pt.fit(ps, pdev)
    out["port_test"] = pt.test(pdev, dump_prefix=str(tmp / "port" / "m.test"))
    out.update(jax=jt, port=pt, tmp=tmp, init=init, sessions=(ps, pdev),
               word_dict=pd_, config=pcfg, run=prun)
    return out


@pytest.fixture(scope="module")
def cars(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("cars"), "cars")


@pytest.fixture(scope="module")
def hredqs(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("hredqs"), "hredqs")


@pytest.fixture(scope="module")
def seq2seq(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("seq2seq"), "seq2seq")


@pytest.fixture(scope="module")
def acg(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("acg"), "acg")


@pytest.fixture(scope="module")
def mnsrf(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("mnsrf"), "mnsrf")


@pytest.fixture(scope="module")
def m_match_tensor(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("m_match_tensor"), "m_match_tensor")


@pytest.fixture(params=["cars", "hredqs", "seq2seq", "acg", "mnsrf",
                        "m_match_tensor"])
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


def test_validation_metrics_match_jax(pair):
    for j, p in zip(pair["jax_fit"]["history"], pair["port_fit"]["history"]):
        assert set(p) == set(j)
        for k in j:
            if k != "train_loss":
                assert abs(p[k] - j[k]) <= METRIC_TOL, (j["epoch"], k, p[k],
                                                        j[k])
    assert abs(pair["port_fit"]["best_valid"]
               - pair["jax_fit"]["best_valid"]) <= METRIC_TOL


def test_test_metrics_and_hypotheses_match_jax(pair):
    jt, pt = pair["jax_test"], pair["port_test"]
    assert set(pt) == set(jt) and "bleu-1" in pt
    for k in jt:
        assert abs(pt[k] - jt[k]) <= METRIC_TOL, (k, pt[k], jt[k])
    tmp = pair["tmp"]
    jh = _lines(tmp / "jax" / "m.test.hyps.jsonl")
    ph = _lines(tmp / "port" / "m.test.hyps.jsonl")
    assert len(ph) == len(jh) == int(pt["n_queries"]) > 0
    assert [r["hypothesis"] for r in ph] == [r["hypothesis"] for r in jh]
    assert [r["reference"] for r in ph] == [r["reference"] for r in jh]


def test_rank_dump_matches_jax(cars):
    tmp = cars["tmp"]
    jr = _lines(tmp / "jax" / "m.test.ranks.jsonl")
    pr = _lines(tmp / "port" / "m.test.ranks.jsonl")
    assert len(pr) == len(jr) > 0
    for j, p in zip(jr, pr):
        assert p["labels"] == j["labels"]
        # up to one constant: under the listwise loss the rank MLP's output
        # bias has a gradient of rounding noise, and Adam moves it by about
        # the learning rate a step in either package
        np.testing.assert_allclose(
            np.asarray(p["scores"]) - np.mean(p["scores"]),
            np.asarray(j["scores"]) - np.mean(j["scores"]), rtol=0,
            atol=1e-4)
    assert {"map", "mrr", "ndcg@10", "bleu-4", "rouge-l"} <= set(
        cars["port_test"])


def test_decode_init_full_fallback_count(cars):
    assert cars["port"].decode_fn.fallbacks == cars["jax"].decode_fn.fallbacks
    # the dev file's first turn has 6 clicks: one batch of each of the
    # three validations and of the test fell back
    assert cars["port"].decode_fn.fallbacks == 4
    ps, _ = cars["sessions"]
    pt = cars["port"]
    before = pt.decode_fn.fallbacks
    pt.test(ps, from_best=False)   # so has the train file's: one batch more
    assert pt.decode_fn.fallbacks == before + 1
    assert pt.decode_fn.calls > pt.decode_fn.fallbacks
    assert pt.decode_fn.steps >= pt.decode_fn.calls


def test_checkpoints_and_metrics_file(pair):
    port_dir = pair["tmp"] / "port"
    best, latest = port_dir / "m.mdl", port_dir / "m.mdl.checkpoint"
    assert ((best / "state.msgpack").exists()
            and (latest / "state.msgpack").exists())
    _, vocab, extra = Checkpointer.peek(latest)
    assert extra["epoch"] == 2 and len(vocab) == len(pair["word_dict"])
    hist = pair["port_fit"]["history"]
    metric = pair["run"].valid_metric
    best_epoch = int(np.argmax([h[metric] for h in hist]))
    assert Checkpointer.peek(best)[2]["epoch"] == best_epoch
    assert extra["best_valid"] == pytest.approx(pair["port_fit"]["best_valid"])
    events = _lines(port_dir / "m.metrics.jsonl")
    assert [e["event"] for e in events][:4] == ["epoch"] * 3 + ["test"]
    assert [e["epoch"] for e in events[:3]] == [0, 1, 2]


def test_test_from_best_reloads_the_best_epoch(pair):
    pt, (_, pdev) = pair["port"], pair["sessions"]
    hist = pair["port_fit"]["history"]
    metric = pair["run"].valid_metric
    best = max(hist, key=lambda h: h[metric])   # first of equal maxima
    out = pt.test(pdev, from_best=True)
    for k, v in out.items():
        assert v == pytest.approx(best[k], abs=1e-9), k


def _fresh(pair, tmp, **run_kw):
    """A port Trainer from the pair's initial parameters."""
    run = pair["run"].replace(model_dir=str(tmp), **run_kw)
    pt = Trainer(pair["config"], run, pair["word_dict"], device="cpu")
    return pt


def _start(pair, pt):
    pt.model.load_state_dict(params_from_jax(pair["init"], pair["config"]))
    pt.state = create_train_state(pt.model, pair["config"])
    return pt


def test_resume_continues_and_equals_uninterrupted(pair, tmp_path):
    ps, pdev = pair["sessions"]
    two = _start(pair, _fresh(pair, tmp_path, num_epochs=2)).fit(ps, pdev)
    assert [h["epoch"] for h in two["history"]] == [0, 1]
    resumed = _fresh(pair, tmp_path, num_epochs=3, resume=True)
    more = resumed.fit(ps, pdev)
    assert resumed.start_epoch == 2
    assert [h["epoch"] for h in more["history"]] == [2]
    want = pair["port_fit"]["history"][2]
    for k, v in more["history"][0].items():
        assert v == pytest.approx(want[k], rel=1e-6, abs=1e-9), k
    assert more["best_valid"] == pytest.approx(pair["port_fit"]["best_valid"])


def test_early_stopping(pair, tmp_path):
    ps, pdev = pair["sessions"]
    # n_queries never improves on epoch 0: one epoch of patience, then stop
    pt = _start(pair, _fresh(pair, tmp_path, num_epochs=10, early_stop=1,
                             valid_metric="n_queries"))
    out = pt.fit(ps, pdev)
    assert [h["epoch"] for h in out["history"]] == [0, 1]
    assert Checkpointer.peek(pt.ckpt.best_path)[2]["epoch"] == 0
    assert Checkpointer.peek(pt.ckpt.latest_path)[2]["epoch"] == 1


def test_warm_start_loads_weights_only(cars, tmp_path):
    best = cars["tmp"] / "port" / "m.mdl"
    pt = _fresh(cars, tmp_path, pretrained_path=str(best))
    pt.init_state()
    blob = Checkpointer.read_state(best)
    for n, p in pt.model.named_parameters():
        assert torch.equal(p.detach(), blob["params"][n]), n
    assert pt.state.step == 0 and pt.state.opt_state["count"] == 0
    assert pt.start_epoch == 0


def test_seeded_init_and_pretrained_embeddings(cars, tmp_path):
    cfg, wd = cars["config"], cars["word_dict"]
    a = _fresh(cars, tmp_path)
    b = _fresh(cars, tmp_path)
    a.init_state()
    b.init_state()
    for (n, p), (_, q) in zip(a.model.named_parameters(),
                              b.model.named_parameters()):
        assert torch.equal(p, q), n     # the run's seed fixes the weights
    table = np.random.RandomState(0).normal(
        size=(len(wd), cfg.emsize)).astype(np.float32)
    c = Trainer(cfg, cars["run"].replace(model_dir=str(tmp_path)), wd,
                pretrained=table, device="cpu")
    c.init_state()
    np.testing.assert_array_equal(
        c.model.embeddings.embedding.detach().numpy(), table)


def test_unsupported_flags_raise(cars, tmp_path):
    cfg, wd = cars["config"], cars["word_dict"]
    run = cars["run"].replace(model_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(cfg, run.replace(checkpoint_backend="orbax"), wd,
                device="cpu")
    # every model type of the JAX zoo trains; an unknown one raises
    with pytest.raises(ValueError, match="unknown model_type 'bert'"):
        Trainer(default_config("dssm", vocab_size=len(wd)).replace(
            model_type="bert"), run, wd, device="cpu")


def test_default_device_is_the_card(cars, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Trainer(cars["config"], cars["run"].replace(model_dir=str(tmp_path)),
                cars["word_dict"])
