"""Run directories shared by the two packages: a JAX ``Checkpointer`` save
read by the port, a port save read by the JAX ``Checkpointer.load``, and
the port's entry points (``Engine.from_checkpoint``, ``cli.main
--only_test``, ``--resume``, ``--pretrained_path``) on a JAX run
directory, at f32 with dropout 0.

The optimizer matrix (CARS): adam with clipping (the defaults), adam with
a staircase decay, adam with warmup, adam with ``fix_embeddings``, sgd
with momentum and no clipping, adamax with weight decay; HRED-QS and DSSM
with the defaults.  Loaded params, moments, step and counts are equal bit
for bit; one more step in each package agrees to 1e-5 abs.  An Adam-family
step moves an entry whose gradient is rounding noise by about the
learning rate in each package (``test_torch_train_steps``): CARS's
ranking output bias (the listwise loss is blind to a shift of every
score) is held to that step only under SGD.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from context_attentive_ir_tpu import data as jdata
from context_attentive_ir_tpu.cli.main import main as jax_cli
from context_attentive_ir_tpu.config import default_config as jax_config
from context_attentive_ir_tpu.models import build_model as jax_build_model
from context_attentive_ir_tpu.serve import Engine as JaxEngine
from context_attentive_ir_tpu.train.checkpoint import (
    Checkpointer as JaxCheckpointer,
)
from context_attentive_ir_tpu.train.state import (
    create_train_state as jax_create_state,
)
from context_attentive_ir_tpu.train.steps import (
    make_loss_fn,
    make_train_step as jax_make_step,
)
from context_attentive_ir_tpu.train.trainer import (
    make_iterator as jax_make_iterator,
)
from context_attentive_ir_tpu_torch import data as pdata
from context_attentive_ir_tpu_torch.cli.main import build_parser, prepare
from context_attentive_ir_tpu_torch.cli.main import main as port_cli
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.models import build_model
from context_attentive_ir_tpu_torch.serve import Engine
from context_attentive_ir_tpu_torch.train import (
    Checkpointer,
    create_train_state,
    make_train_step,
)
from context_attentive_ir_tpu_torch.train.checkpoint import (
    STATE_FILE,
    TORCH_STATE_FILE,
    state_from_flax,
    state_to_flax,
)
from context_attentive_ir_tpu_torch.train.trainer import make_iterator

DIMS = dict(emsize=16, nhid=8, nhid_ffnn=16, max_query_len=6, max_doc_len=8,
            max_session_len=3, num_candidates=6, dropout=0.0,
            dropout_emb=0.0, dropout_rnn=0.0)
OPTIMIZERS = {
    "adam": {},
    "adam_decay": dict(lr_decay_steps=1, lr_decay=0.5),
    "adam_warmup": dict(warmup_steps=1),
    "adam_fix_embeddings": dict(fix_embeddings=True),
    "sgd_momentum_noclip": dict(optimizer="sgd", momentum=0.9,
                                grad_clipping=0.0, learning_rate=0.1),
    "adamax_decay": dict(optimizer="adamax", weight_decay=0.01),
}
CASES = [("cars", k) for k in OPTIMIZERS] + [("hredqs", "adam"),
                                             ("dssm", "adam")]
STEP_TOL = 1e-5
# a leaf whose reference gradient stays below this is rounding noise (a
# bias the listwise loss cancels): Adam-like optimizers scale noise up to
# an update of about the learning rate, whose sign the two packages need
# not share, so such a leaf is held to a bound of learning rates instead
ROUNDING_FLOOR = 1e-6
NOISE_STEP_LRS = 8


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    train = pdata.write_fixture(tmp / "train.jsonl", n_sessions=8,
                                n_candidates=6, seed=0)
    dev = pdata.write_fixture(tmp / "dev.jsonl", n_sessions=4,
                              n_candidates=6, seed=1)
    sessions = jdata.load_data(str(train), DIMS["max_query_len"],
                               DIMS["max_doc_len"], DIMS["num_candidates"],
                               DIMS["max_session_len"])
    streams = [t for s in sessions for q in s.queries
               for t in [q.tokens] + [d.tokens for d in q.documents]]
    return tmp, train, dev, sessions, jdata.build_dictionary(streams)


def _jax_run(fixture, model_type, opt, steps=2):
    """A JAX model of ``model_type`` after ``steps`` train steps, saved by
    the JAX Checkpointer: (config, word_dict, batch, step fn, state,
    checkpoint path)."""
    tmp, _, _, sessions, wd = fixture
    cfg = jax_config(model_type, vocab_size=len(wd), **DIMS,
                     **OPTIMIZERS[opt])
    batch = next(iter(jax_make_iterator(sessions, cfg, wd, 4, False,
                                        0).epoch(0)))
    model = jax_build_model(cfg)
    state = jax_create_state(model, cfg, batch, jax.random.key(3))
    step = jax_make_step(model, cfg)
    for _ in range(steps):
        state, _ = step(state, batch, jax.random.key(1))
    ckpt = JaxCheckpointer(tmp / f"jax_{model_type}_{opt}", "m",
                           async_save=False)
    ckpt.save_latest(state, cfg, wd, {"epoch": 0})
    return cfg, wd, batch, step, state, ckpt.latest_path


def _jax_grads(cfg, jstate, batch):
    """The gradient the JAX train step takes at ``jstate`` (no dropout)."""
    loss_fn = make_loss_fn(jax_build_model(cfg), cfg)
    return jax.grad(lambda p: loss_fn(p, batch, jax.random.key(1), True)[0])(
        jstate.params)


def _port_state(cfg):
    pcfg = PortConfig.from_json(cfg.to_json())
    model = build_model(pcfg, device="cpu", seed=0)
    return pcfg, model, create_train_state(model, pcfg)


def _port_batch(batch):
    cls = type(batch).__name__
    pcls = getattr(pdata, cls)
    return pcls(**{f.name: (None if getattr(batch, f.name) is None else
                            np.asarray(getattr(batch, f.name)))
                   for f in dataclasses.fields(pcls)}).to("cpu")


def _moments(jstate):
    """{moment: {dotted name: array}} of the JAX optimizer state (masked
    leaves dropped) and its counts."""
    flat = _flat(serialization.to_state_dict(
        jax.device_get(jstate.opt_state)))
    out, counts = {}, []
    for path, v in flat.items():
        parts = path.split(".")
        if parts[-1] == "count":
            counts.append(int(v))
        for i, p in enumerate(parts):
            if p in ("mu", "nu", "trace") and not isinstance(v, dict):
                out.setdefault(p, {})[".".join(parts[i + 1:])] = np.asarray(v)
    return out, counts


@pytest.mark.parametrize("model_type,opt", CASES)
def test_jax_run_directory_loads_into_the_port(fixture, model_type, opt):
    cfg, wd, batch, jstep, jstate, path = _jax_run(fixture, model_type, opt)
    pcfg, model, pstate = _port_state(cfg)
    Checkpointer.load(path, pstate)

    want = params_from_jax(jax.device_get(jstate.params), pcfg)
    for n, p in pstate.params.items():
        assert torch.equal(p, want[n]), n
    moments, counts = _moments(jstate)
    names = ("trace",) if pcfg.optimizer == "sgd" else ("mu", "nu")
    assert set(moments) == set(names)
    for k in names:
        assert set(pstate.opt_state[k]) == set(moments[k])
        for n, t in pstate.opt_state[k].items():
            np.testing.assert_array_equal(t.numpy(), moments[k][n],
                                          err_msg=f"{k} {n}")
    if pcfg.fix_embeddings:
        assert "embeddings.embedding" not in pstate.opt_state["mu"]
    assert pstate.step == int(jstate.step) == 2
    assert all(c == 2 for c in counts) and pstate.opt_state["count"] == 2
    if opt == "sgd_momentum_noclip":
        assert counts == []        # sgd without a schedule keeps no count

    # one more step in each package, against the reference gradient
    grads = _flat(jax.device_get(_jax_grads(cfg, jstate, batch)))
    jstate, _ = jstep(jstate, batch, jax.random.key(1))
    pstate, _ = make_train_step(model, pcfg)(pstate, _port_batch(batch), 1)
    ref = _flat(jax.device_get(jstate.params))
    noise = []
    for n, p in pstate.params.items():
        err = float(np.max(np.abs(p.detach().numpy() - ref[n])))
        if err <= STEP_TOL:
            continue
        g = float(np.max(np.abs(grads[n])))
        assert pcfg.optimizer != "sgd" and g < ROUNDING_FLOOR, (n, err, g)
        assert err <= NOISE_STEP_LRS * pcfg.learning_rate, (n, err, g)
        noise.append(n)
    assert len(noise) <= 1, noise
    assert pstate.step == 3 and pstate.opt_state["count"] == 3


@pytest.mark.parametrize("model_type,opt", CASES)
def test_port_run_directory_loads_into_jax(fixture, model_type, opt,
                                           tmp_path):
    # the template has stepped once: its step and counts are int32 arrays,
    # as in any JAX state that trained
    cfg, wd, batch, _, jstate, _ = _jax_run(fixture, model_type, opt,
                                            steps=1)
    pcfg, model, pstate = _port_state(cfg)
    pstate, _ = make_train_step(model, pcfg)(pstate, _port_batch(batch), 1)
    pdict = pdata.Dictionary.from_json(wd.to_json())
    ckpt = Checkpointer(tmp_path, "m", async_save=False)
    ckpt.save_best(pstate, pcfg, pdict, {"epoch": 0})
    assert (ckpt.best_path / STATE_FILE).exists()

    got = JaxCheckpointer.load(ckpt.best_path, jstate)
    assert int(got.step) == 1
    ref = jax.tree_util.tree_leaves(jstate)
    leaves = jax.tree_util.tree_leaves(got)
    assert len(leaves) == len(ref)
    for a, b in zip(leaves, ref):
        assert np.shape(a) == np.shape(b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    for n, p in _flat(jax.device_get(got.params)).items():
        np.testing.assert_array_equal(np.asarray(p),
                                      pstate.params[n].detach().numpy(), n)
    moments, counts = _moments(got)
    assert all(c == 1 for c in counts)
    for k, flat in moments.items():
        for n, v in flat.items():
            np.testing.assert_array_equal(v, pstate.opt_state[k][n].numpy())


def test_state_tree_round_trip_and_refusals():
    cfg = jax_config("cars", vocab_size=30, **DIMS, fix_embeddings=True,
                     warmup_steps=2)
    pcfg, model, pstate = _port_state(cfg)
    blob = pstate.state_dict()
    blob["step"], blob["opt_state"]["count"] = 4, 4
    tree = state_to_flax(blob, pcfg)
    back = state_from_flax(tree, pcfg)
    assert back["step"] == 4 and back["opt_state"]["count"] == 4
    assert set(back["params"]) == set(blob["params"])
    # the counts may be Python ints (a JAX state that never stepped)
    tree["step"] = 4
    inner = tree["opt_state"]["1"]["inner_states"]["train"]["inner_state"]
    inner["0"]["1"]["count"] = 4
    assert state_from_flax(tree, pcfg)["opt_state"]["count"] == 4
    inner["0"]["1"]["count"] = 5
    with pytest.raises(ValueError, match="disagree"):
        state_from_flax(tree, pcfg)
    inner["0"]["1"]["count"] = 4
    # a frozen table's moments are empty maps; anything else is refused
    inner["0"]["0"]["mu"]["embeddings"]["embedding"] = torch.zeros(1)
    with pytest.raises(ValueError, match="mu.embeddings.embedding"):
        state_from_flax(tree, pcfg)
    with pytest.raises(ValueError, match="opt_state.1: keys"):
        state_from_flax(state_to_flax(blob, pcfg),
                        pcfg.replace(fix_embeddings=False))


def test_pre_msgpack_state_pt_directory_still_loads(fixture, tmp_path):
    cfg, wd, batch, _, _, _ = _jax_run(fixture, "cars", "adam", steps=0)
    pcfg, model, pstate = _port_state(cfg)
    pstate, _ = make_train_step(model, pcfg)(pstate, _port_batch(batch), 1)
    pdict = pdata.Dictionary.from_json(wd.to_json())
    ckpt = Checkpointer(tmp_path, "m", async_save=False)
    ckpt.save_best(pstate, pcfg, pdict, {"epoch": 0})
    old = ckpt.best_path
    (old / STATE_FILE).unlink()
    torch.save(pstate.state_dict(), old / TORCH_STATE_FILE)
    _, _, other = _port_state(cfg)
    Checkpointer.load(old, other)
    assert other.step == 1
    for n, p in pstate.params.items():
        assert torch.equal(p, other.params[n])
    eng = Engine.from_checkpoint(old, beam_size=2, device="cpu")
    for n, p in eng.model.named_parameters():
        assert torch.equal(p, pstate.params[n]), n


def _requests(sessions):
    return ([(" ".join(q.tokens), [" ".join(d.tokens) for d in q.documents],
              [" ".join(p.tokens) for p in s.queries[:i]])
             for s in sessions[:3] for i, q in enumerate(s.queries[:2])],
            [[" ".join(q.tokens) for q in s.queries[:2]]
             for s in sessions[:3]])


@pytest.mark.parametrize("model_type", ["cars", "hredqs", "dssm"])
def test_engine_from_a_jax_checkpoint(fixture, model_type):
    cfg, _, _, _, _, path = _jax_run(fixture, model_type, "adam")
    reqs, hists = _requests(fixture[3])
    port = Engine.from_checkpoint(path, beam_size=2, device="cpu")
    ref = JaxEngine.from_checkpoint(path, beam_size=2)
    if model_type != "hredqs":
        np.testing.assert_allclose(
            np.asarray(port.rank_batch(reqs), np.float32),
            np.asarray(ref.rank_batch(reqs), np.float32), rtol=0, atol=1e-5)
    if model_type != "dssm":
        got, want = port.suggest_batch(hists), ref.suggest_batch(hists)
        assert [[s for s, _ in row] for row in got] == \
            [[s for s, _ in row] for row in want]


def _cli_args(fixture, run_dir, *extra):
    _, train, dev, _, _ = fixture
    return ["--model_type", "cars", "--train_file", str(train),
            "--dev_file", str(dev), "--test_file", str(dev),
            "--model_dir", str(run_dir), "--model_name", "run",
            # a multiple of the JAX CLI's mesh (the CPU devices of the tests)
            "--batch_size", "8", "--test_batch_size", "8",
            "--beam_size", "2", "--display_iter", "5", "--seed", "7",
            "--no-async_checkpoint", "--no-native_vectorizer",
            "--emsize", "16", "--nhid", "8", "--nhid_ffnn", "16",
            "--max_query_len", "6", "--max_doc_len", "8",
            "--max_session_len", "3", "--num_candidates", "6",
            "--dropout", "0", "--dropout_emb", "0", "--dropout_rnn", "0",
            *extra]


@pytest.fixture(scope="module")
def jax_run_dir(fixture):
    run_dir = fixture[0] / "jax_cli"
    results = jax_cli(_cli_args(fixture, run_dir, "--num_epochs", "1"))
    return run_dir, results


def test_only_test_on_a_jax_run_directory(fixture, jax_run_dir):
    run_dir, jax_results = jax_run_dir
    port = port_cli(_cli_args(fixture, run_dir, "--only_test"),
                    device="cpu")
    for k, v in jax_results["test"].items():
        assert abs(port["test"][k] - v) <= 1e-6, (k, port["test"][k], v)


def test_resume_and_warm_start_from_a_jax_run_directory(fixture,
                                                        jax_run_dir,
                                                        tmp_path):
    run_dir, _ = jax_run_dir
    resumed = tmp_path / "resumed"
    shutil.copytree(run_dir, resumed)
    out = port_cli(_cli_args(fixture, resumed, "--resume", "--num_epochs",
                             "2"), device="cpu")
    assert [h["epoch"] for h in out["fit"]["history"]] == [1]

    # --pretrained_path: the JAX best's weights (read here by flax itself)
    best = run_dir / "run.mdl"
    args = _cli_args(fixture, tmp_path / "warm", "--num_epochs", "1",
                     "--pretrained_path", str(best))
    _, _, trainer, train_s, dev_s, _ = prepare(
        build_parser().parse_args(args), device="cpu")
    trainer.init_state()
    tree = serialization.msgpack_restore((best / STATE_FILE).read_bytes())
    want = params_from_jax(tree["params"], trainer.config)
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    assert [h["epoch"] for h in trainer.fit(train_s, dev_s)["history"]] \
        == [0]


def test_port_iterator_matches_for_the_entry_points(fixture):
    # the entry-point tests above lean on the two packages batching the
    # fixture alike
    _, _, _, sessions, wd = fixture
    cfg = jax_config("cars", vocab_size=len(wd), **DIMS)
    jb = next(iter(jax_make_iterator(sessions, cfg, wd, 4, False,
                                     0).epoch(0)))
    psess = pdata.load_data(str(fixture[1]), DIMS["max_query_len"],
                            DIMS["max_doc_len"], DIMS["num_candidates"],
                            DIMS["max_session_len"])
    pcfg = PortConfig.from_json(cfg.to_json())
    pwd = pdata.Dictionary.from_json(wd.to_json())
    pb = next(iter(make_iterator(psess, pcfg, pwd, 4, False, 0).epoch(0)))
    np.testing.assert_array_equal(np.asarray(jb.query), pb.query)
