"""Seq2seq in the port against the JAX package at f32, with
``ablate_history`` on and off and the generator tied and untied: the
parameter tree, the model (teacher-forced logits, ``decode_init``,
``decode_step``), the recommender loss and its gradients through
``make_loss_fn``, three optimizer steps, and the ``Engine``'s beam-5 and
greedy suggestions; then ``cli.main`` end to end for seq2seq and ACG.  A
JAX ``Trainer`` against the port's runs in ``tests/test_torch_trainer.py``
(its ``pair`` fixture).

Both packages get the same weights through ``convert.params_from_jax``;
the port runs on the CPU, where its LSTM and GRU kernels take their plain
versions.  Tolerances as in ``tests/test_torch_hredqs.py``: logits,
states and losses 1e-5 abs (f32 sums in another order); gradients 2e-5 of
the largest JAX gradient in the leaf plus 1e-7; parameters after three SGD
steps 2e-6 abs; suggestion tokens exact and their scores 1e-4 abs,
compared only where the JAX score is a real hypothesis (above NEG_INF).
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_hredqs import (
    BUCKET,
    DIMS,
    TOL,
    _close,
    _close_grad,
    _compare,
    _flat,
    _histories,
    port_batch,
    port_config,
)

from context_attentive_ir_tpu.config import default_config
from context_attentive_ir_tpu.constants import BOS, EOS
from context_attentive_ir_tpu.data import ShapeConfig, build_dictionary
from context_attentive_ir_tpu.data import (
    build_suggest_batch as jax_build_suggest_batch,
)
from context_attentive_ir_tpu.data import generate_sessions
from context_attentive_ir_tpu.data.objects import Session
from context_attentive_ir_tpu.data.vectorize import suggest_examples
from context_attentive_ir_tpu.models import build_model as jax_build_model
from context_attentive_ir_tpu.serve import Engine as JaxEngine
from context_attentive_ir_tpu.train.state import TrainState as JaxTrainState
from context_attentive_ir_tpu.train.state import (
    make_optimizer as jax_make_optimizer,
)
from context_attentive_ir_tpu.train.steps import make_loss_fn as jax_loss_fn
from context_attentive_ir_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from context_attentive_ir_tpu_torch.cli.main import main
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.data import Dictionary as PortDictionary
from context_attentive_ir_tpu_torch.data import write_fixture
from context_attentive_ir_tpu_torch.decode import can_fuse_generator
from context_attentive_ir_tpu_torch.models import (
    build_model,
    get_model_class,
    task_family,
)
from context_attentive_ir_tpu_torch.models.recommenders.seq2seq import (
    Seq2seq,
)
from context_attentive_ir_tpu_torch.serve import Engine, ServeError
from context_attentive_ir_tpu_torch.train import (
    create_train_state,
    make_eval_loss_step,
    make_loss_fn,
    make_train_step,
)


def rec_setup(model_type, rnn_type="lstm", seed=0, **overrides):
    """(config, params, jax batch, word_dict, sessions, examples) of a tiny
    f32 flat-source recommender (``seq2seq`` or ``acg``) with random
    encoder biases and the BOS logit scaled down (else a random decoder
    keeps predicting BOS); a tied generator's EOS logit varies with the
    decoder state, so decodes end at different steps.  The batch has two
    padded rows.  ``overrides`` replace config fields."""
    sessions = [Session.from_dict(d) for d in generate_sessions(
        n_sessions=5, min_turns=2, max_turns=5, n_candidates=3, seed=seed)]
    word_dict = build_dictionary([q.tokens for s in sessions
                                  for q in s.queries])
    cfg = default_config(model_type).replace(
        vocab_size=len(word_dict), rnn_type=rnn_type,
        **{**DIMS, **overrides})
    shapes = ShapeConfig(cfg.max_query_len, cfg.max_doc_len,
                         cfg.max_session_len, cfg.num_candidates)
    examples = suggest_examples(sessions)
    batch = jax_build_suggest_batch(examples, word_dict, shapes,
                                    batch_size=len(examples) + 2)
    model = jax_build_model(cfg)
    params = jax.device_get(model.init({"params": jax.random.key(seed)},
                                       batch, True)["params"])
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.RandomState(seed)
    for name, v in _flat(params["encoder"]).items():
        if name.rsplit(".", 1)[-1].startswith("b_"):
            v[...] = rng.normal(size=v.shape) * 0.2
    if cfg.tie_embeddings:
        table = params["embeddings"]["embedding"]
        table[BOS] *= 0.3
        table[EOS] *= 10.0
        params["generator"]["tie_proj"]["bias"] = (
            0.05 * table[EOS] / (table[EOS] @ table[EOS]))
    else:
        params["generator"]["proj"]["kernel"][:, BOS] *= 0.3
    return cfg, params, batch, word_dict, sessions, examples


def port_model(cfg, params):
    pcfg = port_config(cfg)
    model = build_model(pcfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(params, pcfg))
    return model


# (ablate_history, tie_embeddings, rnn_type)
VARIANTS = [(False, True, "lstm"), (True, True, "lstm"),
            (False, False, "gru"), (True, False, "lstm")]


@pytest.fixture(scope="module", params=VARIANTS,
                ids=lambda v: f"ablate={v[0]}-tie={v[1]}-{v[2]}")
def setup(request):
    ablate, tie, rnn = request.param
    return rec_setup("seq2seq", rnn, ablate_history=ablate,
                     tie_embeddings=tie)


# -- the model ---------------------------------------------------------------


def test_param_tree_matches_jax(setup):
    """The port's parameters are exactly the JAX tree's leaves with their
    shapes -- the same with ``ablate_history`` on and off (the encoder runs
    either way), ``generator.proj`` when untied, ``generator.tie_proj``
    when tied."""
    cfg, params, _, _, _, _ = setup
    flat = _flat(params)
    pm = port_model(cfg, params)
    assert {n: tuple(p.shape) for n, p in pm.named_parameters()} == {
        n: v.shape for n, v in flat.items()}
    gen = {n.split(".")[1] for n in flat if n.startswith("generator.")}
    assert gen == ({"tie_proj"} if cfg.tie_embeddings else {"proj"})
    other = rec_setup("seq2seq", cfg.rnn_type,
                      ablate_history=not cfg.ablate_history,
                      tie_embeddings=cfg.tie_embeddings)[1]
    assert {n: v.shape for n, v in _flat(other).items()} == {
        n: v.shape for n, v in flat.items()}


def test_logits_match_jax(setup):
    cfg, params, batch, _, _, _ = setup
    jm = jax_build_model(cfg)
    ref = jm.apply({"params": params}, batch, True)
    got = port_model(cfg, params)(port_batch(batch))
    assert got.shape == ref.shape
    _close(got, ref)


def test_decode_init_and_steps_match_jax(setup):
    """``decode_init``'s memory is the flat source's states, or with
    ``ablate_history`` the last valid turn's ``[B, Lq]``; three decode
    steps on random tokens."""
    cfg, params, batch, _, _, _ = setup
    jm = jax_build_model(cfg)
    var = {"params": params}
    st_j, mem_j, mask_j = jm.apply(var, batch, method=jm.decode_init)
    pm = port_model(cfg, params)
    st_p, mem_p, mask_p = pm.decode_init(port_batch(batch))
    width = cfg.max_query_len * (1 if cfg.ablate_history
                                 else cfg.max_session_len)
    assert mem_p.shape[1] == width
    _close(mem_p, mem_j)
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_j))
    for key in ("h", "c"):
        for a, b in zip(st_p[key], st_j[key]):
            _close(a, b)
    rng = np.random.RandomState(3)
    for _ in range(3):
        toks = rng.randint(0, cfg.vocab_size, size=mem_p.shape[0])
        st_j, logits_j, align_j = jm.apply(var, st_j, jax.numpy.asarray(toks),
                                           mem_j, mask_j,
                                           method=jm.decode_step)
        st_p, logits_p, align_p = pm.decode_step(
            st_p, torch.from_numpy(toks), mem_p, mask_p)
        _close(logits_p, logits_j)
        _close(align_p, align_j)
    assert not can_fuse_generator(pm)


# -- training ----------------------------------------------------------------


def test_loss_and_grads_match_jax(setup):
    """``make_loss_fn``'s recommender branch (the target NLL under
    ``target_mask & row_mask``, ``ppl``) and every parameter's gradient
    against ``jax.value_and_grad`` of the JAX loss."""
    cfg, params, batch, _, _, _ = setup
    jm = jax_build_model(cfg)
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(
        jax_loss_fn(jm, cfg), has_aux=True), static_argnums=3)(
        params, batch, jax.random.key(0), True)
    pm = port_model(cfg, params)
    loss, met = make_loss_fn(pm, port_config(cfg))(port_batch(batch),
                                                   deterministic=True)
    loss.backward()
    assert set(met) == set(met_j) == {"loss", "gen_loss", "ppl"}
    for k in met:
        _close(met[k], met_j[k], tol=TOL * max(1.0, abs(float(met_j[k]))))
    flat_g = _flat(jax.device_get(grads_j))
    assert set(flat_g) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        _close_grad(p.grad, flat_g[name])
    with torch.no_grad():
        ev = make_eval_loss_step(pm, port_config(cfg))(port_batch(batch))
    _close(ev["loss"], loss_j)


def test_three_sgd_steps_match_jax(setup):
    cfg, params, batch, _, _, _ = setup
    cfg = cfg.replace(optimizer="sgd", learning_rate=0.5, momentum=0.9)
    jm = jax_build_model(cfg)
    jstate = JaxTrainState.create(apply_fn=jm.apply, params=params,
                                  tx=jax_make_optimizer(cfg))
    jstep = jax_make_train_step(jm, cfg)
    pm = port_model(cfg, params)
    pstate = create_train_state(pm, port_config(cfg))
    pstep = make_train_step(pm, port_config(cfg))
    pb = port_batch(batch)
    for i in range(3):
        jstate, mj = jstep(jstate, batch, jax.random.key(1))
        pstate, mp = pstep(pstate, pb, 1)
        for k in ("loss", "gen_loss", "ppl", "grad_norm"):
            rel = abs(float(mp[k]) - float(mj[k])) / abs(float(mj[k]))
            assert rel <= 1e-5, (i, k, float(mp[k]), float(mj[k]))
    flat_j = _flat(jax.device_get(jstate.params))
    for n, p in pm.named_parameters():
        err = float(np.max(np.abs(p.detach().numpy() - flat_j[n])))
        assert err <= 2e-6, (n, err)


# -- the Engine --------------------------------------------------------------


@pytest.mark.parametrize("beam_size", [5, 1])
def test_suggest_batch_matches_jax(setup, beam_size):
    cfg, params, _, word_dict, sessions, _ = setup
    pcfg = port_config(cfg)
    jax_eng = JaxEngine(cfg, word_dict, params, beam_size=beam_size,
                        batch_bucket=BUCKET)
    port_eng = Engine(pcfg, PortDictionary.from_json(word_dict.to_json()),
                      params_from_jax(params, pcfg), beam_size=beam_size,
                      batch_bucket=BUCKET, device="cpu")
    hists = _histories(sessions)
    n_real, words = _compare(port_eng.suggest_batch(hists),
                             jax_eng.suggest_batch(hists))
    assert n_real >= len(hists) and words > 0
    assert port_eng.family == "recommender"
    with pytest.raises(ServeError, match="cannot rank"):
        port_eng.rank_batch([("a query", ["a doc"], ())])
    with pytest.raises(ServeError, match="cached-doc"):
        port_eng.index_documents(["a doc"])


def test_model_registry():
    assert task_family("seq2seq") == "recommender"
    assert get_model_class("seq2seq") is Seq2seq
    cfg = port_config(default_config("seq2seq")).replace(
        vocab_size=20, emsize=8, nhid=4)
    assert isinstance(build_model(cfg, device="cpu"), Seq2seq)
    with pytest.raises(ValueError, match="seq2seq"):
        Seq2seq(cfg.replace(model_type="hredqs"), device="cpu")
    with pytest.raises(ValueError, match="rnn_type"):
        Seq2seq(cfg.replace(rnn_type="rnn"), device="cpu")


@pytest.mark.parametrize("model_type", ["seq2seq", "acg"])
def test_main_end_to_end(tmp_path, model_type):
    """``cli.main`` trains the model (beam-2 validation on BLEU), the train
    loss falls, it writes the hypotheses dump and no ranking dump, and
    ``--only_test`` reproduces the test metrics."""
    train = write_fixture(tmp_path / "train.jsonl", n_sessions=10,
                          n_candidates=6, seed=0)
    dev = write_fixture(tmp_path / "dev.jsonl", n_sessions=4,
                        n_candidates=6, seed=1)
    common = ["--model_type", model_type, "--test_file", str(dev),
              "--model_dir", str(tmp_path / "runs"), "--model_name", "m",
              "--emsize", "16", "--nhid", "8", "--max_query_len", "6",
              "--max_session_len", "3", "--test_batch_size", "8",
              "--beam_size", "2", "--device", "cpu"]
    results = main([*common, "--train_file", str(train), "--dev_file",
                    str(dev), "--num_epochs", "2", "--batch_size", "8",
                    "--valid_metric", "bleu-1", "--no-pack_cache",
                    "--prefetch_batches", "0"])
    hist = results["fit"]["history"]
    assert [h["epoch"] for h in hist] == [0, 1]
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert "map" not in results["test"] and "bleu-1" in results["test"]
    runs = tmp_path / "runs"
    assert (runs / "m.test.hyps.jsonl").read_text().strip()
    assert not (runs / "m.test.ranks.jsonl").exists()
    retest = main([*common, "--only_test"])
    assert retest["test"] == results["test"]
