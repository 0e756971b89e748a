"""ACG (attend-copy-generate) in the port against the JAX package at f32:
the parameter tree (``copy_gate`` beside seq2seq's modules), the mixture
probabilities of the teacher-forced forward, ``copy_generator_nll_loss``
and every gradient through ``make_loss_fn`` (``copy_gate`` included),
``decode_step`` with and without the source tokens, ``build_decode_fn``'s
beam and greedy decodes, and the ``Engine``'s suggestions (the shortlist
ignored, as in JAX).  ``cli.main`` trains ACG end to end in
``tests/test_torch_seq2seq.py`` and ``tests/test_torch_trainer.py`` holds
its ``Trainer`` to the JAX one.

Both packages get the same weights through ``convert.params_from_jax``.
The JAX model scatters the copy alignment onto the vocabulary as one
``align @ one_hot(source, V)`` product, the port with ``scatter_add_``:
the same f32 sums in another order, which costs 1e-6 abs on the
probabilities (each at most 1) and 1e-5 abs on their logs.  Losses 1e-5
(scaled by the loss), gradients 2e-5 of the largest JAX gradient in the
leaf plus 1e-7, decoded tokens exact and n-best scores 1e-4 abs where the
JAX score is a real hypothesis, as in ``tests/test_torch_hredqs.py``.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_hredqs import (
    BUCKET,
    TOL,
    _close,
    _close_grad,
    _compare,
    _flat,
    _histories,
    port_batch,
    port_config,
)
from test_torch_seq2seq import port_model, rec_setup

from context_attentive_ir_tpu.models import build_model as jax_build_model
from context_attentive_ir_tpu.serve import Engine as JaxEngine
from context_attentive_ir_tpu.train.evaluate import (
    build_decode_fn as jax_build_decode_fn,
)
from context_attentive_ir_tpu.train.steps import make_loss_fn as jax_loss_fn
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.data import Dictionary as PortDictionary
from context_attentive_ir_tpu_torch.decode import can_fuse_generator
from context_attentive_ir_tpu_torch.models import get_model_class
from context_attentive_ir_tpu_torch.models.recommenders.acg import ACG
from context_attentive_ir_tpu_torch.serve import Engine
from context_attentive_ir_tpu_torch.train import (
    build_decode_fn,
    make_eval_loss_step,
    make_loss_fn,
)

PROB_TOL = 1e-6   # mixture probabilities: the scatter's sums reordered
LOGP_TOL = 1e-5   # their logs, down to log(1e-10)


@pytest.fixture(scope="module", params=[(True, "lstm"), (False, "gru")],
                ids=lambda v: f"tie={v[0]}-{v[1]}")
def setup(request):
    tie, rnn = request.param
    return rec_setup("acg", rnn, tie_embeddings=tie)


def test_probabilities_match_jax(setup):
    """The teacher-forced forward returns the copy mixture ``[B, Lt, V]``:
    every row a distribution, equal to the JAX one; the port's parameters
    are the JAX tree's, ``copy_gate`` a ``Dense(H2, 1)``."""
    cfg, params, batch, _, _, _ = setup
    pm = port_model(cfg, params)
    assert isinstance(pm, ACG) and get_model_class("acg") is ACG
    assert {n: tuple(p.shape) for n, p in pm.named_parameters()} == {
        n: v.shape for n, v in _flat(params).items()}
    assert tuple(pm.copy_gate.kernel.shape) == (2 * cfg.nhid, 1)
    ref = jax_build_model(cfg).apply({"params": params}, batch, True)
    got = pm(port_batch(batch))
    assert got.shape == ref.shape == (*batch.target_in.shape,
                                      cfg.vocab_size)
    _close(got, ref, tol=PROB_TOL)
    # a row with a source is a distribution (a padded row has no copy mass)
    rows = batch.source_mask.any(-1)
    np.testing.assert_allclose(got.sum(-1).detach().numpy()[rows], 1.0,
                               atol=1e-5)
    assert not can_fuse_generator(pm)


def test_copy_loss_and_grads_match_jax(setup):
    """``make_loss_fn`` takes ``copy_generator_nll_loss`` for ACG; every
    gradient, ``copy_gate``'s included, against ``jax.value_and_grad``."""
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
    assert float(np.abs(flat_g["copy_gate.kernel"]).max()) > 0
    for name, p in pm.named_parameters():
        _close_grad(p.grad, flat_g[name])
    with torch.no_grad():
        ev = make_eval_loss_step(pm, port_config(cfg))(port_batch(batch))
    _close(ev["loss"], loss_j, tol=TOL * max(1.0, abs(float(loss_j))))


def test_decode_step_with_and_without_source(setup):
    """With the source tokens ``decode_step`` returns ``log(max(p,
    1e-10))`` of the mixture, without them the generator's raw logits;
    three steps on random tokens, each against the JAX step."""
    cfg, params, batch, _, _, _ = setup
    jm = jax_build_model(cfg)
    var = {"params": params}
    pb = port_batch(batch)
    pm = port_model(cfg, params)
    st_j, mem_j, mask_j = jm.apply(var, batch, method=jm.decode_init)
    st_p, mem_p, mask_p = pm.decode_init(pb)
    _close(mem_p, mem_j)
    st_jr, st_pr = st_j, st_p
    src_j = {"source": jax.numpy.asarray(batch.source),
             "source_mask": jax.numpy.asarray(batch.source_mask)}
    rng = np.random.RandomState(3)
    for _ in range(3):
        toks = rng.randint(0, cfg.vocab_size, size=mem_p.shape[0])
        st_j, lp_j, al_j = jm.apply(var, st_j, jax.numpy.asarray(toks),
                                    mem_j, mask_j, method=jm.decode_step,
                                    **src_j)
        st_p, lp_p, al_p = pm.decode_step(st_p, torch.from_numpy(toks),
                                          mem_p, mask_p, source=pb.source,
                                          source_mask=pb.source_mask)
        _close(lp_p, lp_j, tol=LOGP_TOL)
        _close(al_p, al_j)
        np.testing.assert_allclose(
            torch.logsumexp(lp_p, -1).numpy()[batch.source_mask.any(-1)],
            0.0, atol=1e-5)
        st_jr, raw_j, _ = jm.apply(var, st_jr, jax.numpy.asarray(toks),
                                   mem_j, mask_j, method=jm.decode_step)
        st_pr, raw_p, _ = pm.decode_step(st_pr, torch.from_numpy(toks),
                                         mem_p, mask_p)
        _close(raw_p, raw_j)


@pytest.mark.parametrize("beam_size", [3, 1])
def test_build_decode_fn_matches_jax(setup, beam_size):
    """Validation's decode passes the batch's source tokens to every step
    (repeated per beam): the same token ids as the JAX decode."""
    cfg, params, batch, _, _, _ = setup
    ref = np.asarray(jax_build_decode_fn(jax_build_model(cfg), cfg,
                                         beam_size)(params, batch))
    pm = port_model(cfg, params)
    pb = port_batch(batch)
    host = type(pb)(**{k: v.numpy() for k, v in vars(pb).items()})
    got = build_decode_fn(pm, port_config(cfg), beam_size)(host)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("beam_size", [5, 1])
def test_suggest_batch_matches_jax(setup, beam_size):
    cfg, params, _, word_dict, sessions, _ = setup
    pcfg = port_config(cfg)
    pwd = PortDictionary.from_json(word_dict.to_json())
    jax_eng = JaxEngine(cfg, word_dict, params, beam_size=beam_size,
                        batch_bucket=BUCKET)
    port_eng = Engine(pcfg, pwd, params_from_jax(params, pcfg),
                      beam_size=beam_size, batch_bucket=BUCKET,
                      device="cpu")
    hists = _histories(sessions)
    got = port_eng.suggest_batch(hists)
    n_real, words = _compare(got, jax_eng.suggest_batch(hists))
    assert n_real >= len(hists) and words > 0
    # a shortlist is ignored: the copy scatter needs the whole vocabulary
    short = Engine(pcfg, pwd, params_from_jax(params, pcfg),
                   beam_size=beam_size, batch_bucket=BUCKET,
                   suggest_shortlist=6, device="cpu")
    assert short.suggest_batch(hists) == got

