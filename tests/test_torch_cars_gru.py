"""CARS with GRU encoders and GRU session recurrences (``rnn_type =
session_rnn_type = "gru"``) in the port against the JAX package at f32,
from one JAX init bridged by ``convert.params_from_jax``: slate scores,
``decode_init`` and decode steps, the ``Engine``'s ``rank_batch`` scores
and beam-5 / greedy suggestions, the loss and every parameter's gradient
for the three ``cars_ablation`` values, and three SGD steps.

The port runs on the CPU, where the GRU kernels take their plain versions
(kernel 7 when serving, the pair 8 / 9 when training).  The recurrent
biases are random (flax initialises them to 0), so ``b_hh`` is exercised.
Tolerances as in tests/test_torch_cars.py and tests/test_torch_train.py:
scores 1e-4 abs, decoder states and logits 1e-5 abs, losses 1e-5 abs,
gradients 2e-5 of the largest JAX gradient in the leaf plus 1e-7,
parameters after three SGD steps 2e-6 abs; suggestion tokens exact, scores
1e-4, compared only where the JAX score is above NEG_INF.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_cars import ABLATIONS, ablated, port_batch, port_model
from test_torch_cars import tiny_setup

from context_attentive_ir_tpu.constants import EOS
from context_attentive_ir_tpu.models import build_model
from context_attentive_ir_tpu.serve import Engine as JaxEngine
from context_attentive_ir_tpu.train.state import TrainState as JaxTrainState
from context_attentive_ir_tpu.train.state import (
    make_optimizer as jax_make_optimizer,
)
from context_attentive_ir_tpu.train.steps import make_loss_fn as jax_loss_fn
from context_attentive_ir_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.data import Dictionary as PortDictionary
from context_attentive_ir_tpu_torch.ops import rnn as port_rnn
from context_attentive_ir_tpu_torch.ops.kernels import gru as gru_kernels
from context_attentive_ir_tpu_torch.serve import Engine as PortEngine
from context_attentive_ir_tpu_torch.train import (
    create_train_state,
    make_loss_fn,
    make_train_step,
)

BUCKET = 4
REAL = -1e8
REL = 2e-5
GRU = dict(rnn_type="gru", session_rnn_type="gru")


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _close(a, b, atol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


def _close_grad(got, ref):
    ref = _np(ref)
    err = float(np.max(np.abs(_np(got) - ref)))
    assert err <= REL * float(np.max(np.abs(ref))) + 1e-7, err


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def setup():
    """tiny_setup's CARS with GRUs everywhere and random recurrent
    biases."""
    jm, cfg, params, batch, word_dict, sessions = tiny_setup(**GRU)
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.RandomState(11)
    for mod in ("query_encoder", "doc_encoder", "query_flow", "click_flow"):
        for name, v in _flat(params[mod]).items():
            if name.rsplit(".", 1)[-1].startswith("b_"):
                v[...] = rng.normal(size=v.shape) * 0.2
    assert "b_hh_fwd" in params["query_flow"]
    return jm, cfg, params, batch, word_dict, sessions


def _both(setup, ablation):
    _, cfg, params, batch, _, _ = setup
    cfg, params = ablated(cfg, params, ablation)
    return build_model(cfg), cfg, params, port_model(cfg, params), batch


@pytest.mark.parametrize("ablation", ABLATIONS)
def test_score_matches_jax(setup, ablation):
    jm, _, params, pm, batch = _both(setup, ablation)
    assert pm.query_encoder.layer0.rnn_type == "gru"
    assert pm.query_flow.rnn_type == "gru"
    ref = jm.apply({"params": params}, batch, method=jm.score)
    got = pm.score(port_batch(batch))
    assert got.shape == ref.shape
    _close(got, ref, 1e-4)


@pytest.mark.parametrize("ablation", ABLATIONS)
def test_decode_matches_jax(setup, ablation):
    """``decode_init`` and ``decode_init_full``, then two decode steps
    (logits and the fused step's projection) fed the same tokens."""
    jm, _, params, pm, batch = _both(setup, ablation)
    var = {"params": params}
    pb = port_batch(batch)
    for method in ("decode_init_full", "decode_init"):
        st_j, mem_j, mask_j = jm.apply(var, batch, method=getattr(jm, method))
        st_p, mem_p, mask_p = getattr(pm, method)(pb)
        _close(mem_p, mem_j, 1e-5)
        np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_j))
        for a, b in zip(st_p["h"], st_j["h"]):
            _close(a, b, 1e-5)
    rng = np.random.RandomState(3)
    for _ in range(2):
        toks = rng.randint(0, jm.config.vocab_size, size=mem_p.shape[0])
        _, proj_j, _ = jm.apply(var, st_j, jax.numpy.asarray(toks), mem_j,
                                mask_j, method=jm.decode_step_fused)
        st_j, logits_j, _ = jm.apply(var, st_j, jax.numpy.asarray(toks),
                                     mem_j, mask_j, method=jm.decode_step)
        t = pb.query.new_tensor(toks)
        _, proj_p, _ = pm.decode_step_fused(st_p, t, mem_p, mask_p)
        st_p, logits_p, _ = pm.decode_step(st_p, t, mem_p, mask_p)
        _close(proj_p, proj_j, 1e-5)
        _close(logits_p, logits_j, 1e-5)


@pytest.fixture(scope="module")
def served(setup):
    _, cfg, params, _, word_dict, sessions = setup
    params = jax.tree_util.tree_map(np.array, params)
    table = params["embeddings"]["embedding"]
    table[EOS] *= 10.0
    params["generator"]["tie_proj"]["bias"] = (
        0.05 * table[EOS] / (table[EOS] @ table[EOS]))
    pcfg = PortConfig.from_json(cfg.to_json())
    port = (pcfg, PortDictionary.from_json(word_dict.to_json()),
            params_from_jax(params, pcfg))
    join = " ".join
    reqs = []
    for s in sessions[:5]:
        *hist, cur = s.queries
        history = [(join(q.tokens), [join(d.tokens) for d in q.documents
                                     if d.label]) for q in hist]
        reqs.append((join(cur.tokens), [join(d.tokens)
                                        for d in cur.documents], history))
    reqs[2] = (reqs[2][0], reqs[2][1][:3], ())
    return cfg, word_dict, params, port, reqs


def test_rank_batch_matches_jax(served):
    cfg, wd, params, (pcfg, pwd, psd), reqs = served
    ref = JaxEngine(cfg, wd, params, batch_bucket=BUCKET).rank_batch(reqs)
    eng = PortEngine(pcfg, pwd, psd, batch_bucket=BUCKET, device="cpu")
    got = eng.rank_batch(reqs)
    assert eng.family == "multitask"
    assert [len(r) for r in got] == [len(r) for r in ref]
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(ref),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("beam_size", [5, 1])
def test_suggest_batch_matches_jax(served, beam_size):
    cfg, wd, params, (pcfg, pwd, psd), reqs = served
    hists = [list(h) + [q] for q, _, h in reqs]
    hists += [[(q, docs[:6])] + [q] for q, docs, _ in reqs[:3]]  # > cap
    ref = JaxEngine(cfg, wd, params, beam_size=beam_size,
                    batch_bucket=BUCKET).suggest_batch(hists)
    got = PortEngine(pcfg, pwd, psd, beam_size=beam_size,
                     batch_bucket=BUCKET, device="cpu").suggest_batch(hists)
    assert [len(nb) for nb in got] == [len(nb) for nb in ref]
    n_real, words = 0, 0
    for nb_p, nb_j in zip(got, ref):
        for (tp, sp), (tj, sj) in zip(nb_p, nb_j):
            if sj > REAL:
                n_real += 1
                words += len(tp.split())
                assert tp == tj
                assert abs(sp - sj) <= 1e-4
    assert n_real >= len(hists) and words > 0


@pytest.mark.parametrize("ablation", ABLATIONS)
def test_loss_and_grads_match_jax(setup, monkeypatch, ablation):
    """``CARS.forward`` and ``make_loss_fn`` against ``jax.value_and_grad``
    of the JAX loss; the encoders train through ``gru_fused_train`` (the
    pair 8 / 9), four calls: query and doc encoder, two directions."""
    jm, cfg, params, pm, batch = _both(setup, ablation)
    (_, met_j), grads_j = jax.jit(jax.value_and_grad(
        jax_loss_fn(jm, cfg), has_aux=True), static_argnums=3)(
        params, batch, jax.random.key(0), True)
    calls = []
    for name in ("gru_fused", "gru_fused_train"):
        fn = getattr(port_rnn, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(port_rnn, name, spy)
    pcfg = PortConfig.from_json(cfg.to_json())
    loss, met = make_loss_fn(pm, pcfg)(port_batch(batch), deterministic=True)
    loss.backward()
    assert calls == ["gru_fused_train"] * 4
    for k in ("loss", "rank_loss", "gen_loss"):
        _close(met[k], met_j[k], 1e-5)
    flat_g = _flat(jax.device_get(grads_j))
    assert set(flat_g) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        # a layer whose output the ablation discards gets no gradient
        # (JAX: zeros), e.g. query_flow under no_context_attn
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        _close_grad(grad, flat_g[name])


def test_three_sgd_steps_match_jax(setup):
    _, cfg, params, batch, _, _ = setup
    cfg = cfg.replace(optimizer="sgd", learning_rate=0.5, momentum=0.9)
    jm = build_model(cfg)
    jstate = JaxTrainState.create(apply_fn=jm.apply, params=params,
                                  tx=jax_make_optimizer(cfg))
    jstep = jax_make_train_step(jm, cfg)
    pcfg = PortConfig.from_json(cfg.to_json())
    pm = port_model(cfg, params)
    pstate = create_train_state(pm, pcfg)
    pstep = make_train_step(pm, pcfg)
    pb = port_batch(batch)
    for i in range(3):
        jstate, mj = jstep(jstate, batch, jax.random.key(1))
        pstate, mp = pstep(pstate, pb, 1)
        for k in ("loss", "rank_loss", "gen_loss", "grad_norm"):
            rel = abs(float(mp[k]) - float(mj[k])) / abs(float(mj[k]))
            assert rel <= 1e-5, (i, k, float(mp[k]), float(mj[k]))
    flat_j = _flat(jax.device_get(jstate.params))
    for n, p in pm.named_parameters():
        err = float(np.max(np.abs(p.detach().numpy() - np.asarray(
            flat_j[n]))))
        assert err <= 2e-6, (n, err)


def test_gru_kernels_unlaunched_on_cpu(setup, served, monkeypatch):
    """The whole CPU path (rank, suggest, a train step) takes the plain
    versions: the GRU kernels' launch counts stay 0."""
    kernels = (gru_kernels.gru_fused, gru_kernels.gru_fused_res,
               gru_kernels.gru_fused_bwd)
    for fn in kernels:
        monkeypatch.setattr(fn, "launches", 0)
    _, cfg, params, batch, _, _ = setup
    _, _, _, (pcfg, pwd, psd), reqs = served
    eng = PortEngine(pcfg, pwd, psd, beam_size=2, batch_bucket=BUCKET,
                     device="cpu")
    assert len(eng.rank_batch(reqs[:2])) == 2
    assert len(eng.suggest_batch([[reqs[0][0]]])[0]) == 2
    pm = port_model(cfg, params)
    state, m = make_train_step(pm, pcfg)(create_train_state(pm, pcfg),
                                         port_batch(batch), 0)
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    assert [fn.launches for fn in kernels] == [0, 0, 0]
