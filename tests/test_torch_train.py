"""The port's training modules against the JAX package at f32: losses,
``masked_log_softmax``, the teacher-forced decoder, ``CARS.forward`` with
``make_loss_fn``'s loss and per-parameter gradients; then the port's own
dropout, checkpoint and ``Engine.from_checkpoint`` contracts.

Tolerances: losses and forward outputs 1e-5 abs; gradients 2e-5 of the
largest JAX gradient in the leaf plus 1e-7 (f32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cars import ABLATIONS, ablated, port_batch, port_model
from test_torch_cars import tiny_setup as _tiny_setup

from context_attentive_ir_tpu.models import build_model
from context_attentive_ir_tpu.models import losses as jax_losses
from context_attentive_ir_tpu.ops import masking as jax_masking
from context_attentive_ir_tpu.ops.decoder import AttnLSTMDecoder as JaxDecoder
from context_attentive_ir_tpu.train.steps import make_loss_fn as jax_loss_fn
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.data import Dictionary as PortDictionary
from context_attentive_ir_tpu_torch.models import losses
from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
from context_attentive_ir_tpu_torch.ops.decoder import AttnLSTMDecoder
from context_attentive_ir_tpu_torch.ops.layers import dropout
from context_attentive_ir_tpu_torch.ops.masking import masked_log_softmax
from context_attentive_ir_tpu_torch.serve import Engine
from context_attentive_ir_tpu_torch.train import (
    Checkpointer,
    create_train_state,
    make_loss_fn,
    make_score_step,
    make_train_step,
    param_count,
)
from context_attentive_ir_tpu_torch.train.steps import dropout_generator

TOL = 1e-5
REL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)


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


# -- losses --------------------------------------------------------------


def _rank_inputs(seed=0):
    """scores [3, 4, 6]; multi-click rows, rows without a click, a row
    whose candidates are all masked, and a padded (row_mask False) row."""
    rng = np.random.RandomState(seed)
    scores = rng.normal(size=(3, 4, 6)).astype(np.float32) * 2
    labels = (rng.rand(3, 4, 6) < 0.3).astype(np.float32)
    labels[0, 1] = 0.0                       # no click
    labels[0, 2, :3] = 1.0                   # multi-click
    cand = rng.rand(3, 4, 6) < 0.8
    cand[:, :, 0] = True
    cand[1, 3] = False                       # all candidates masked
    rows = np.ones((3, 4), bool)
    rows[2, 2:] = False                      # padded turns
    return scores, labels, cand, rows


@pytest.mark.parametrize("loss_type", ["listwise", "pairwise", "pointwise"])
def test_rank_losses_and_grads_match_jax(loss_type):
    scores, labels, cand, rows = _rank_inputs()

    def ref(s):
        return jax_losses.rank_loss(loss_type, s, jnp.asarray(labels),
                                    jnp.asarray(cand), jnp.asarray(rows),
                                    margin=0.7)

    val_j, grad_j = jax.value_and_grad(ref)(jnp.asarray(scores))
    s = _t(scores).requires_grad_()
    val = losses.rank_loss(loss_type, s, _t(labels), _t(cand), _t(rows),
                           margin=0.7)
    val.backward()
    _close(val, val_j)
    _close(s.grad, grad_j)


def test_rank_loss_edge_rows_and_names():
    scores, labels, cand, rows = _rank_inputs(1)
    # nothing valid: every rank loss is 0, not NaN
    none = np.zeros_like(rows)
    for kind in ("listwise", "pairwise", "pointwise"):
        v = losses.rank_loss(kind, _t(scores), _t(labels), _t(cand),
                             _t(none))
        assert float(v) == 0.0
    with pytest.raises(ValueError, match="loss_type"):
        losses.rank_loss("softmax", _t(scores), _t(labels), _t(cand),
                         _t(rows))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_sequence_nll_matches_jax(smoothing):
    rng = np.random.RandomState(2)
    logits = rng.normal(size=(2, 3, 5, 11)).astype(np.float32) * 2
    tgt = rng.randint(0, 11, size=(2, 3, 5))
    mask = rng.rand(2, 3, 5) < 0.7
    mask[1, 2] = False                       # a row with no target tokens
    ref = jax_losses.sequence_nll_loss(jnp.asarray(logits), jnp.asarray(tgt),
                                       jnp.asarray(mask), smoothing)
    got = losses.sequence_nll_loss(_t(logits), _t(tgt), _t(mask), smoothing)
    _close(got, ref)
    assert float(losses.sequence_nll_loss(
        _t(logits), _t(tgt), _t(np.zeros_like(mask)))) == 0.0


def test_copy_generator_nll_matches_jax():
    rng = np.random.RandomState(3)
    p = rng.rand(2, 4, 7).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    p[0, 0, :] = 0.0                         # probability floor (1e-10)
    tgt = rng.randint(0, 7, size=(2, 4))
    mask = rng.rand(2, 4) < 0.8
    mask[0, 0] = True
    ref = jax_losses.copy_generator_nll_loss(jnp.asarray(p),
                                             jnp.asarray(tgt),
                                             jnp.asarray(mask))
    _close(losses.copy_generator_nll_loss(_t(p), _t(tgt), _t(mask)), ref,
           tol=1e-4)


def test_masked_log_softmax_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.normal(size=(3, 4, 8)).astype(np.float32) * 3
    m = rng.rand(3, 4, 8) > 0.3
    m[1, 2] = False
    m[0, 0] = True
    ref = jax_masking.masked_log_softmax(jnp.asarray(x), jnp.asarray(m))
    _close(masked_log_softmax(_t(x), _t(m)), ref, tol=1e-4)


# -- the teacher-forced decoder --------------------------------------------


@pytest.mark.parametrize("with_init", [True, False])
def test_decoder_unroll_matches_flax(with_init):
    rng = np.random.RandomState(5)
    B, T, H, E, L = 3, 4, 8, 6, 5
    memory = rng.normal(size=(B, L, H)).astype(np.float32)
    mask = rng.rand(B, L) > 0.3
    mask[:, 0] = True
    init = rng.normal(size=(B, H)).astype(np.float32) if with_init else None
    embs = rng.normal(size=(B, T, E)).astype(np.float32)
    dec = JaxDecoder(features=H, embed_dim=E, dropout=0.4)
    j_init = None if init is None else jnp.asarray(init)
    params = dec.init(jax.random.key(0), jnp.asarray(embs),
                      jnp.asarray(memory), jnp.asarray(mask), j_init)
    hs_j, al_j = dec.apply(params, jnp.asarray(embs), jnp.asarray(memory),
                           jnp.asarray(mask), j_init, True)
    port = AttnLSTMDecoder(H, E, device="cpu", dropout=0.4)
    port.load_state_dict({k: _t(v) for k, v in
                          _flat(jax.device_get(params["params"])).items()})
    hs, al = port(_t(embs), _t(memory), _t(mask),
                  None if init is None else _t(init))
    assert hs.shape == (B, T, H) and al.shape == (B, T, L)
    _close(hs, hs_j)
    _close(al, al_j)
    gen = torch.Generator().manual_seed(0)
    noisy, _ = port(_t(embs), _t(memory), _t(mask), None, False, gen)
    kept = noisy != 0
    assert 0 < float(kept.float().mean()) < 1
    # kept entries are the deterministic ones scaled by 1 / (1 - p)
    base, _ = port(_t(embs), _t(memory), _t(mask), None)
    _close(noisy[kept], base[kept] / 0.6)


# -- CARS forward, loss and gradients ---------------------------------------


@pytest.fixture(scope="module")
def setup():
    return _tiny_setup()


@pytest.mark.parametrize("ablation", ABLATIONS)
def test_cars_loss_and_grads_match_jax(setup, ablation):
    """``CARS.forward`` and ``make_loss_fn``'s loss, its parts and the
    gradient of every parameter against ``jax.value_and_grad`` of the JAX
    loss, same params and batch, f32, dropout 0."""
    _, cfg, params, batch, _, _ = setup
    cfg, params = ablated(cfg, params, ablation)
    jm = build_model(cfg)
    out_j = jm.apply({"params": params}, batch, True)
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(
        jax_loss_fn(jm, cfg), has_aux=True), static_argnums=3)(
        params, batch, jax.random.key(0), True)

    pm = port_model(cfg, params)
    pb = port_batch(batch)
    out = pm(pb)
    _close(out["scores"], out_j["scores"])
    _close(out["gen_logits"], out_j["gen_logits"], tol=1e-4)
    pcfg = PortConfig.from_json(cfg.to_json())
    loss, met = make_loss_fn(pm, pcfg)(pb, deterministic=True)
    loss.backward()
    for k in ("loss", "rank_loss", "gen_loss"):
        _close(met[k], met_j[k])
    flat_g = _flat(jax.device_get(grads_j))
    assert set(flat_g) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        # a layer whose output the ablation discards gets no gradient
        # (JAX: zeros), e.g. query_flow under no_context_attn
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        _close_grad(grad, flat_g[name])


def test_loss_fn_refuses_other_families(setup):
    _, cfg, params, _, _, _ = setup
    pm = port_model(cfg, params)
    # every family of the JAX zoo has its loss; an unknown type raises
    for model_type in ("bert", "arc-ii"):
        with pytest.raises(ValueError, match="unknown model_type"):
            make_loss_fn(pm, PortConfig(model_type=model_type))


# -- dropout ---------------------------------------------------------------


def test_dropout_semantics():
    x = torch.ones(4000)
    assert dropout(x, 0.3, True, None) is x
    assert dropout(x, 0.0, False, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.3, False, None)
    y = dropout(x, 0.25, False, torch.Generator().manual_seed(0))
    kept = y != 0
    assert 0.7 < float(kept.float().mean()) < 0.8
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))


def _noisy_cfg(cfg, rate=0.3):
    return cfg.replace(dropout=rate, dropout_emb=rate, dropout_rnn=rate)


def test_deterministic_forward_equals_no_dropout(setup):
    _, cfg, params, batch, _, _ = setup
    quiet = port_model(cfg, params)
    noisy = port_model(_noisy_cfg(cfg), params)
    pb = port_batch(batch)
    with torch.no_grad():
        a, b = quiet(pb), noisy(pb, deterministic=True)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_dropout_noise_follows_the_seed(setup):
    _, cfg, params, batch, _, _ = setup
    cfg = _noisy_cfg(cfg)
    model = port_model(cfg, params)
    loss_fn = make_loss_fn(model, PortConfig.from_json(cfg.to_json()))
    pb = port_batch(batch)

    def loss(seed, step=0):
        with torch.no_grad():
            gen = dropout_generator(seed, step, "cpu")
            return float(loss_fn(pb, False, gen)[0])

    assert loss(1) == loss(1)
    assert loss(1) != loss(2)
    assert loss(1, 0) != loss(1, 1)
    with torch.no_grad():
        det = float(loss_fn(pb, deterministic=True)[0])
    assert loss(1) != det


# -- checkpoints -------------------------------------------------------------


def _train(model, cfg, batch, steps, state=None):
    state = state or create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    out = []
    for _ in range(steps):
        state, m = step(state, batch, 7)
        out.append(float(m["loss"]))
    return state, out


def _port(setup, rate=0.3):
    _, cfg, params, batch, word_dict, _ = setup
    cfg = _noisy_cfg(cfg, rate)
    pcfg = PortConfig.from_json(cfg.to_json())
    return (pcfg, PortDictionary.from_json(word_dict.to_json()),
            port_model(cfg, params), port_batch(batch))


def _fresh(pcfg, seed=5):
    return CARS(pcfg, device="cpu", seed=seed)


def test_checkpoint_round_trip(setup, tmp_path):
    pcfg, wd, model, pb = _port(setup)
    state, _ = _train(model, pcfg, pb, 2)
    ckpt = Checkpointer(tmp_path, "cars")
    ckpt.save_best(state, pcfg, wd, {"epoch": 3})
    ckpt.wait()
    cfg2, wd2, extra = Checkpointer.peek(ckpt.best_path)
    assert cfg2 == pcfg and wd2.tokens() == wd.tokens()
    assert extra == {"epoch": 3}
    other = create_train_state(_fresh(pcfg), pcfg)
    Checkpointer.load(ckpt.best_path, other)
    assert other.step == state.step == 2
    assert other.opt_state["count"] == 2
    for n, p in state.params.items():
        assert torch.equal(p, other.params[n]), n
    for k in ("mu", "nu"):
        for n, t in state.opt_state[k].items():
            assert torch.equal(t, other.opt_state[k][n]), (k, n)
    blob = Checkpointer.read_state(ckpt.best_path)
    assert set(blob) == {"params", "opt_state", "step"}


def test_resume_reproduces_an_uninterrupted_run(setup, tmp_path):
    """Dropout on: 4 steps in one go equal 2 steps, save, load into a
    fresh model, 2 more steps -- losses and weights bit for bit."""
    pcfg, wd, model, pb = _port(setup)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    full_state, full = _train(model, pcfg, pb, 4)
    final = {n: p.detach().clone() for n, p in full_state.params.items()}

    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(start[n])
    state, first = _train(model, pcfg, pb, 2)
    ckpt = Checkpointer(tmp_path, "cars", async_save=False)
    ckpt.save_latest(state, pcfg, wd)
    resumed = _fresh(pcfg)
    rstate = Checkpointer.load(ckpt.latest_path,
                               create_train_state(resumed, pcfg))
    rstate, rest = _train(resumed, pcfg, pb, 2, rstate)
    assert first + rest == full
    for n, p in rstate.params.items():
        assert torch.equal(p, final[n]), n


def test_structure_mismatch_names_the_problem(setup, tmp_path):
    pcfg, wd, model, pb = _port(setup, 0.0)
    state, _ = _train(model, pcfg, pb, 1)
    ckpt = Checkpointer(tmp_path, "cars", async_save=False)
    ckpt.save_latest(state, pcfg, wd)
    sgd = pcfg.replace(optimizer="sgd")
    with pytest.raises(ValueError, match="does not match the current "
                       "train-state structure"):
        Checkpointer.load(ckpt.latest_path,
                          create_train_state(_fresh(sgd), sgd))
    wider = pcfg.replace(nhid_ffnn=pcfg.nhid_ffnn + 1)
    with pytest.raises(ValueError, match="rank_mlp"):
        Checkpointer.load(ckpt.latest_path,
                          create_train_state(_fresh(wider), wider))


def test_checkpoint_swap_keeps_a_readable_copy(setup, tmp_path):
    pcfg, wd, model, pb = _port(setup, 0.0)
    state, _ = _train(model, pcfg, pb, 1)
    ckpt = Checkpointer(tmp_path, "cars")
    ckpt.save_latest(state, pcfg, wd, {"n": 1})
    ckpt.save_latest(state, pcfg, wd, {"n": 2})   # waits for the first
    ckpt.wait()
    path = ckpt.latest_path
    assert Checkpointer.peek(path)[2] == {"n": 2}
    assert not path.with_suffix(path.suffix + ".old").exists()
    # a crash inside the swap leaves only the renamed-aside copy
    path.rename(path.with_suffix(path.suffix + ".old"))
    assert Checkpointer.peek(path)[2] == {"n": 2}
    assert Checkpointer.read_state(path)["step"] == 1


def test_load_for_test_keeps_the_architecture(setup, tmp_path):
    pcfg, wd, model, pb = _port(setup, 0.0)
    state, _ = _train(model, pcfg, pb, 1)
    ckpt = Checkpointer(tmp_path, "cars", async_save=False)
    ckpt.save_best(state, pcfg, wd)
    new = pcfg.replace(nhid=pcfg.nhid * 2, learning_rate=0.5, vocab_size=3)
    cfg, _, _ = Checkpointer.load_for_test(ckpt.best_path, new)
    assert cfg.nhid == pcfg.nhid and cfg.vocab_size == pcfg.vocab_size
    assert cfg.learning_rate == 0.5


def test_engine_from_checkpoint_scores_like_the_trained_model(setup,
                                                              tmp_path):
    pcfg, wd, model, pb = _port(setup)
    state, _ = _train(model, pcfg, pb, 2)
    ckpt = Checkpointer(tmp_path, "cars")
    ckpt.save_best(state, pcfg, wd)
    ckpt.wait()
    sessions = setup[5]
    join = " ".join
    reqs = [(join(s.queries[-1].tokens),
             [join(d.tokens) for d in s.queries[-1].documents],
             [join(q.tokens) for q in s.queries[:-1]]) for s in sessions]
    loaded = Engine.from_checkpoint(ckpt.best_path, beam_size=2,
                                    batch_bucket=4, device="cpu")
    in_memory = Engine(pcfg, wd, model.state_dict(), beam_size=2,
                       batch_bucket=4, device="cpu")
    assert loaded.rank_batch(reqs) == in_memory.rank_batch(reqs)
    hist = [r[2] + [r[0]] for r in reqs]
    assert loaded.suggest_batch(hist) == in_memory.suggest_batch(hist)
    # the score step is the model's own score
    scores = make_score_step(model, pcfg)(pb)
    assert scores.shape == pb.clicks.shape
    # the int8 table: scores near the float engine's (the JAX package's
    # tolerance, tests/test_serve.py:103)
    int8 = Engine.from_checkpoint(ckpt.best_path, quantize_embeddings=True,
                                  batch_bucket=4, device="cpu")
    assert int8.model.embeddings.embedding_q.dtype == torch.int8
    np.testing.assert_allclose(np.concatenate(int8.rank_batch(reqs)),
                               np.concatenate(in_memory.rank_batch(reqs)),
                               atol=0.08, rtol=0.1)


def test_param_count_matches_jax(setup):
    _, cfg, params, _, _, _ = setup
    pm = port_model(cfg, params)
    state = create_train_state(pm, PortConfig.from_json(cfg.to_json()))
    assert param_count(state) == sum(
        np.asarray(v).size for v in _flat(params).values())
    assert dataclasses.is_dataclass(state)
