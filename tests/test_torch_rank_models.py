"""The representation rankers ESM, DSSM (with and without
``use_charngram``), CDSSM and DUET in the port against the JAX package at
f32: the parameter tree, the slate scores, ``rank_loss`` under every
``loss_type`` with every gradient, three SGD steps; ESM's and DSSM's
finite gradients on padded batches (F12); ESM's step under its published
frozen table.  The checks are functions of a setup, so that
``tests/test_torch_rank_interaction.py`` runs them on ARC-I, ARC-II, DRMM
and Match-Tensor.

Both packages get the same weights through ``convert.params_from_jax``
(every bias randomised but in the F12 check); the port runs on the CPU.
The ragged batch has a padded row, an empty candidate slot and a row
without a click.
Tolerances: scores at valid candidates 1e-5 abs (1e-5 of the largest score
where it exceeds 1: DSSM's and CDSSM's gamma of 10), only finite
elsewhere; losses 1e-5 relative; gradients 2e-5 of the largest JAX
gradient in the leaf plus 1e-7 (``tests/test_torch_mnsrf.py``'s);
parameters after three SGD steps 2e-6 abs.

JAX's gradient is NaN for ESM and DSSM wherever a masked mean is a zero
vector (a padded row, an empty slot: ``jnp.linalg.norm`` at 0), so their
gradients are compared on a full batch; on the ragged batch the port's
gradient must be finite and equal to the JAX gradient of the same loss
summed over the valid rows one at a time, each unpadded (F12).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.config import default_config
from context_attentive_ir_tpu.data import (
    ShapeConfig,
    build_dictionary,
    build_rank_batch,
    generate_sessions,
    rank_examples,
)
from context_attentive_ir_tpu.data.objects import Session
from context_attentive_ir_tpu.models import build_model as jax_build_model
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
from context_attentive_ir_tpu_torch.data import RankBatch as PortBatch
from context_attentive_ir_tpu_torch.models import build_model
from context_attentive_ir_tpu_torch.train import (
    create_train_state,
    make_eval_loss_step,
    make_loss_fn,
    make_score_step,
    make_train_step,
)

DIMS = dict(emsize=16, nhid=8, nhid_ffnn=16, nfilters=8, max_query_len=5,
            max_doc_len=7, num_candidates=4, dropout=0.0, dropout_emb=0.0,
            dropout_rnn=0.0)
WORD_LEN = 6
LOSS_TYPES = ("listwise", "pairwise", "pointwise")
TOL = 1e-5
REL = 2e-5
# JAX's gradient is NaN on a padded batch (F12)
ZERO_NORM_MODELS = ("esm", "dssm")


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close_grad(got, ref, name=""):
    ref = _np(ref)
    err = float(np.max(np.abs(_np(got) - ref)))
    assert err <= REL * float(np.max(np.abs(ref))) + 1e-7, (name, err)


@dataclasses.dataclass
class RankSetup:
    cfg: object           # the JAX config
    params: dict          # the JAX param tree (numpy)
    batch: object         # ragged: a padded row, an empty slot, no click
    full: object          # every row and slot valid
    examples: list
    shapes: object
    word_dict: object
    sessions: list

    @property
    def grad_batch(self):
        """The batch on which JAX's gradient is finite."""
        return (self.full if self.cfg.model_type in ZERO_NORM_MODELS
                else self.batch)


def rank_setup(model_type, seed=0, random_bias=True, **overrides):
    """A tiny f32 ranker and its batches.  The clicked documents are moved
    to the front of each slate but the last (a row without a click within
    N), the first example keeps 2 of N = 4 documents (empty slots), the
    ragged batch has one padded row.  ``random_bias`` replaces the zero
    biases of the JAX init."""
    sessions = [Session.from_dict(d) for d in generate_sessions(
        n_sessions=4, min_turns=1, max_turns=3, n_candidates=6, seed=seed)]
    examples = rank_examples(sessions)
    for q in examples[:-1]:
        q.documents.sort(key=lambda d: -d.label)
    examples[-1].documents.sort(key=lambda d: d.label)
    examples[0].documents = examples[0].documents[:2]
    streams = [q.tokens for q in examples]
    streams += [d.tokens for q in examples for d in q.documents]
    word_dict = build_dictionary(streams)
    cfg = default_config(model_type).replace(vocab_size=len(word_dict),
                                             **{**DIMS, **overrides})
    shapes = ShapeConfig(cfg.max_query_len, cfg.max_doc_len, 3,
                         cfg.num_candidates,
                         max_word_len=WORD_LEN if cfg.use_charngram else 0)
    batch = build_rank_batch(examples, word_dict, shapes,
                             batch_size=len(examples) + 1)
    full = build_rank_batch(examples[1:], word_dict, shapes)
    assert np.asarray(full.cand_mask).all()
    model = jax_build_model(cfg)
    params = jax.device_get(model.init({"params": jax.random.key(seed)},
                                       batch, True)["params"])
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.RandomState(seed)
    for name, v in _flat(params).items():
        if random_bias and name.rsplit(".", 1)[-1] in (
                "bias", "b_ih_fwd", "b_ih_bwd", "b_hh_fwd", "b_hh_bwd"):
            v[...] = rng.normal(size=v.shape) * 0.2
    return RankSetup(cfg, params, batch, full, examples, shapes, word_dict,
                     sessions)


def port_config(cfg):
    return PortConfig.from_json(cfg.to_json())


def port_model(cfg, params):
    pcfg = port_config(cfg)
    model = build_model(pcfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(params, pcfg))
    return model


def port_batch(batch):
    def arr(a):
        return None if a is None else np.asarray(a)

    return PortBatch(**{f.name: arr(getattr(batch, f.name))
                        for f in dataclasses.fields(PortBatch)}).to("cpu")


def valid_slots(batch):
    return np.asarray(batch.cand_mask) & np.asarray(batch.row_mask)[:, None]


def _jax_loss_and_grads(cfg, params, batch):
    jm = jax_build_model(cfg)
    return jax.jit(jax.value_and_grad(jax_loss_fn(jm, cfg), has_aux=True),
                   static_argnums=3)(params, batch, jax.random.key(0), True)


# -- the checks ---------------------------------------------------------------


def check_param_tree(st):
    """The port's parameters are exactly the JAX tree's leaves and
    shapes."""
    flat = _flat(st.params)
    pm = port_model(st.cfg, st.params)
    assert {n: tuple(p.shape) for n, p in pm.named_parameters()} == {
        n: v.shape for n, v in flat.items()}


def check_scores(st):
    """``[B, N]`` scores against ``model.apply`` at valid candidates,
    finite everywhere; ``make_score_step`` equals the forward."""
    jm = jax_build_model(st.cfg)
    ref = np.asarray(jm.apply({"params": st.params}, st.batch, True))
    pm = port_model(st.cfg, st.params)
    got = pm(port_batch(st.batch))
    valid = valid_slots(st.batch)
    assert not valid.all() and valid.any()
    assert got.shape == ref.shape == valid.shape
    assert torch.isfinite(got).all()
    tol = TOL * max(1.0, float(np.abs(ref[valid]).max()))
    np.testing.assert_allclose(_np(got)[valid], ref[valid], rtol=0, atol=tol)
    scored = make_score_step(pm, port_config(st.cfg))(port_batch(st.batch))
    np.testing.assert_array_equal(_np(scored), _np(got))


def check_loss_and_grads(st, loss_type):
    """``make_loss_fn``'s ranker branch and every parameter's gradient
    against ``jax.value_and_grad`` of the JAX loss, on the batch where
    JAX's gradient is finite; the eval-loss step equals the loss."""
    cfg = st.cfg.replace(loss_type=loss_type)
    batch = st.grad_batch
    (loss_j, met_j), grads_j = _jax_loss_and_grads(cfg, st.params, batch)
    pm = port_model(cfg, st.params)
    pcfg = port_config(cfg)
    loss, met = make_loss_fn(pm, pcfg)(port_batch(batch), deterministic=True)
    loss.backward()
    assert set(met) == set(met_j) == {"loss", "rank_loss"}
    for k in met:
        assert abs(float(met[k].detach()) - float(met_j[k])) <= TOL * max(
            1.0, abs(float(met_j[k]))), k
    flat_g = _flat(jax.device_get(grads_j))
    assert set(flat_g) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        assert np.isfinite(flat_g[name]).all(), name
        if p.grad is None:   # a frozen table: JAX's gradient is 0
            assert not np.any(flat_g[name]), name
            continue
        assert torch.isfinite(p.grad).all(), name
        _close_grad(p.grad, flat_g[name], name)
    with torch.no_grad():
        ev = make_eval_loss_step(pm, pcfg)(port_batch(batch))
    assert abs(float(ev["loss"]) - float(loss_j)) <= TOL * max(
        1.0, abs(float(loss_j)))


def check_padded_gradients_finite(st):
    """F12: on the ragged batch (listwise) the port's loss equals JAX's and
    its gradient is finite and equals the JAX gradient of the same loss
    built row by row from unpadded single-row batches (each row's own N,
    no padded row): the mean over the rows with a click."""
    cfg = st.cfg.replace(loss_type="listwise")
    (_, _), grads_j = _jax_loss_and_grads(cfg, st.params, st.batch)
    assert not all(np.isfinite(v).all()
                   for v in _flat(jax.device_get(grads_j)).values())
    pm = port_model(cfg, st.params)
    loss, _ = make_loss_fn(pm, port_config(cfg))(port_batch(st.batch),
                                                 deterministic=True)
    loss.backward()
    total, clicked, loss_rows = None, 0, 0.0
    for q in st.examples:
        n = min(len(q.documents), st.cfg.num_candidates)
        if not any(d.label for d in q.documents[:n]):
            continue
        shapes = dataclasses.replace(st.shapes, num_candidates=n)
        one = build_rank_batch([q], st.word_dict, shapes)
        (l_j, _), g = _jax_loss_and_grads(cfg, st.params, one)
        g = _flat(jax.device_get(g))
        total = g if total is None else {k: total[k] + g[k] for k in g}
        clicked += 1
        loss_rows += float(l_j)
    assert 0 < clicked < len(st.examples)
    assert abs(float(loss.detach()) - loss_rows / clicked) <= TOL
    for name, p in pm.named_parameters():
        ref = total[name] / clicked
        assert np.isfinite(ref).all(), name
        if p.grad is None:
            assert not np.any(ref), name
            continue
        assert torch.isfinite(p.grad).all(), name
        _close_grad(p.grad, ref, name)


def check_three_sgd_steps(st):
    cfg = st.cfg.replace(optimizer="sgd", learning_rate=0.5, momentum=0.9)
    jm = jax_build_model(cfg)
    jstate = JaxTrainState.create(apply_fn=jm.apply, params=st.params,
                                  tx=jax_make_optimizer(cfg))
    jstep = jax_make_train_step(jm, cfg)
    pm = port_model(cfg, st.params)
    pstate = create_train_state(pm, port_config(cfg))
    pstep = make_train_step(pm, port_config(cfg))
    batch = st.grad_batch
    pb = port_batch(batch)
    for i in range(3):
        jstate, mj = jstep(jstate, batch, jax.random.key(1))
        pstate, mp = pstep(pstate, pb, 1)
        for k in ("loss", "rank_loss", "grad_norm"):
            rel = abs(float(mp[k]) - float(mj[k])) / abs(float(mj[k]))
            assert rel <= 1e-5, (i, k, float(mp[k]), float(mj[k]))
    assert pstate.step == int(jstate.step) == 3
    flat_j = _flat(jax.device_get(jstate.params))
    for n, p in pm.named_parameters():
        err = float(np.max(np.abs(p.detach().numpy() - flat_j[n])))
        assert err <= 2e-6, (n, err)


# -- the models ---------------------------------------------------------------

VARIANTS = {
    "esm": ("esm", dict(fix_embeddings=False)),
    "dssm": ("dssm", {}),
    "dssm-charngram": ("dssm", dict(use_charngram=True)),
    "cdssm": ("cdssm", dict(filter_widths=(2, 3))),
    "duet": ("duet", {}),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def setup(request):
    model_type, overrides = VARIANTS[request.param]
    return rank_setup(model_type, **overrides)


def test_param_tree_matches_jax(setup):
    check_param_tree(setup)


def test_scores_match_jax(setup):
    check_scores(setup)


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_loss_and_grads_match_jax(setup, loss_type):
    check_loss_and_grads(setup, loss_type)


def test_three_sgd_steps_match_jax(setup):
    check_three_sgd_steps(setup)


@pytest.mark.parametrize("variant", ["esm", "dssm"])
def test_padded_gradients_finite_and_equal_unpadded(variant):
    """At the JAX init (zero biases: DSSM's tower maps a zero mean to a
    zero vector, as in the probe of ROADMAP F12)."""
    model_type, overrides = VARIANTS[variant]
    check_padded_gradients_finite(rank_setup(model_type, random_bias=False,
                                             **overrides))


def test_charngram_tree_and_refusal():
    """``use_charngram`` adds ``char_cnn`` and widens the tower by its 96
    features, as flax creates them; a batch without character ids is
    refused."""
    st = rank_setup("dssm", use_charngram=True)
    pm = port_model(st.cfg, st.params)
    assert tuple(pm.tower.fc0.kernel.shape) == (16 + 96, 16)
    assert "char_cnn.conv4.kernel" in dict(pm.named_parameters())
    plain = dataclasses.replace(port_batch(st.batch), query_chars=None,
                                doc_chars=None)
    with pytest.raises(ValueError, match="max_word_len"):
        pm(plain)


def test_esm_frozen_table_step():
    """ESM under its published ``fix_embeddings=True``: the loss reaches no
    trainable parameter; the step runs, the count advances, the metrics
    equal JAX's (``grad_norm`` 0) and no parameter moves."""
    st = rank_setup("esm")
    assert st.cfg.fix_embeddings
    cfg = st.cfg.replace(learning_rate=0.1)
    jm = jax_build_model(cfg)
    jstate = JaxTrainState.create(apply_fn=jm.apply, params=st.params,
                                  tx=jax_make_optimizer(cfg))
    jstate, mj = jax_make_train_step(jm, cfg)(jstate, st.batch,
                                              jax.random.key(0))
    pm = port_model(cfg, st.params)
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    state = create_train_state(pm, port_config(cfg))
    step = make_train_step(pm, port_config(cfg))
    for _ in range(2):
        state, m = step(state, port_batch(st.batch), 0)
    assert state.step == 2 and state.opt_state["count"] == 2
    assert float(m["grad_norm"]) == float(mj["grad_norm"]) == 0.0
    assert abs(float(m["loss"]) - float(mj["loss"])) <= TOL
    for n, p in pm.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    np.testing.assert_array_equal(
        np.asarray(jstate.params["embeddings"]["embedding"]),
        st.params["embeddings"]["embedding"])
