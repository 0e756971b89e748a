"""HRED-QS in the port against the JAX package at f32: the suggest batch,
the model (teacher-forced logits, ``decode_init``, ``decode_step``), the
``Engine``'s beam-5 and greedy suggestions, the recommender loss and its
gradients, three optimizer steps, and the port's own checkpoint ->
``Engine.from_checkpoint`` round trip and ``ServeError``s.

Both packages get the same weights through ``convert.params_from_jax``;
the port runs on the CPU, where its GRU kernels take their plain versions.
Tolerances: logits, states and losses 1e-5 abs (f32 sums in another
order); gradients 2e-5 of the largest JAX gradient in the leaf plus 1e-7;
parameters after three SGD steps 2e-6 abs; suggestion tokens exact and
their scores 1e-4 abs, compared only where the JAX score is a real
hypothesis (above NEG_INF; ROADMAP Queue 3).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

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
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.data import Dictionary as PortDictionary
from context_attentive_ir_tpu_torch.data import ShapeConfig as PortShapes
from context_attentive_ir_tpu_torch.data import build_suggest_batch
from context_attentive_ir_tpu_torch.data.objects import Query as PortQuery
from context_attentive_ir_tpu_torch.models import (
    build_model,
    get_model_class,
    task_family,
)
from context_attentive_ir_tpu_torch.models.recommenders.hredqs import (
    HredQS,
    last_valid,
)
from context_attentive_ir_tpu_torch.serve import Engine, ServeError
from context_attentive_ir_tpu_torch.train import (
    Checkpointer,
    create_train_state,
    make_eval_loss_step,
    make_loss_fn,
    make_score_step,
    make_train_step,
)

DIMS = dict(emsize=32, nhid=16, max_query_len=6, max_session_len=3,
            dropout=0.0, dropout_emb=0.0, dropout_rnn=0.0)
BUCKET = 4
REAL = -1e8   # n-best scores below this are NEG_INF garbage beams
TOL = 1e-5
REL = 2e-5


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
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def hred_setup(rnn_type="gru", seed=0):
    """(config, params, jax batch, word_dict, sessions, examples) of a tiny
    f32 HRED-QS whose EOS logit varies with the decoder state, so decodes
    end at different steps, and whose recurrent biases are random.  The
    batch has two padded rows."""
    sessions = [Session.from_dict(d) for d in generate_sessions(
        n_sessions=5, min_turns=2, max_turns=5, n_candidates=3, seed=seed)]
    word_dict = build_dictionary([q.tokens for s in sessions
                                  for q in s.queries])
    cfg = default_config("hredqs").replace(
        vocab_size=len(word_dict), rnn_type=rnn_type,
        session_rnn_type=rnn_type, **DIMS)
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
    for leaf in ("query_encoder", "session_rnn"):
        for name, v in _flat(params[leaf]).items():
            if name.rsplit(".", 1)[-1].startswith("b_"):
                v[...] = rng.normal(size=v.shape) * 0.2
    table = params["embeddings"]["embedding"]
    table[BOS] *= 0.3    # else random decoders keep predicting BOS
    table[EOS] *= 10.0
    params["generator"]["tie_proj"]["bias"] = (
        0.05 * table[EOS] / (table[EOS] @ table[EOS]))
    return cfg, params, batch, word_dict, sessions, examples


@pytest.fixture(scope="module", params=["gru", "lstm"])
def setup(request):
    return hred_setup(request.param)


@pytest.fixture(scope="module")
def gru_setup():
    return hred_setup("gru", seed=2)


def port_config(cfg):
    return PortConfig.from_json(cfg.to_json())


def port_model(cfg, params):
    pcfg = port_config(cfg)
    model = HredQS(pcfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(params, pcfg))
    return model


def port_batch(batch):
    from context_attentive_ir_tpu_torch.data import SuggestBatch

    return SuggestBatch(**{f.name: np.asarray(getattr(batch, f.name))
                           for f in dataclasses.fields(SuggestBatch)}
                        ).to("cpu")


# -- the batch ---------------------------------------------------------------


def _port_examples(examples):
    def q(x):
        return PortQuery(x.query_id, list(x.tokens), [])

    return [([q(c) for c in ctx], q(cur), q(nxt))
            for ctx, cur, nxt in examples]


@pytest.mark.parametrize("batch_size", [None, 13])
def test_build_suggest_batch_bit_equal(gru_setup, batch_size):
    """Every leaf of the port's suggest batch equals the JAX package's,
    bit for bit, with long sessions (more turns than S), long queries
    (more tokens than Lq: the flat source truncates per turn), an unknown
    word and padded rows."""
    _, _, _, word_dict, _, examples = gru_setup
    examples = list(examples)
    long_q = examples[0][2].__class__("long", ["zzz-unknown"] * 3
                                      + examples[0][2].tokens * 4, [])
    examples.append((examples[-1][0] * 3 + [long_q], long_q, long_q))
    shapes = ShapeConfig(6, 30, 3, 50)
    ref = jax_build_suggest_batch(examples, word_dict, shapes,
                                  batch_size=batch_size)
    pwd = PortDictionary.from_json(word_dict.to_json())
    got = build_suggest_batch(_port_examples(examples), pwd,
                              PortShapes(6, 30, 3, 50),
                              batch_size=batch_size)
    assert PortShapes(6, 30, 3, 50).max_source_len == shapes.max_source_len
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), np.asarray(getattr(ref, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert np.array_equal(a, b), f.name
    moved = got.to("cpu")
    assert moved.context.dtype == torch.int64
    assert moved.turn_mask.dtype == torch.bool


# -- the model ---------------------------------------------------------------


def test_logits_match_jax(setup):
    cfg, params, batch, _, _, _ = setup
    jm = jax_build_model(cfg)
    ref = jm.apply({"params": params}, batch, True)
    got = port_model(cfg, params)(port_batch(batch))
    assert got.shape == ref.shape
    _close(got, ref)


def test_decode_init_and_steps_match_jax(setup):
    cfg, params, batch, _, _, _ = setup
    jm = jax_build_model(cfg)
    var = {"params": params}
    st_j, mem_j, mask_j = jm.apply(var, batch, method=jm.decode_init)
    pm = port_model(cfg, params)
    st_p, mem_p, mask_p = pm.decode_init(port_batch(batch))
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
    assert not hasattr(pm, "decode_step_fused")


def test_last_valid_picks_the_last_true_turn():
    states = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    mask = torch.tensor([[True, True, True, False], [False] * 4])
    got = last_valid(states, mask)
    assert torch.equal(got, torch.stack([states[0, 2], states[1, 0]]))


# -- the Engine --------------------------------------------------------------


def _engines(cfg, params, word_dict, **kw):
    pcfg = port_config(cfg)
    jax_eng = JaxEngine(cfg, word_dict, params, batch_bucket=BUCKET, **kw)
    port_eng = Engine(pcfg, PortDictionary.from_json(word_dict.to_json()),
                      params_from_jax(params, pcfg), batch_bucket=BUCKET,
                      device="cpu", **kw)
    return jax_eng, port_eng


def _histories(sessions):
    """Five histories past one bucket edge: whole sessions (some longer than
    S), a one-query history, and a (query, [clicked docs]) entry, whose
    clicks a recommender ignores."""
    hists = [[" ".join(q.tokens) for q in s.queries] for s in sessions]
    hists[1] = hists[1][-1:]
    hists[2] = [(hists[2][0], ["some clicked doc"])] + hists[2][1:]
    return hists


def _compare(got, ref):
    assert [len(nb) for nb in got] == [len(nb) for nb in ref]
    n_real, words = 0, 0
    for nb_p, nb_j in zip(got, ref):
        for (tp, sp), (tj, sj) in zip(nb_p, nb_j):
            if sj > REAL:
                n_real += 1
                words += len(tp.split())
                assert tp == tj
                assert abs(sp - sj) <= 1e-4
    return n_real, words


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("beam_size", [5, 1])
def test_suggest_batch_matches_jax(setup, beam_size, early_exit):
    cfg, params, _, word_dict, sessions, _ = setup
    jax_eng, port_eng = _engines(cfg, params, word_dict, beam_size=beam_size,
                                 suggest_early_exit=early_exit)
    hists = _histories(sessions)
    n_real, words = _compare(port_eng.suggest_batch(hists),
                             jax_eng.suggest_batch(hists))
    assert n_real >= len(hists) and words > 0
    assert port_eng.family == "recommender"


def test_suggest_ignores_the_shortlist_like_jax(gru_setup):
    """Without a fused step the JAX engine decodes through the logits
    step, shortlist or not; so does the port."""
    cfg, params, _, word_dict, sessions, _ = gru_setup
    _, plain = _engines(cfg, params, word_dict)
    jax_eng, port_eng = _engines(cfg, params, word_dict,
                                 suggest_shortlist=8)
    hists = _histories(sessions)
    got = port_eng.suggest_batch(hists)
    assert got == plain.suggest_batch(hists)
    _compare(got, jax_eng.suggest_batch(hists))


def test_serve_errors(gru_setup):
    cfg, params, _, word_dict, _, _ = gru_setup
    _, eng = _engines(cfg, params, word_dict)
    with pytest.raises(ServeError, match="cannot rank"):
        eng.rank_batch([("a query", ["a doc"], ())])
    with pytest.raises(ServeError, match="cannot rank"):
        eng.rank("a query", ["a doc"])
    with pytest.raises(ServeError, match="cached-doc"):
        eng.index_documents(["a doc"])
    with pytest.raises(ServeError, match="cached-doc"):
        eng.rank_indexed_batch([("a query", [0], ())],
                               {"states": torch.zeros(1, 2, 32)})
    for bad in ([], [[]], [["a query"], []]):
        with pytest.raises(ServeError, match="at least"):
            eng.suggest_batch(bad)
    # a ranker serves and refuses to suggest
    pcfg = port_config(cfg).replace(model_type="arcii")
    ranker = Engine(pcfg, eng.word_dict,
                    build_model(pcfg, device="cpu").state_dict(),
                    device="cpu")
    with pytest.raises(ServeError, match="arcii cannot suggest"):
        ranker.suggest_batch([["a query"]])


def test_model_registry():
    assert task_family("hredqs") == "recommender"
    assert task_family("cars") == "multitask"
    assert task_family("dssm") == "ranker"
    assert get_model_class("hredqs") is HredQS
    # every model type of the JAX zoo is ported; unknown ones raise
    for name in ("bert", "ESM", "arc-i", "dssm2"):
        with pytest.raises(ValueError, match="unknown model_type"):
            get_model_class(name)
    with pytest.raises(ValueError, match="unknown"):
        task_family("bert")
    cfg = PortConfig(model_type="hredqs", vocab_size=20, emsize=8, nhid=4)
    assert isinstance(build_model(cfg, device="cpu"), HredQS)
    with pytest.raises(ValueError, match="rnn_type"):
        HredQS(cfg.replace(session_rnn_type="rnn"), device="cpu")
    with pytest.raises(ValueError, match="hredqs"):
        HredQS(cfg.replace(model_type="cars"), device="cpu")


# -- training ----------------------------------------------------------------


def test_loss_and_grads_match_jax(setup):
    """``make_loss_fn``'s recommender branch: the target NLL under
    ``target_mask & row_mask``, ``ppl``, and every parameter's gradient
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
    with pytest.raises(NotImplementedError, match="CARS"):
        make_score_step(pm, port_config(cfg))


def test_three_sgd_steps_match_jax(gru_setup):
    cfg, params, batch, _, _, _ = gru_setup
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


def test_checkpoint_round_trip_serves_the_trained_model(gru_setup, tmp_path):
    """Train two dropout steps, checkpoint, ``Engine.from_checkpoint``: the
    sidecar config names the model, and the loaded engine suggests what
    the in-memory one does."""
    cfg, params, batch, word_dict, sessions, _ = gru_setup
    pcfg = port_config(cfg.replace(dropout=0.3, dropout_emb=0.3,
                                   dropout_rnn=0.3))
    pwd = PortDictionary.from_json(word_dict.to_json())
    model = port_model(cfg, params)
    model.config = pcfg
    state = create_train_state(model, pcfg)
    step = make_train_step(model, pcfg)
    losses = []
    for _ in range(2):
        state, m = step(state, port_batch(batch), 7)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    ckpt = Checkpointer(tmp_path, "hredqs")
    ckpt.save_best(state, pcfg, pwd, {"step": state.step})
    ckpt.wait()
    cfg2, _, extra = Checkpointer.peek(ckpt.best_path)
    assert cfg2.model_type == "hredqs" and extra == {"step": 2}
    loaded = Engine.from_checkpoint(ckpt.best_path, beam_size=3,
                                    batch_bucket=BUCKET, device="cpu")
    in_memory = Engine(pcfg, pwd, model.state_dict(), beam_size=3,
                       batch_bucket=BUCKET, device="cpu")
    hists = _histories(sessions)
    assert loaded.suggest_batch(hists) == in_memory.suggest_batch(hists)
    other = create_train_state(build_model(pcfg, device="cpu", seed=9), pcfg)
    Checkpointer.load(ckpt.best_path, other)
    for n, p in state.params.items():
        assert torch.equal(p, other.params[n]), n
