"""M-NSRF in the port against the JAX package at f32: ``masked_max`` and
its gradient over tied maxima, ``inclusive_causal_mask``, the parameter
tree (LSTM and GRU, one or two layers, bi- or unidirectional, tied and
untied), the model (slate scores and teacher-forced logits, ``decode_init``,
``decode_step``), the multitask loss and every gradient through
``make_loss_fn``, three SGD steps, the ``Engine``'s ``rank_batch`` scores
and beam-5 and greedy suggestions (also for histories past
``suggest_max_clicks``, which M-NSRF decodes through ``decode_init`` as JAX
does, while CARS takes ``decode_init_full``), and ``cli.main`` train ->
test.  The checks are functions of a setup, so that
``tests/test_torch_m_match_tensor.py`` runs them on M-MatchTensor.

Both packages get the same weights through ``convert.params_from_jax``;
the port runs on the CPU, where its LSTM and GRU kernels take their plain
versions.  Tolerances: scores at valid (turn, candidate) positions, logits,
states and losses 1e-5 abs (values of order 1; f32 sums in another order),
scores at padded positions only finite (a padded turn or document pools to
NEG_INF, as in JAX); gradients 2e-5 of the largest JAX gradient in the
leaf plus 1e-7; parameters after three SGD steps 2e-6 abs; suggestion
tokens exact and their scores 1e-4 abs where the JAX score is a real
hypothesis (above NEG_INF); ``rank_batch`` scores 1e-5 abs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.config import default_config
from context_attentive_ir_tpu.constants import BOS, EOS
from context_attentive_ir_tpu.data import (
    ShapeConfig,
    build_dictionary,
    build_session_batch,
    generate_sessions,
)
from context_attentive_ir_tpu.data.objects import Session
from context_attentive_ir_tpu.models import build_model as jax_build_model
from context_attentive_ir_tpu.models.multitask.mnsrf import (
    inclusive_causal_mask as jax_causal_mask,
)
from context_attentive_ir_tpu.ops.masking import masked_max as jax_masked_max
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
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.data import Dictionary as PortDictionary
from context_attentive_ir_tpu_torch.data import SessionBatch as PortBatch
from context_attentive_ir_tpu_torch.data import write_fixture
from context_attentive_ir_tpu_torch.decode import can_fuse_generator
from context_attentive_ir_tpu_torch.models import (
    build_model,
    get_model_class,
    task_family,
)
from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
from context_attentive_ir_tpu_torch.models.multitask.mnsrf import (
    MNSRF,
    inclusive_causal_mask,
)
from context_attentive_ir_tpu_torch.ops.masking import NEG_INF, masked_max
from context_attentive_ir_tpu_torch.serve import Engine, ServeError
from context_attentive_ir_tpu_torch.train import (
    create_train_state,
    make_eval_loss_step,
    make_loss_fn,
    make_score_step,
    make_train_step,
)

DIMS = dict(emsize=16, nhid=8, nhid_ffnn=16, nfilters=4, max_query_len=5,
            max_doc_len=7, max_session_len=3, num_candidates=4,
            suggest_max_clicks=2, dropout=0.0, dropout_emb=0.0,
            dropout_rnn=0.0)
BUCKET = 4
REAL = -1e8   # n-best scores below this are NEG_INF garbage beams
TOL = 1e-5
REL = 2e-5
# (rnn_type, tie_embeddings, nlayers, bidirection) of the model checks
VARIANTS = [("lstm", True, 1, True), ("gru", False, 2, False)]


def variant_id(v):
    return f"{v[0]}-tie={v[1]}-layers={v[2]}-bi={v[3]}"


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


@dataclasses.dataclass
class Setup:
    cfg: object           # the JAX config
    params: dict          # the JAX param tree (numpy)
    batch: object         # a JAX SessionBatch with padded turns, docs, rows
    word_dict: object
    sessions: list


def mt_setup(model_type, rnn_type="lstm", tie=True, nlayers=1,
             bidirection=True, seed=0):
    """A tiny f32 multitask model of ``model_type`` and a batch with padded
    turns, padded candidates and one padded row; one turn clicks more
    candidates than ``suggest_max_clicks``.  The encoders' biases are
    random, the generator's BOS logit is scaled down (else a random decoder
    repeats BOS) and its EOS logit gets a small bias."""
    sessions = [Session.from_dict(d) for d in generate_sessions(
        n_sessions=5, min_turns=1, max_turns=4, n_candidates=6, seed=seed)]
    for d in sessions[0].queries[0].documents[:6]:
        d.label = 1
    streams = [q.tokens for s in sessions for q in s.queries]
    streams += [d.tokens for s in sessions for q in s.queries
                for d in q.documents]
    word_dict = build_dictionary(streams)
    cfg = default_config(model_type).replace(
        vocab_size=len(word_dict), rnn_type=rnn_type,
        session_rnn_type=rnn_type, tie_embeddings=tie, nlayers=nlayers,
        bidirection=bidirection, **DIMS)
    shapes = ShapeConfig(cfg.max_query_len, cfg.max_doc_len,
                         cfg.max_session_len, cfg.num_candidates)
    batch = build_session_batch(sessions, word_dict, shapes,
                                batch_size=len(sessions) + 1)
    model = jax_build_model(cfg)
    params = jax.device_get(model.init({"params": jax.random.key(seed)},
                                       batch, True)["params"])
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.RandomState(seed)
    for enc in ("query_encoder", "doc_encoder", "session_rnn"):
        for name, v in _flat(params[enc]).items():
            if name.rsplit(".", 1)[-1].startswith("b_"):
                v[...] = rng.normal(size=v.shape) * 0.2
    if tie:
        table = params["embeddings"]["embedding"]
        table[BOS] *= 0.3
        params["generator"]["tie_proj"]["bias"] = (
            0.05 * table[EOS] / (table[EOS] @ table[EOS]))
    else:
        params["generator"]["proj"]["kernel"][:, BOS] *= 0.3
    return Setup(cfg, params, batch, word_dict, sessions)


def port_config(cfg):
    return PortConfig.from_json(cfg.to_json())


def port_model(cfg, params):
    pcfg = port_config(cfg)
    model = build_model(pcfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(params, pcfg))
    return model


def port_batch(batch):
    return PortBatch(**{f.name: np.asarray(getattr(batch, f.name))
                        for f in dataclasses.fields(PortBatch)}).to("cpu")


def valid_slots(batch):
    """[B, S, N] bool: real candidates of real turns of real rows."""
    return (np.asarray(batch.cand_mask)
            & np.asarray(batch.turn_mask)[..., None]
            & np.asarray(batch.row_mask)[:, None, None])


# -- checks shared with M-MatchTensor -----------------------------------------


def check_param_tree(st):
    """The port's parameters are exactly the JAX tree's leaves with their
    shapes (``generator.proj`` untied, ``generator.tie_proj`` tied)."""
    flat = _flat(st.params)
    pm = port_model(st.cfg, st.params)
    assert {n: tuple(p.shape) for n, p in pm.named_parameters()} == {
        n: v.shape for n, v in flat.items()}
    gen = {n.split(".")[1] for n in flat if n.startswith("generator.")}
    assert gen == ({"tie_proj"} if st.cfg.tie_embeddings else {"proj"})
    assert not can_fuse_generator(pm)
    for absent in ("decode_step_fused", "encode_docs", "decode_init_full"):
        assert not hasattr(pm, absent)


def check_forward(st):
    """Slate scores (tight at valid positions, finite at padded ones) and
    the teacher-forced logits against ``model.apply``; ``score`` and
    ``make_score_step`` equal the forward's scores."""
    jm = jax_build_model(st.cfg)
    ref = jm.apply({"params": st.params}, st.batch, True)
    pm = port_model(st.cfg, st.params)
    got = pm(port_batch(st.batch))
    valid = valid_slots(st.batch)
    assert not valid.all() and valid.any()
    assert got["scores"].shape == ref["scores"].shape
    assert torch.isfinite(got["scores"]).all()
    _close(_np(got["scores"])[valid], np.asarray(ref["scores"])[valid])
    assert got["gen_logits"].shape == ref["gen_logits"].shape
    _close(got["gen_logits"], ref["gen_logits"])
    scored = make_score_step(pm, port_config(st.cfg))(port_batch(st.batch))
    _close(_np(scored)[valid], _np(got["scores"])[valid], 0.0)


def check_loss_and_grads(st):
    """``make_loss_fn``'s multitask branch (rank loss + alpha * NLL) and
    every parameter's gradient against ``jax.value_and_grad``."""
    jm = jax_build_model(st.cfg)
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(
        jax_loss_fn(jm, st.cfg), has_aux=True), static_argnums=3)(
        st.params, st.batch, jax.random.key(0), True)
    pm = port_model(st.cfg, st.params)
    pcfg = port_config(st.cfg)
    loss, met = make_loss_fn(pm, pcfg)(port_batch(st.batch),
                                       deterministic=True)
    loss.backward()
    assert set(met) == set(met_j) == {"loss", "rank_loss", "gen_loss"}
    for k in met:
        _close(met[k], met_j[k], tol=TOL * max(1.0, abs(float(met_j[k]))))
    flat_g = _flat(jax.device_get(grads_j))
    assert set(flat_g) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        _close_grad(p.grad, flat_g[name])
    with torch.no_grad():
        ev = make_eval_loss_step(pm, pcfg)(port_batch(st.batch))
    _close(ev["loss"], loss_j, tol=TOL * max(1.0, abs(float(loss_j))))


def check_three_sgd_steps(st):
    cfg = st.cfg.replace(optimizer="sgd", learning_rate=0.5, momentum=0.9)
    jm = jax_build_model(cfg)
    jstate = JaxTrainState.create(apply_fn=jm.apply, params=st.params,
                                  tx=jax_make_optimizer(cfg))
    jstep = jax_make_train_step(jm, cfg)
    pm = port_model(cfg, st.params)
    pstate = create_train_state(pm, port_config(cfg))
    pstep = make_train_step(pm, port_config(cfg))
    pb = port_batch(st.batch)
    for i in range(3):
        jstate, mj = jstep(jstate, st.batch, jax.random.key(1))
        pstate, mp = pstep(pstate, pb, 1)
        for k in ("loss", "rank_loss", "gen_loss", "grad_norm"):
            rel = abs(float(mp[k]) - float(mj[k])) / abs(float(mj[k]))
            assert rel <= 1e-5, (i, k, float(mp[k]), float(mj[k]))
    flat_j = _flat(jax.device_get(jstate.params))
    for n, p in pm.named_parameters():
        err = float(np.max(np.abs(p.detach().numpy() - flat_j[n])))
        assert err <= 2e-6, (n, err)


def check_decode(st):
    """``decode_init`` (memory ``[B*S, S, H2]``, its inclusive causal mask,
    the init state) and three decode steps on random tokens."""
    jm = jax_build_model(st.cfg)
    var = {"params": st.params}
    st_j, mem_j, mask_j = jm.apply(var, st.batch, method=jm.decode_init)
    pm = port_model(st.cfg, st.params)
    st_p, mem_p, mask_p = pm.decode_init(port_batch(st.batch))
    B, S = st.batch.query.shape[:2]
    assert mem_p.shape[:2] == (B * S, S)
    _close(mem_p, mem_j)
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_j))
    for key in ("h", "c"):
        for a, b in zip(st_p[key], st_j[key]):
            _close(a, b)
    rng = np.random.RandomState(3)
    for _ in range(3):
        toks = rng.randint(0, st.cfg.vocab_size, size=mem_p.shape[0])
        st_j, logits_j, align_j = jm.apply(var, st_j, jnp.asarray(toks),
                                           mem_j, mask_j,
                                           method=jm.decode_step)
        st_p, logits_p, align_p = pm.decode_step(
            st_p, torch.from_numpy(toks), mem_p, mask_p)
        _close(logits_p, logits_j)
        _close(align_p, align_j)


def _requests(sessions):
    """Five ranking requests (past one bucket edge) with click history,
    with history but no clicks, and with no history."""
    join = " ".join
    out = []
    for s in sessions:
        *hist, cur = s.queries
        history = [(join(q.tokens), [join(d.tokens) for d in q.documents
                                     if d.label]) for q in hist]
        out.append((join(cur.tokens), [join(d.tokens) for d in
                                       cur.documents][:DIMS["num_candidates"]],
                    history))
    out[1] = (out[1][0], out[1][1], [h[0] for h in out[1][2]])
    out[2] = (out[2][0], out[2][1][:3], ())
    return out


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


def check_engine(st, beam_size):
    """The port's ``Engine`` against the JAX one: ``rank_batch`` scores,
    and beam / greedy suggestions for histories within the click cap and
    past it (one turn with 4 clicked documents, cap 2); the cached-document
    calls raise ``ServeError``."""
    pcfg = port_config(st.cfg)
    jax_eng = JaxEngine(st.cfg, st.word_dict, st.params, beam_size=beam_size,
                        batch_bucket=BUCKET)
    port_eng = Engine(pcfg, PortDictionary.from_json(st.word_dict.to_json()),
                      params_from_jax(st.params, pcfg), beam_size=beam_size,
                      batch_bucket=BUCKET, device="cpu")
    assert port_eng.family == "multitask"
    reqs = _requests(st.sessions)
    if beam_size > 1:
        ref = jax_eng.rank_batch(reqs)
        got = port_eng.rank_batch(reqs)
        assert [len(r) for r in got] == [len(r) for r in ref]
        np.testing.assert_allclose(np.concatenate(got), np.concatenate(ref),
                                   rtol=0, atol=1e-5)
    fast = [list(h) + [q] for q, _, h in reqs]
    heavy = [[(q, docs)] + [q] for q, docs, _ in reqs[:3]]
    assert len(heavy[0][0][1]) > st.cfg.suggest_max_clicks
    n_real, words = 0, 0
    for hists in (fast, heavy):
        n, w = _compare(port_eng.suggest_batch(hists),
                        jax_eng.suggest_batch(hists))
        n_real, words = n_real + n, words + w
    assert n_real >= len(fast) and words > 0
    with pytest.raises(ServeError, match="cached-doc"):
        port_eng.index_documents(["a doc"])
    with pytest.raises(ServeError, match="cached-doc"):
        port_eng.rank_indexed_batch([("a query", [0], ())],
                                    {"states": torch.zeros(1, 2, 8)})


def check_main(tmp_path, model_type):
    """``cli.main`` trains the model (greedy validation on MAP), the train
    loss falls, the metric table has ranking and BLEU columns, both dumps
    are written, and ``--only_test`` reproduces the test metrics."""
    train = write_fixture(tmp_path / "train.jsonl", n_sessions=10,
                          n_candidates=4, seed=0)
    dev = write_fixture(tmp_path / "dev.jsonl", n_sessions=4,
                        n_candidates=4, seed=1)
    common = ["--model_type", model_type, "--test_file", str(dev),
              "--model_dir", str(tmp_path / "runs"), "--model_name", "m",
              "--emsize", "16", "--nhid", "8", "--nhid_ffnn", "16",
              "--nfilters", "4", "--max_query_len", "5", "--max_doc_len",
              "7", "--max_session_len", "3", "--num_candidates", "4",
              "--test_batch_size", "8", "--beam_size", "1", "--device",
              "cpu"]
    results = main([*common, "--train_file", str(train), "--dev_file",
                    str(dev), "--num_epochs", "2", "--batch_size", "4",
                    "--learning_rate", "0.01", "--valid_metric", "map",
                    "--no-pack_cache", "--prefetch_batches", "0"])
    hist = results["fit"]["history"]
    assert [h["epoch"] for h in hist] == [0, 1]
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    for cols in (hist[-1], results["test"]):
        assert {"map", "mrr", "bleu-1", "rouge-l"} <= set(cols)
    runs = tmp_path / "runs"
    assert (runs / "m.test.hyps.jsonl").read_text().strip()
    assert (runs / "m.test.ranks.jsonl").read_text().strip()
    retest = main([*common, "--only_test"])
    assert retest["test"] == results["test"]


# -- ops ----------------------------------------------------------------------


def test_masked_max_matches_jax_with_tied_gradients():
    """Values (a fully masked row reads NEG_INF in every feature) and the
    gradient, which both split evenly over tied maxima."""
    rng = np.random.RandomState(0)
    x = rng.randint(-2, 3, size=(3, 4, 5, 6)).astype(np.float32)
    mask = rng.rand(3, 4, 5) < 0.7
    mask[1, 2] = False
    w = rng.normal(size=(3, 4, 6)).astype(np.float32)

    def f(xx):
        return jnp.sum(jnp.where(mask[..., None], 1.0, 0.0).max(-2)
                       * jax_masked_max(xx, jnp.asarray(mask)) * w)

    val_j, grad_j = jax.value_and_grad(f)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = masked_max(xt, torch.from_numpy(mask), dim=-2)
    assert torch.equal(out[1, 2], torch.full((6,), NEG_INF))
    np.testing.assert_array_equal(
        _np(out), np.asarray(jax_masked_max(jnp.asarray(x),
                                            jnp.asarray(mask))))
    val = ((torch.from_numpy(mask).float().amax(-1, keepdim=True) * out)
           * torch.from_numpy(w)).sum()
    val.backward()
    _close(val, val_j)
    # the inputs hold tied maxima at valid positions
    live = np.where(mask[..., None], x, -np.inf)
    ties = (live == live.max(-2, keepdims=True)).sum(-2)
    assert (ties[mask.any(-1)] > 1).any()
    _close(xt.grad, grad_j, 1e-6)


def test_inclusive_causal_mask_matches_jax():
    tm = np.array([[True, True, False], [True, False, False],
                   [False, False, False]])
    np.testing.assert_array_equal(
        inclusive_causal_mask(torch.from_numpy(tm)).numpy(),
        np.asarray(jax_causal_mask(jnp.asarray(tm))))


# -- the model ---------------------------------------------------------------


@pytest.fixture(scope="module", params=VARIANTS, ids=variant_id)
def setup(request):
    return mt_setup("mnsrf", *request.param)


def test_param_tree_matches_jax(setup):
    check_param_tree(setup)


@pytest.mark.parametrize("variant", [("lstm", False, 2, True),
                                     ("gru", True, 1, False)],
                         ids=variant_id)
def test_param_tree_of_other_variants_matches_jax(variant):
    check_param_tree(mt_setup("mnsrf", *variant))


def test_forward_matches_jax(setup):
    check_forward(setup)


def test_loss_and_grads_match_jax(setup):
    check_loss_and_grads(setup)


def test_three_sgd_steps_match_jax(setup):
    check_three_sgd_steps(setup)


def test_decode_init_and_steps_match_jax(setup):
    check_decode(setup)


@pytest.fixture(scope="module")
def engine_setup():
    return mt_setup("mnsrf", "lstm", True, seed=1)


@pytest.mark.parametrize("beam_size", [5, 1])
def test_engine_matches_jax(engine_setup, beam_size):
    check_engine(engine_setup, beam_size)


def test_full_init_only_where_the_model_has_it(monkeypatch):
    """Past ``suggest_max_clicks`` the ``Engine`` takes CARS's
    ``decode_init_full`` and M-NSRF's ``decode_init`` (it has no other),
    as the JAX engine does; neither raises."""
    from context_attentive_ir_tpu_torch.config import default_config as pdc

    wd = PortDictionary()
    for w in "a b c d e f g h".split():
        wd.add(w)
    dims = dict(vocab_size=len(wd), emsize=8, nhid=4, nhid_ffnn=8,
                nfilters=4, max_query_len=4, max_doc_len=4,
                max_session_len=3, num_candidates=8)
    heavy = [[("a b", ["c d"] * 6), "e f"]]
    calls = []
    for model_type, cls in (("cars", CARS), ("mnsrf", MNSRF)):
        cfg = pdc(model_type, **dims)
        model = build_model(cfg, device="cpu", seed=0)
        for name in ("decode_init", "decode_init_full"):
            if hasattr(cls, name):
                fn = getattr(cls, name)
                monkeypatch.setattr(cls, name, lambda self, b, _f=fn, _n=name:
                                    calls.append(_n) or _f(self, b))
        eng = Engine(cfg, wd, model.state_dict(), beam_size=2,
                     batch_bucket=1, device="cpu")
        out = eng.suggest_batch(heavy)
        assert len(out) == 1 and len(out[0]) == 2
    assert calls == ["decode_init_full", "decode_init"]


def test_model_registry():
    assert task_family("mnsrf") == "multitask"
    assert get_model_class("mnsrf") is MNSRF
    cfg = PortConfig(model_type="mnsrf", vocab_size=20, emsize=8, nhid=4)
    assert isinstance(build_model(cfg, device="cpu"), MNSRF)
    with pytest.raises(ValueError, match="mnsrf"):
        MNSRF(cfg.replace(model_type="cars"), device="cpu")
    with pytest.raises(ValueError, match="rnn_type"):
        MNSRF(cfg.replace(session_rnn_type="rnn"), device="cpu")


def test_main_end_to_end(tmp_path):
    check_main(tmp_path, "mnsrf")
