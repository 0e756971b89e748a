"""Data parallelism of the port (``parallel/mesh.py``, the steps, the
``Trainer`` and the ``Engine`` under a mesh) against its own unsharded
path and the JAX package's 8-device mesh (the conftest forces 8 XLA CPU
devices, so the JAX ``make_mesh()`` spans 8).

The port's mesh here is ``make_mesh(["cpu"] * 8)``: eight replicas in one
process, each with its own copy of the weights, running the kernels' plain
versions.  Tolerances (f32, dropout 0): losses at rtol 2e-4, as the JAX
package's own DP test (tests/test_train.py); the port's 8 replicas
against its one replica also at 1e-5 relative for losses and grad norms;
Engine scores within 1e-5 and suggestion tokens exact.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch
from test_torch_serve import BUCKET, REAL, _texts, served  # noqa: F401

from context_attentive_ir_tpu.config import default_config
from context_attentive_ir_tpu.data import build_dictionary, generate_sessions
from context_attentive_ir_tpu.data.objects import Session
from context_attentive_ir_tpu.models import build_model
from context_attentive_ir_tpu.parallel.mesh import make_mesh as jax_make_mesh
from context_attentive_ir_tpu.parallel.mesh import replicated as jax_rep
from context_attentive_ir_tpu.parallel.mesh import shard_batch as jax_shard
from context_attentive_ir_tpu.serve import Engine as JaxEngine
from context_attentive_ir_tpu.train import create_train_state as jax_state
from context_attentive_ir_tpu.train import make_iterator as jax_iterator
from context_attentive_ir_tpu.train import make_train_step as jax_step
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.config import RunConfig
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.data import Dictionary as PortDictionary
from context_attentive_ir_tpu_torch.data import Session as PortSession
from context_attentive_ir_tpu_torch.models import build_model as port_build
from context_attentive_ir_tpu_torch.parallel import (
    gather,
    make_mesh,
    model_replicas,
    pad_to_multiple,
    reduce_grads,
    replicated,
    shard_batch,
    split_batch,
)
from context_attentive_ir_tpu_torch.serve import Engine as PortEngine
from context_attentive_ir_tpu_torch.serve import ServeError
from context_attentive_ir_tpu_torch.train import (
    Trainer,
    create_train_state,
    make_eval_loss_step,
    make_iterator,
    make_score_step,
    make_train_step,
)

DIMS = dict(emsize=16, nhid=8, nhid_ffnn=16, nfilters=8,
            max_query_len=6, max_doc_len=8, max_session_len=3,
            num_candidates=5, dropout=0.0, dropout_emb=0.0, dropout_rnn=0.0)
CPU8 = ["cpu"] * 8
# The ranking MLP's output bias: the listwise loss does not change when
# every score shifts by one constant, so its gradient is 0 up to rounding,
# which Adam scales to about +-lr per step (tests/test_torch_train_steps.py)
NOISE_ONLY = "rank_mlp.fc1.bias"


def _sessions(n, seed=11, cls=Session):
    sessions = [cls.from_dict(d) for d in generate_sessions(
        n_sessions=n, n_candidates=5, seed=seed)]
    for s in sessions:
        s.queries = s.queries[:3]
        for q in s.queries:
            q.tokens = q.tokens[:6]
            q.documents = q.documents[:5]
            for d in q.documents:
                d.tokens = d.tokens[:8]
    return sessions


@pytest.fixture(scope="module")
def data():
    sessions = _sessions(8)
    streams = [q.tokens for s in sessions for q in s.queries]
    streams += [d.tokens for s in sessions for q in s.queries
                for d in q.documents]
    return sessions, build_dictionary(streams)


def _port_batch(batch, cls):
    return cls(**{f.name: (None if getattr(batch, f.name) is None
                           else np.asarray(getattr(batch, f.name)))
                  for f in dataclasses.fields(cls)})


def _setup(model_type, sessions, word_dict, **kw):
    """(jax model, jax config, jax params, host batch, port config)."""
    cfg = default_config(model_type).replace(
        vocab_size=len(word_dict), learning_rate=1e-2, **{**DIMS, **kw})
    model = build_model(cfg)
    it = jax_iterator(sessions, cfg, word_dict, batch_size=8,
                      shuffle=False, seed=0)
    batch = next(iter(it.epoch(0)))
    state = jax_state(model, cfg, batch, jax.random.key(0))
    params = jax.device_get(state.params)
    return model, cfg, params, batch, PortConfig.from_json(cfg.to_json())


def _port_run(pcfg, params, batch, mesh, steps=3):
    """Losses and grad norms of ``steps`` port steps, and the eval-loss
    metrics after them."""
    from context_attentive_ir_tpu_torch.data.vectorize import (
        RankBatch,
        SessionBatch,
        SuggestBatch,
    )

    cls = {"RankBatch": RankBatch, "SessionBatch": SessionBatch,
           "SuggestBatch": SuggestBatch}[type(batch).__name__]
    host = _port_batch(batch, cls)
    model = port_build(pcfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(params, pcfg))
    state = create_train_state(model, pcfg)
    step = make_train_step(model, pcfg, mesh)
    size = 1 if mesh is None else mesh.size
    put = (lambda: host.to("cpu")) if size == 1 else (
        lambda: shard_batch(host, mesh))
    out = []
    for _ in range(steps):
        state, m = step(state, put(), 1)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    ev = make_eval_loss_step(model, pcfg, mesh)(put())
    return out, {k: float(v) for k, v in ev.items()}, model


def _jax_losses(model, cfg, params, batch):
    mesh = jax_make_mesh()
    state = jax_state(model, cfg, batch, jax.random.key(0))
    state = jax.device_put(state.replace(params=params), jax_rep(mesh))
    step = jax_step(model, cfg, mesh)
    losses = []
    for _ in range(3):
        state, m = step(state, jax_shard(batch, mesh), jax.random.key(1))
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("model_type", ["dssm", "cars", "hredqs"])
def test_eight_replicas_match_one_and_jax(model_type, data):
    """3 Adam steps on an 8-replica CPU mesh give the losses of the port's
    unsharded step and of the JAX 8-device mesh; the 8 replicas' losses and
    grad norms sit within 1e-5 relative of the one replica's."""
    sessions, word_dict = data
    model, cfg, params, batch, pcfg = _setup(model_type, sessions, word_dict)
    assert len(jax.devices()) >= 8
    one, ev1, _ = _port_run(pcfg, params, batch, None)
    eight, ev8, _ = _port_run(pcfg, params, batch, make_mesh(CPU8))
    np.testing.assert_allclose(np.asarray(eight), np.asarray(one),
                               rtol=1e-5)
    for k in ev1:
        assert ev8[k] == pytest.approx(ev1[k], rel=1e-5), k
    np.testing.assert_allclose([l for l, _ in eight],
                               _jax_losses(model, cfg, params, batch),
                               rtol=2e-4)


@pytest.mark.parametrize("model_type,loss_type",
                         [("cars", "listwise"), ("dssm", "pairwise"),
                          ("dssm", "pointwise"), ("hredqs", "listwise")])
def test_uneven_shards_match_the_whole_batch(model_type, loss_type):
    """A batch of 8 with 5 (CARS: sessions), 6 (DSSM: query rows) or 4
    (HRED-QS: next-query pairs) valid rows over 8 replicas: some shards
    hold no valid row, the others uneven tokens and clicks.  The sharded
    loss is the whole batch's (the JAX mesh's too), where the mean of the
    shards' own losses is not.  The L2 term (``regularize_coeff``) counts
    once."""
    sessions = _sessions({"cars": 5, "dssm": 2, "hredqs": 2}[model_type],
                         seed=3)
    streams = [q.tokens for s in sessions for q in s.queries]
    streams += [d.tokens for s in sessions for q in s.queries
                for d in q.documents]
    word_dict = build_dictionary(streams)
    model, cfg, params, batch, pcfg = _setup(model_type, sessions, word_dict,
                                             loss_type=loss_type,
                                             regularize_coeff=1e-2)
    assert not np.asarray(batch.row_mask).all()
    mesh = make_mesh(CPU8)
    one, _, _ = _port_run(pcfg, params, batch, None, steps=1)
    eight, _, pm = _port_run(pcfg, params, batch, mesh, steps=1)
    assert eight[0][0] == pytest.approx(one[0][0], rel=1e-5)
    assert eight[0][1] == pytest.approx(one[0][1], rel=1e-5)
    np.testing.assert_allclose(
        eight[0][0], _jax_losses(model, cfg, params, batch)[0], rtol=2e-4)
    # the naive mean of per-shard losses is off: the test has teeth
    fresh = port_build(pcfg, device="cpu", seed=None)
    fresh.load_state_dict(params_from_jax(params, pcfg))
    from context_attentive_ir_tpu_torch.train import make_loss_fn
    loss_fn = make_loss_fn(fresh, pcfg)
    with torch.no_grad():
        naive = np.mean([float(loss_fn(s, True)[0])
                         for s in shard_batch(_host(batch), mesh)])
    assert abs(naive - one[0][0]) > 1e-3 * abs(one[0][0])


def _host(batch):
    from context_attentive_ir_tpu_torch.data import vectorize
    return _port_batch(batch, getattr(vectorize, type(batch).__name__))


@pytest.mark.parametrize("model_type", ["cars", "dssm"])
def test_one_replica_mesh_is_bit_equal_to_no_mesh(model_type, data):
    sessions, word_dict = data
    _, _, params, batch, pcfg = _setup(model_type, sessions, word_dict,
                                       dropout=0.3, regularize_coeff=1e-3)
    a, ev_a, ma = _port_run(pcfg, params, batch, None)
    b, ev_b, mb = _port_run(pcfg, params, batch, make_mesh(["cpu"]))
    assert a == b and ev_a == ev_b
    for (n, p), q in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(p, q), n
    scores = [make_score_step(m, pcfg, mesh)(_host(batch).to("cpu"))
              for m, mesh in ((ma, None), (mb, make_mesh(["cpu"])))]
    assert torch.equal(*scores)


def test_mesh_helpers():
    mesh = make_mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.primary == torch.device("cpu")
    with pytest.raises(ValueError):
        make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()
    assert pad_to_multiple(9, 4) == 12 and pad_to_multiple(8, 4) == 8
    tree = {"a": torch.arange(6.0), "b": [torch.ones(2), None]}
    reps = replicated(tree, mesh)
    assert reps[0]["a"].data_ptr() == tree["a"].data_ptr()
    ptrs = {r["a"].data_ptr() for r in reps}
    assert len(ptrs) == 4 and all(r["b"][1] is None for r in reps)
    out = gather([torch.full((2,), float(r)) for r in range(4)], mesh)
    assert out.tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    grads = [{"w": torch.full((2,), float(r)), "f": None} for r in range(4)]
    red = reduce_grads(grads, mesh)
    assert red["w"].tolist() == [6.0, 6.0] and red["f"] is None


def test_shard_batch_and_replicas(data):
    sessions, word_dict = data
    pcfg = PortConfig.from_json(default_config("cars").replace(
        vocab_size=len(word_dict), **DIMS).to_json())
    pwd = PortDictionary.from_json(word_dict.to_json())
    psess = _sessions(8, cls=PortSession)
    batch = next(iter(make_iterator(psess, pcfg, pwd, 8, shuffle=False,
                                    seed=0).epoch(0)))
    mesh = make_mesh(["cpu"] * 4)
    shards = shard_batch(batch, mesh)
    assert len(shards) == 4
    for r, s in enumerate(shards):
        np.testing.assert_array_equal(s.query.numpy(),
                                      batch.query[2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="equal"):
        split_batch(batch, 3)
    model = port_build(pcfg, device="cpu", seed=0)
    reps = model_replicas(model, mesh)
    assert reps[0] is model and model_replicas(model, mesh) is reps
    for m in reps[1:]:
        for p, q in zip(m.parameters(), model.parameters()):
            assert torch.equal(p, q) and p.data_ptr() != q.data_ptr()


def test_trainer_mesh_batch_size_and_resume(data, tmp_path):
    """A batch size the mesh does not divide raises the JAX error; a
    Trainer on an 8-replica mesh trains, checkpoints the primary's state,
    and resumes (also into a Trainer without a mesh) at the next epoch with
    the same weights."""
    sessions, word_dict = data
    pcfg = PortConfig.from_json(default_config("cars").replace(
        vocab_size=len(word_dict), **DIMS).to_json())
    pwd = PortDictionary.from_json(word_dict.to_json())
    psess = _sessions(8, cls=PortSession)
    run = RunConfig(model_dir=str(tmp_path / "mesh"), model_name="m",
                    batch_size=8, test_batch_size=8, num_epochs=1,
                    display_iter=100, async_checkpoint=False, beam_size=2)
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        Trainer(pcfg, run, pwd, mesh=make_mesh(["cpu"] * 3))
    assert Trainer(pcfg, run, pwd, device="cpu").mesh.size == 1
    tr = Trainer(pcfg, run, pwd, mesh=make_mesh(CPU8))
    first = tr.fit(psess, psess)["history"]
    ref = Trainer(pcfg, dataclasses.replace(run, model_dir=str(
        tmp_path / "ref")), pwd, device="cpu", use_mesh=False)
    ref_hist = ref.fit(psess, psess)["history"]
    assert first[0]["train_loss"] == pytest.approx(
        ref_hist[0]["train_loss"], rel=1e-5)
    for k in ("map", "bleu-4"):
        assert first[0][k] == pytest.approx(ref_hist[0][k], abs=1e-6), k
    resumed = {}
    for name, kw in (("mesh", {"mesh": make_mesh(CPU8)}),
                     ("none", {"device": "cpu", "use_mesh": False})):
        shutil.copytree(tmp_path / "mesh", tmp_path / name / "run")
        tr2 = Trainer(pcfg, dataclasses.replace(
            run, model_dir=str(tmp_path / name / "run"), resume=True,
            num_epochs=2), pwd, **kw)
        hist = tr2.fit(psess, psess)["history"]
        assert [h["epoch"] for h in hist] == [1]
        resumed[name] = (hist[0]["train_loss"],
                         {n: p.detach().clone()
                          for n, p in tr2.model.named_parameters()})
    assert resumed["mesh"][0] == pytest.approx(resumed["none"][0], rel=1e-5)
    for n, p in resumed["mesh"][1].items():
        if n == NOISE_ONLY:
            continue
        torch.testing.assert_close(p, resumed["none"][1][n], rtol=0,
                                   atol=1e-5, msg=n)


def _engines(served, beam_size, **kw):  # noqa: F811
    cfg, wd, params, (pcfg, pwd, psd), sessions = served
    single = PortEngine(pcfg, pwd, psd, beam_size=beam_size,
                        batch_bucket=BUCKET, device="cpu", **kw)
    sharded = PortEngine(pcfg, pwd, psd, beam_size=beam_size,
                         batch_bucket=BUCKET, mesh=make_mesh(CPU8), **kw)
    jax_eng = JaxEngine(cfg, wd, params, beam_size=beam_size,
                        batch_bucket=BUCKET, mesh=jax_make_mesh(), **kw)
    return single, sharded, jax_eng, sessions


def _close(a, b, tol=1e-5):
    assert [len(x) for x in a] == [len(x) for x in b]
    np.testing.assert_allclose(np.concatenate(a), np.concatenate(b),
                               rtol=0, atol=tol)


def _same_suggestions(a, b):
    n_real = 0
    for nb_a, nb_b in zip(a, b):
        assert len(nb_a) == len(nb_b)
        for (ta, sa), (tb, sb) in zip(nb_a, nb_b):
            if sb > REAL:
                n_real += 1
                assert ta == tb
                assert abs(sa - sb) <= 1e-5
    assert n_real >= len(a)


def test_sharded_engine_ranks_as_single_and_jax(served):  # noqa: F811
    single, sharded, jax_eng, sessions = _engines(served, 2)
    assert sharded.batch_bucket == 8 and sharded.mesh.size == 8
    reqs = _texts(sessions)
    got = sharded.rank_batch(reqs)
    _close(got, single.rank_batch(reqs))
    _close(got, jax_eng.rank_batch(reqs))

    corpus = [" ".join(d.tokens) for s in sessions[:3] for q in s.queries
              for d in q.documents]
    idx = {e: e.index_documents(corpus) for e in (single, sharded)}
    assert len(idx[sharded]["replicas"]) == 8
    np.testing.assert_allclose(idx[sharded]["states"].numpy(),
                               idx[single]["states"].numpy(), atol=1e-5)
    jidx = jax_eng.index_documents(corpus)
    rng = np.random.RandomState(0)
    n = len(corpus)
    for clicks in (False, True):
        ireqs = [(q, [int(i) for i in rng.choice(n, 4, replace=False)],
                  [(h if isinstance(h, str) else h[0],
                    [int(rng.randint(n))]) if clicks else
                   (h if isinstance(h, str) else h[0]) for h in hist])
                 for q, _, hist in reqs]
        got = sharded.rank_indexed_batch(ireqs, idx[sharded])
        _close(got, single.rank_indexed_batch(ireqs, idx[single]))
        _close(got, jax_eng.rank_indexed_batch(ireqs, jidx))
    # an index built without the mesh has no replicas to shard over
    with pytest.raises(ServeError, match="mesh"):
        sharded.rank_indexed_batch(ireqs, idx[single])


@pytest.mark.parametrize("beam_size,shortlist", [(3, 0), (1, 0), (3, 16)])
def test_sharded_engine_suggests_as_single_and_jax(served, beam_size,  # noqa: F811
                                                   shortlist):
    single, sharded, jax_eng, sessions = _engines(
        served, beam_size, suggest_shortlist=shortlist)
    reqs = _texts(sessions)
    hists = [list(h) + [q] for q, _, h in reqs]
    got = sharded.suggest_batch(hists)
    _same_suggestions(got, single.suggest_batch(hists))
    _same_suggestions(got, jax_eng.suggest_batch(hists))
