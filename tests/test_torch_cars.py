"""Whole-model parity at f32: the JAX CARS and the PyTorch port
(``context_attentive_ir_tpu_torch``) with the same weights, through the
bridge (``convert.params_from_jax``), on the same batch.

The port runs on the CPU, where its fused kernels take their plain
versions.  ``tiny_setup`` is shared with the other port test files.
"""

import dataclasses

import jax
import numpy as np
import pytest

from context_attentive_ir_tpu.config import default_config
from context_attentive_ir_tpu.data import (
    ShapeConfig,
    build_dictionary,
    build_session_batch,
    generate_sessions,
)
from context_attentive_ir_tpu.data.objects import Session
from context_attentive_ir_tpu.models import build_model
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.data.vectorize import (
    SessionBatch as PortBatch,
)
from context_attentive_ir_tpu_torch.models.multitask.cars import (
    CARS as PortCARS,
)
from context_attentive_ir_tpu_torch.models.multitask.cars import (
    clicks_exceed_suggest_cap,
)

DIMS = dict(emsize=32, nhid=16, nhid_ffnn=32, max_query_len=8,
            max_doc_len=12, max_session_len=3, num_candidates=8,
            dropout=0.0, dropout_emb=0.0, dropout_rnn=0.0)
ABLATIONS = ("none", "no_click_flow", "no_context_attn")
# leaves a flax CARS never creates under each ablation (unused submodules)
ABLATED = {"none": (), "no_click_flow": ("click_flow",),
           "no_context_attn": ("ctx_wq", "ctx_wm", "ctx_v", "ctx_gate")}


def tiny_setup(n_sessions=6, seed=0, **overrides):
    """(jax model, config, params, batch, word_dict, sessions) of a tiny
    f32 CARS; one turn clicks more candidates than ``suggest_max_clicks``.
    ``overrides`` replace config fields (e.g. ``rnn_type="gru"``)."""
    sessions = [Session.from_dict(d) for d in generate_sessions(
        n_sessions=n_sessions, n_candidates=8, seed=seed)]
    for d in sessions[0].queries[0].documents[:6]:
        d.label = 1
    streams = [q.tokens for s in sessions for q in s.queries]
    streams += [d.tokens for s in sessions for q in s.queries
                for d in q.documents]
    word_dict = build_dictionary(streams)
    cfg = default_config("cars").replace(vocab_size=len(word_dict),
                                        **{**DIMS, **overrides})
    shapes = ShapeConfig(cfg.max_query_len, cfg.max_doc_len,
                         cfg.max_session_len, cfg.num_candidates)
    batch = build_session_batch(sessions, word_dict, shapes,
                                batch_size=n_sessions)
    model = build_model(cfg)
    params = jax.device_get(model.init({"params": jax.random.key(seed)},
                                       batch, True)["params"])
    return model, cfg, params, batch, word_dict, sessions


def ablated(cfg, params, ablation):
    """The config and param tree of an ablation (its unused leaves
    dropped, as a flax init under that ablation leaves them out)."""
    return (cfg.replace(cars_ablation=ablation),
            {k: v for k, v in params.items() if k not in ABLATED[ablation]})


def port_model(cfg, params):
    pcfg = PortConfig.from_json(cfg.to_json())
    model = PortCARS(pcfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(params, pcfg))
    return model


def port_batch(batch):
    return PortBatch(**{f.name: np.asarray(getattr(batch, f.name))
                        for f in dataclasses.fields(PortBatch)}).to("cpu")


@pytest.fixture(scope="module")
def setup():
    return tiny_setup()


def _both(setup, ablation):
    _, cfg, params, batch, _, _ = setup
    cfg, params = ablated(cfg, params, ablation)
    return build_model(cfg), params, port_model(cfg, params), batch


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("ablation", ABLATIONS)
def test_score_matches_jax(setup, ablation):
    jm, params, pm, batch = _both(setup, ablation)
    ref = jm.apply({"params": params}, batch, method=jm.score)
    got = pm.score(port_batch(batch))
    assert got.shape == ref.shape
    _close(got, ref, 1e-4)


@pytest.mark.parametrize("ablation", ABLATIONS)
@pytest.mark.parametrize("method", ["decode_init", "decode_init_full"])
def test_decode_init_matches_jax(setup, ablation, method):
    jm, params, pm, batch = _both(setup, ablation)
    st_j, mem_j, mask_j = jm.apply({"params": params}, batch,
                                   method=getattr(jm, method))
    st_p, mem_p, mask_p = getattr(pm, method)(port_batch(batch))
    _close(mem_p, mem_j, 1e-5)
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_j))
    for key in ("h", "c"):
        for a, b in zip(st_p[key], st_j[key]):
            _close(a, b, 1e-5)
    _close(st_p["input_feed"], st_j["input_feed"], 1e-5)


@pytest.mark.parametrize("ablation", ABLATIONS)
def test_decode_steps_match_jax(setup, ablation):
    """Two decode steps: logits of ``decode_step`` and the tied projection
    of ``decode_step_fused``, fed the same tokens."""
    jm, params, pm, batch = _both(setup, ablation)
    var = {"params": params}
    st_j, mem_j, mask_j = jm.apply(var, batch, method=jm.decode_init)
    st_p, mem_p, mask_p = pm.decode_init(port_batch(batch))
    rng = np.random.RandomState(3)
    for _ in range(2):
        toks = rng.randint(0, jm.config.vocab_size, size=mem_p.shape[0])
        _, proj_j, _ = jm.apply(var, st_j, jax.numpy.asarray(toks), mem_j,
                                mask_j, method=jm.decode_step_fused)
        st_j, logits_j, align_j = jm.apply(var, st_j,
                                           jax.numpy.asarray(toks), mem_j,
                                           mask_j, method=jm.decode_step)
        t = port_batch(batch).query.new_tensor(toks)
        _, proj_p, _ = pm.decode_step_fused(st_p, t, mem_p, mask_p)
        st_p, logits_p, align_p = pm.decode_step(st_p, t, mem_p, mask_p)
        _close(proj_p, proj_j, 1e-5)
        _close(logits_p, logits_j, 1e-5)
        _close(align_p, align_j, 1e-5)


def test_click_cap_boundary(setup):
    """The batch has a turn past ``suggest_max_clicks``: the guard flags
    it, the fast init drops clicks there, and the port's full init still
    matches the JAX full init on that row."""
    jm, params, pm, batch = _both(setup, "none")
    assert clicks_exceed_suggest_cap(batch, jm.config.suggest_max_clicks)
    pb = port_batch(batch)
    assert not clicks_exceed_suggest_cap(
        dataclasses.replace(pb, clicks=pb.clicks * 0),
        jm.config.suggest_max_clicks)
    fast = pm.decode_init(pb)[0]["h"][0]
    full = pm.decode_init_full(pb)[0]["h"][0]
    assert not np.allclose(fast[0].numpy(), full[0].numpy())
    ref = jm.apply({"params": params}, batch,
                   method=jm.decode_init_full)[0]["h"][0]
    _close(full, ref, 1e-5)
