"""Module-level parity at f32: the port's layers against their flax
counterparts with the same weights (max abs error 1e-5), the data layer
against the JAX vectorizer (bit-equal), and the weight bridge itself."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cars import DIMS

from context_attentive_ir_tpu.config import default_config
from context_attentive_ir_tpu.data import (
    ShapeConfig,
    build_dictionary,
    generate_sessions,
)
from context_attentive_ir_tpu.data import (
    build_session_batch as jax_build_session_batch,
)
from context_attentive_ir_tpu.data.objects import Session
from context_attentive_ir_tpu.models import build_model
from context_attentive_ir_tpu.ops import masking as jax_masking
from context_attentive_ir_tpu.ops.attention import (
    AttentionPool as JaxAttentionPool,
)
from context_attentive_ir_tpu.ops.decoder import (
    AttnLSTMDecoder as JaxDecoder,
)
from context_attentive_ir_tpu.ops.layers import Embeddings as JaxEmbeddings
from context_attentive_ir_tpu.ops.layers import MLP as JaxMLP
from context_attentive_ir_tpu_torch import data as port_data
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.convert import (
    load_jax_params,
    params_from_jax,
)
from context_attentive_ir_tpu_torch.models.multitask.cars import (
    CARS as PortCARS,
)
from context_attentive_ir_tpu_torch.ops.attention import AttentionPool
from context_attentive_ir_tpu_torch.ops.decoder import AttnLSTMDecoder
from context_attentive_ir_tpu_torch.ops.layers import MLP, Embeddings
from context_attentive_ir_tpu_torch.ops.masking import (
    NEG_INF,
    masked_softmax,
)

TOL = 1e-5
KEY = jax.random.key(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _t(v)
    return out


def _close(a, b, tol=TOL):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=0, atol=tol)


def _rng_mask(rng, shape, full_row=None, empty_row=None):
    m = rng.rand(*shape) > 0.3
    if full_row is not None:
        m[full_row] = True
    if empty_row is not None:
        m[empty_row] = False
    return m


def test_masked_softmax_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(4, 3, 9)).astype(np.float32) * 3
    m = _rng_mask(rng, (4, 3, 9), empty_row=(1, 2))
    ref = jax_masking.masked_softmax(jnp.asarray(x), jnp.asarray(m))
    got = masked_softmax(_t(x), _t(m))
    _close(got, ref)
    assert float(got[1, 2].abs().sum()) == 0.0
    assert NEG_INF == jax_masking.NEG_INF


def test_embeddings_lookup_and_attend_match_flax():
    rng = np.random.RandomState(1)
    V, E = 37, 12
    ids = rng.randint(0, V, size=(3, 5))
    h = rng.normal(size=(4, E)).astype(np.float32)
    flax_emb = JaxEmbeddings(V, E)
    params = flax_emb.init(KEY, jnp.asarray(ids))["params"]
    port = Embeddings(V, E, device="cpu")
    port.load_state_dict(_flat(params))
    _close(port(_t(ids)), flax_emb.apply({"params": params},
                                         jnp.asarray(ids)))
    _close(port.attend(_t(h)), flax_emb.apply(
        {"params": params}, jnp.asarray(h), method=JaxEmbeddings.attend))


@pytest.mark.parametrize("mode", ["query", "proj_only", "proj_states",
                                  "no_query"])
def test_attention_pool_matches_flax(mode):
    rng = np.random.RandomState(2)
    D = 10
    states = rng.normal(size=(2, 3, 6, D)).astype(np.float32)
    mask = _rng_mask(rng, (2, 3, 6), full_row=(0, 0), empty_row=(1, 2))
    query = rng.normal(size=(2, 3, D)).astype(np.float32)
    pool = JaxAttentionPool(D)
    q = None if mode == "no_query" else jnp.asarray(query)
    params = pool.init(KEY, jnp.asarray(states), jnp.asarray(mask),
                       q)["params"]
    port = AttentionPool(D, D, use_query=mode != "no_query", device="cpu")
    port.load_state_dict(_flat(params))
    var = {"params": params}
    s, m = jnp.asarray(states), jnp.asarray(mask)
    if mode == "proj_only":
        ref = pool.apply(var, s, proj_only=True)
        got = port(_t(states), proj_only=True)
    elif mode == "proj_states":
        proj = pool.apply(var, s, proj_only=True)
        ref = pool.apply(var, s, m, q, proj_states=proj)
        got = port(_t(states), _t(mask), _t(query),
                   proj_states=port(_t(states), proj_only=True))
    else:
        ref = pool.apply(var, s, m, q)
        got = port(_t(states), _t(mask),
                   None if q is None else _t(query))
    _close(got, ref)


def test_mlp_matches_flax():
    rng = np.random.RandomState(3)
    x = rng.normal(size=(2, 5, 9)).astype(np.float32)
    mlp = JaxMLP((7, 1), final_activation=False)
    params = mlp.init(KEY, jnp.asarray(x))["params"]
    port = MLP(9, (7, 1), final_activation=False, device="cpu")
    port.load_state_dict(_flat(params))
    _close(port(_t(x)), mlp.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("attn_type", ["general", "dot"])
def test_decoder_step_matches_flax(attn_type, num_layers):
    """``init_state`` then three ``step`` calls with input feeding."""
    rng = np.random.RandomState(4)
    B, H, E, L = 3, 8, 6, 5
    memory = rng.normal(size=(B, L, H)).astype(np.float32)
    mask = _rng_mask(rng, (B, L), full_row=0)
    mask[:, 0] = True
    init = rng.normal(size=(B, H)).astype(np.float32)
    embs = rng.normal(size=(3, B, E)).astype(np.float32)
    dec = JaxDecoder(features=H, embed_dim=E, num_layers=num_layers,
                     attn_type=attn_type)
    params = dec.init(KEY, jnp.asarray(embs.transpose(1, 0, 2)),
                      jnp.asarray(memory), jnp.asarray(mask),
                      jnp.asarray(init))["params"]
    var = {"params": params}
    port = AttnLSTMDecoder(H, E, num_layers, attn_type, device="cpu")
    port.load_state_dict(_flat(params))
    st_j = dec.apply(var, B, jnp.asarray(init), method=JaxDecoder.init_state)
    st_p = port.init_state(B, _t(init))
    for emb in embs:
        st_j, h_j, a_j = dec.apply(var, st_j, jnp.asarray(emb),
                                   jnp.asarray(memory), jnp.asarray(mask),
                                   method=JaxDecoder.step)
        st_p, h_p, a_p = port.step(st_p, _t(emb), _t(memory), _t(mask))
        _close(h_p, h_j)
        _close(a_p, a_j)
        for key in ("h", "c"):
            for x, y in zip(st_p[key], st_j[key]):
                _close(x, y)


# -- data layer --------------------------------------------------------------


def test_session_batch_equals_jax():
    sessions = [Session.from_dict(d) for d in generate_sessions(
        n_sessions=4, n_candidates=6, seed=1)]
    wd = build_dictionary([q.tokens for s in sessions for q in s.queries])
    shapes = ShapeConfig(5, 7, 3, 6)
    ref = jax_build_session_batch(sessions, wd, shapes, batch_size=6)
    pwd = port_data.Dictionary.from_json(wd.to_json())
    psess = [port_data.Session.from_dict(d) for d in generate_sessions(
        n_sessions=4, n_candidates=6, seed=1)]
    got = port_data.build_session_batch(psess, pwd, port_data.ShapeConfig(
        5, 7, 3, 6), batch_size=6)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), np.asarray(getattr(ref, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


# -- the weight bridge -------------------------------------------------------


@pytest.fixture(scope="module")
def small_cars():
    sessions = [Session.from_dict(d) for d in generate_sessions(
        n_sessions=2, n_candidates=4, seed=0)]
    wd = build_dictionary([q.tokens for s in sessions for q in s.queries])
    dims = dict(DIMS, emsize=8, nhid=4, nhid_ffnn=8, max_query_len=5,
                max_doc_len=6, max_session_len=2, num_candidates=4)
    cfg = default_config("cars").replace(vocab_size=len(wd), **dims)
    batch = jax_build_session_batch(sessions, wd, ShapeConfig(5, 6, 2, 4),
                                    batch_size=2)
    params = build_model(cfg).init({"params": KEY}, batch, True)["params"]
    return cfg, jax.device_get(params)


def test_bridge_maps_every_cars_leaf(small_cars):
    cfg, params = small_cars
    pcfg = PortConfig.from_json(cfg.to_json())
    sd = params_from_jax(params, pcfg)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    model = PortCARS(pcfg, device="cpu", seed=None)
    assert set(sd) == set(model.state_dict()) and len(sd) == n_leaves
    load_jax_params(model, params)
    for name, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), sd[name].numpy())
    # a representative leaf: the layout is kept, no transpose
    w = params["query_encoder"]["layer0"]["w_ih_fwd"]
    assert tuple(sd["query_encoder.layer0.w_ih_fwd"].shape) == w.shape == (
        cfg.emsize, 4 * cfg.nhid)


def test_bridge_rejects_unknown_missing_and_misshapen_leaves(small_cars):
    cfg, params = small_cars
    pcfg = PortConfig.from_json(cfg.to_json())
    extra = dict(params, mystery={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="mystery"):
        params_from_jax(extra, pcfg)
    missing = {k: v for k, v in params.items() if k != "mem_proj"}
    with pytest.raises(ValueError, match="mem_proj"):
        params_from_jax(missing, pcfg)
    bad = jax.tree_util.tree_map(np.array, params)
    bad["init_proj"]["kernel"] = bad["init_proj"]["kernel"].T
    with pytest.raises(ValueError, match="init_proj.kernel"):
        params_from_jax(bad, pcfg)
