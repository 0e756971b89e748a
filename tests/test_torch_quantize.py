"""The int8 embedding table in the port against the JAX package:
``quantize_embedding_table``, the quantized ``Embeddings`` (lookup and
tied ``attend``), the quantized parameter tree through the weight bridge,
and a quantized ``Engine`` (rank, beam-5 and greedy suggest, the
generator's int8 mode on the CPU) against a quantized JAX ``Engine``.

Tokens are compared exactly at f32, and n-best entries only where the JAX
score is a real hypothesis (above NEG_INF), as in tests/test_torch_serve.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cars import tiny_setup
from test_torch_serve import REAL, _texts

from context_attentive_ir_tpu.ops.layers import Embeddings as JaxEmbeddings
from context_attentive_ir_tpu.ops.layers import (
    quantize_embedding_table as jax_quantize,
)
from context_attentive_ir_tpu.serve import Engine as JaxEngine
from context_attentive_ir_tpu.serve import (
    quantize_embedding_params as jax_quantize_params,
)
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.data import Dictionary as PortDictionary
from context_attentive_ir_tpu_torch.decode import fused_generator_table
from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
from context_attentive_ir_tpu_torch.ops.layers import Embeddings
from context_attentive_ir_tpu_torch.ops.layers import (
    quantize_embedding_table,
)
from context_attentive_ir_tpu_torch.serve import Engine as PortEngine
from context_attentive_ir_tpu_torch.serve import quantize_embedding_params

BUCKET = 4
V, E = 61, 24


def _table(seed=0):
    """A random table with a zero row and entries on the .5 rounding
    boundary of their row's scale (half to even)."""
    t = np.random.RandomState(seed).normal(size=(V, E)).astype(np.float32)
    t[5] = 0.0
    t[7] = np.arange(E, dtype=np.float32) - 11.5   # max 12.5: scale 12.5/127
    return t


def test_quantize_table_bit_equal():
    t = _table()
    q, s = quantize_embedding_table(t)
    jq, js = jax_quantize(t)
    assert q.dtype == np.int8 and s.dtype == np.float32
    assert q.shape == (V, E) and s.shape == (V, 1)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_embeddings_match_jax(dtype):
    q, s = quantize_embedding_table(_table(1))
    rng = np.random.RandomState(2)
    ids = rng.randint(0, V, size=(3, 7))
    h = rng.normal(size=(5, E)).astype(np.float32)
    jemb = JaxEmbeddings(V, E, quantized=True, dtype=getattr(jnp, dtype))
    jp = {"params": {"embedding_q": jnp.asarray(q),
                     "embedding_scale": jnp.asarray(s)}}
    want_rows = jemb.apply(jp, jnp.asarray(ids))
    want_logits = jemb.apply(jp, jnp.asarray(h), method=JaxEmbeddings.attend)

    emb = Embeddings(V, E, dtype=getattr(torch, dtype), device="cpu",
                     quantized=True)
    assert emb.embedding_q.dtype == torch.int8
    assert not (emb.embedding_q.requires_grad
                or emb.embedding_scale.requires_grad)
    emb.load_state_dict({"embedding_q": torch.from_numpy(q),
                         "embedding_scale": torch.from_numpy(s)})
    rows = emb(torch.from_numpy(ids))
    logits = emb.attend(torch.from_numpy(h).to(emb.dtype))
    assert rows.dtype == logits.dtype == emb.dtype
    # lookup: one product per element in the compute dtype, as in JAX
    np.testing.assert_array_equal(rows.float().numpy(),
                                  np.asarray(want_rows, np.float32))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(logits.float().numpy(),
                               np.asarray(want_logits, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def quantized():
    _, cfg, params, _, word_dict, sessions = tiny_setup()
    qcfg = cfg.replace(quantize_embeddings=True)
    qparams = jax.device_get(jax_quantize_params(params))
    pcfg = PortConfig.from_json(qcfg.to_json())
    return (cfg, qcfg, params, qparams, pcfg,
            PortDictionary.from_json(word_dict.to_json()), word_dict,
            sessions)


def test_bridge_takes_the_quantized_tree(quantized):
    cfg, _, params, qparams, pcfg, *_ = quantized
    got = params_from_jax(qparams, pcfg)
    assert got["embeddings.embedding_q"].dtype == torch.int8
    assert "embeddings.embedding" not in got
    # the port's own transform of the float state dict gives the same
    float_sd = params_from_jax(params, PortConfig.from_json(cfg.to_json()))
    mine = quantize_embedding_params(float_sd)
    assert mine.keys() == got.keys()
    for k in got:
        assert torch.equal(mine[k], got[k]), k
    model = CARS(pcfg, device="cpu", seed=None)
    model.load_state_dict(got)
    table_t, scale = fused_generator_table(model)
    assert table_t.dtype == torch.int8 and table_t.shape == (
        pcfg.emsize, pcfg.vocab_size)
    np.testing.assert_array_equal(scale.numpy(),
                                  qparams["embeddings"]["embedding_scale"]
                                  .reshape(-1))


def test_bridge_refuses_mismatched_quantized_trees(quantized):
    cfg, _, params, qparams, pcfg, *_ = quantized
    with pytest.raises(ValueError, match="unknown"):
        params_from_jax(qparams, PortConfig.from_json(cfg.to_json()))
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(params, pcfg)
    bad = jax.tree_util.tree_map(np.array, qparams)
    bad["embeddings"]["embedding_q"] = bad["embeddings"][
        "embedding_q"].astype(np.float32)
    with pytest.raises(ValueError, match="int8"):
        params_from_jax(bad, pcfg)
    bad["embeddings"]["embedding_q"] = np.zeros((3, 3), np.int8)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, pcfg)


def test_quantized_engine_rank_matches_jax(quantized):
    _, qcfg, _, qparams, pcfg, pwd, wd, sessions = quantized
    reqs = _texts(sessions)
    ref = JaxEngine(qcfg, wd, qparams, batch_bucket=BUCKET).rank_batch(reqs)
    got = PortEngine(pcfg, pwd, params_from_jax(qparams, pcfg),
                     batch_bucket=BUCKET, device="cpu").rank_batch(reqs)
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(ref),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("beam_size", [5, 1])
def test_quantized_engine_suggest_matches_jax(quantized, beam_size):
    """The port decodes through the generator's int8 mode (plain version),
    the JAX engine through its quantized logits step."""
    _, qcfg, _, qparams, pcfg, pwd, wd, sessions = quantized
    hists = [list(h) + [q] for q, _, h in _texts(sessions)]
    ref = JaxEngine(qcfg, wd, qparams, beam_size=beam_size,
                    batch_bucket=BUCKET).suggest_batch(hists)
    got = PortEngine(pcfg, pwd, params_from_jax(qparams, pcfg),
                     beam_size=beam_size, batch_bucket=BUCKET,
                     device="cpu").suggest_batch(hists)
    n_real = 0
    for nb_p, nb_j in zip(got, ref):
        assert len(nb_p) == len(nb_j)
        for (tp, sp), (tj, sj) in zip(nb_p, nb_j):
            if sj > REAL:
                n_real += 1
                assert tp == tj
                assert abs(sp - sj) <= 1e-4
    assert n_real >= len(hists)


def test_from_checkpoint_quantizes(quantized, tmp_path):
    """``Engine.from_checkpoint(quantize_embeddings=True)`` serves the
    port's own quantization of the saved float table."""
    from context_attentive_ir_tpu_torch.train import (
        Checkpointer,
        create_train_state,
    )

    cfg, _, params, qparams, pcfg, pwd, *_ = quantized
    fcfg = PortConfig.from_json(cfg.to_json())
    model = CARS(fcfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(params, fcfg))
    ckpt = Checkpointer(str(tmp_path), "q")
    ckpt.save_latest(create_train_state(model, fcfg), fcfg, pwd, {})
    ckpt.wait()
    eng = PortEngine.from_checkpoint(ckpt.latest_path,
                                     quantize_embeddings=True, device="cpu")
    assert eng.config.quantize_embeddings
    sd = eng.model.state_dict()
    np.testing.assert_array_equal(sd["embeddings.embedding_q"].numpy(),
                                  qparams["embeddings"]["embedding_q"])
