"""Repaired faults of the port, and the untied generator, on the CPU.

- The slate pool's gate states what its launcher runs (``pool_supported``:
  H a multiple of 128 from 128 to 1024, at least 8 rows), and
  ``AttentionPool`` routes a width the JAX gate takes but the launcher
  does not (H = 1152) to the plain formulation on CPU tensors.
- An ``Engine`` decodes at any beam up to V: past the fused generator
  kernels' top-kc (``MAX_KC`` = 32, kc = beam + 1) ``make_fused_beam_step``
  returns None and CARS decodes through its logits step, as the JAX engine
  does; a CARS ``Engine`` at beams 32 and 40 gives the JAX ``Engine``'s
  tokens.  The plain generator top-k takes any kc up to V.
- The untied generator (``tie_embeddings=False``, a ``Dense(H2, V)`` named
  ``proj``) in CARS and HRED-QS: forward and loss against the JAX package,
  and no fused step.

Tolerances as in ``tests/test_torch_hredqs.py`` and
``tests/test_torch_serve.py``: scores, logits and losses 1e-5 abs (1e-4 for
CARS's slate scores), decoded tokens exact and n-best scores 1e-4 abs,
compared only where the JAX score is a real hypothesis (above NEG_INF).
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_cars import port_batch as cars_batch
from test_torch_cars import port_model as cars_model
from test_torch_cars import tiny_setup
from test_torch_hredqs import _close, hred_setup, port_batch
from test_torch_hredqs import port_model as hred_model
from test_torch_serve import REAL, _texts

from context_attentive_ir_tpu.constants import EOS
from context_attentive_ir_tpu.models import build_model as jax_build_model
from context_attentive_ir_tpu.serve import Engine as JaxEngine
from context_attentive_ir_tpu.train.steps import make_loss_fn as jax_loss_fn
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.data import Dictionary as PortDictionary
from context_attentive_ir_tpu_torch.decode import (
    can_fuse_generator,
    make_fused_beam_step,
)
from context_attentive_ir_tpu_torch.models import build_model
from context_attentive_ir_tpu_torch.ops.attention import AttentionPool
from context_attentive_ir_tpu_torch.ops.kernels.beamgen import (
    MAX_KC,
    generator_topk_lse,
    generator_topk_lse_reference,
)
from context_attentive_ir_tpu_torch.ops.kernels.slate import (
    MAX_HIDDEN,
    pool_jax_gate,
    pool_supported,
)
from context_attentive_ir_tpu_torch.ops.layers import reset_parameters
from context_attentive_ir_tpu_torch.serve import Engine as PortEngine
from context_attentive_ir_tpu_torch.train import make_loss_fn

# -- the slate pool's widths ---------------------------------------------------


@pytest.mark.parametrize("hidden,ok", [(128, True), (640, True), (768, True),
                                       (896, True), (1024, True),
                                       (1152, False), (1280, False),
                                       (192, False), (64, False)])
def test_pool_supported_is_the_launchers_set(hidden, ok):
    """The launcher (``csrc/slate_pool.cu:launch_h``) instantiates every
    multiple of 128 up to 1024; the gate says exactly that, from 8 rows."""
    assert MAX_HIDDEN == 1024
    assert pool_supported(hidden, 8) is ok
    assert not pool_supported(hidden, 7)
    assert pool_jax_gate(hidden, 8) is (hidden % 128 == 0)


@pytest.mark.parametrize("hidden", [1152, 640])
def test_attention_pool_plain_on_cpu(hidden):
    """A kernel-enabled pool on CPU tensors runs the plain formulation at a
    width the launcher holds (640) and at one only the JAX gate takes
    (1152), and equals the pool built without the kernel."""
    rng = np.random.RandomState(0)
    states = torch.from_numpy(rng.uniform(-1, 1, (9, 5, hidden))
                              .astype(np.float32))
    mask = torch.from_numpy(np.arange(5)[None] < rng.randint(0, 6, (9, 1)))
    query = torch.from_numpy(rng.normal(size=(9, hidden)).astype(np.float32))
    pools = [AttentionPool(hidden, hidden, use_query=True, device="cpu",
                           use_kernel=k) for k in (True, False)]
    reset_parameters(pools[0], 0)
    pools[1].load_state_dict(pools[0].state_dict())
    got, want = (p(states, mask, query) for p in pools)
    assert torch.equal(got, want)
    assert torch.isfinite(got).all()


# -- beams past the fused kernels' top-kc ---------------------------------------


@pytest.fixture(scope="module")
def served():
    """The tiny CARS of ``tests/test_torch_serve.py``: EOS logits that vary
    with the decoder state, so decodes end at different steps."""
    _, cfg, params, _, word_dict, sessions = tiny_setup()
    params = jax.tree_util.tree_map(np.array, params)
    table = params["embeddings"]["embedding"]
    table[EOS] *= 10.0
    params["generator"]["tie_proj"]["bias"] = (
        0.05 * table[EOS] / (table[EOS] @ table[EOS]))
    pcfg = PortConfig.from_json(cfg.to_json())
    return cfg, word_dict, params, pcfg, sessions


def _compare_engines(jax_eng, port_eng, hists):
    ref, got = jax_eng.suggest_batch(hists), port_eng.suggest_batch(hists)
    assert [len(nb) for nb in got] == [len(nb) for nb in ref]
    n_real = 0
    for nb_p, nb_j in zip(got, ref):
        for (tp, sp), (tj, sj) in zip(nb_p, nb_j):
            if sj > REAL:
                n_real += 1
                assert tp == tj
                assert abs(sp - sj) <= 1e-4
    return n_real


@pytest.mark.parametrize("shortlist", [0, 48])
@pytest.mark.parametrize("beam_size", [32, 40])
def test_cars_engine_beyond_the_kernels_top_kc(served, beam_size, shortlist):
    """Past the kernels' top-kc the Engine takes the logits step, or with a
    shortlist the plain shortlist step on CPU tensors (on CUDA tensors it
    raises), token-equal to the JAX Engine's."""
    cfg, wd, params, pcfg, sessions = served
    assert beam_size + 1 > MAX_KC and cfg.vocab_size > max(beam_size,
                                                           shortlist)
    hists = [list(h) + [q] for q, _, h in _texts(sessions)]
    jax_eng = JaxEngine(cfg, wd, params, beam_size=beam_size, batch_bucket=4,
                        suggest_shortlist=shortlist)
    port_eng = PortEngine(pcfg, PortDictionary.from_json(wd.to_json()),
                          params_from_jax(params, pcfg), beam_size=beam_size,
                          batch_bucket=4, suggest_shortlist=shortlist,
                          device="cpu")
    assert _compare_engines(jax_eng, port_eng, hists) >= 2 * len(hists)


def test_fused_step_gives_way_where_the_kernels_end(served):
    """``make_fused_beam_step`` is None past ``MAX_KC`` and past the E that
    ``beamgen_supported`` states; the plain top-k takes any kc <= V."""
    _, _, _, pcfg, _ = served
    model = build_model(pcfg, device="cpu")
    mem = torch.zeros((2, 3, 32))
    mask = torch.ones((2, 3), dtype=torch.bool)
    assert make_fused_beam_step(model, mem, mask, MAX_KC) is not None
    assert make_fused_beam_step(model, mem, mask, MAX_KC + 1) is None
    # past beamgen_supported: bf16 E <= 1,264, float32 E <= 908
    wide_model = build_model(pcfg.replace(emsize=1272), device="cpu")
    assert make_fused_beam_step(wide_model, mem, mask, 6) is None
    assert make_fused_beam_step(wide_model, mem, mask, 6,
                                dtype=torch.float32) is None
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    t = torch.from_numpy(rng.normal(size=(16, 50)).astype(np.float32))
    vals, idx, lse = generator_topk_lse(x, t, 40, device="cpu")
    rv, ri, rl = generator_topk_lse_reference(x, t, 40)
    assert vals.shape == (5, 40) and torch.equal(idx, ri)
    assert torch.equal(vals, rv) and torch.equal(lse, rl)
    with pytest.raises(ValueError, match="kc=51"):
        generator_topk_lse(x, t, 51, device="cpu")


# -- the untied generator ---------------------------------------------------------


@pytest.fixture(scope="module")
def untied_cars():
    jm, cfg, params, batch, word_dict, sessions = tiny_setup(
        tie_embeddings=False)
    return jm, cfg, params, batch, word_dict, sessions


def test_untied_cars_forward_and_loss_match_jax(untied_cars):
    jm, cfg, params, batch, _, _ = untied_cars
    assert set(params["generator"]) == {"proj"}
    ref = jm.apply({"params": params}, batch, True)
    pm = cars_model(cfg, params)
    out = pm(cars_batch(batch))
    _close(out["scores"], ref["scores"], tol=1e-4)
    _close(out["gen_logits"], ref["gen_logits"])
    loss_j, _ = jax_loss_fn(jm, cfg)(params, batch, jax.random.key(0), True)
    loss, _ = make_loss_fn(pm, pcfg := PortConfig.from_json(cfg.to_json()))(
        cars_batch(batch), deterministic=True)
    _close(loss, loss_j, tol=1e-5 * max(1.0, abs(float(loss_j))))
    assert not can_fuse_generator(pm) and pcfg.tie_embeddings is False
    with pytest.raises(ValueError, match="tied"):
        pm.generator(torch.zeros((1, 32)), pm.embeddings, project_only=True)


def test_untied_cars_engine_matches_jax(untied_cars):
    """An untied CARS decodes through its logits step: the JAX Engine's
    tokens at beam 5."""
    _, cfg, params, _, wd, sessions = untied_cars
    pcfg = PortConfig.from_json(cfg.to_json())
    hists = [list(h) + [q] for q, _, h in _texts(sessions)]
    jax_eng = JaxEngine(cfg, wd, params, beam_size=5, batch_bucket=4)
    port_eng = PortEngine(pcfg, PortDictionary.from_json(wd.to_json()),
                          params_from_jax(params, pcfg), beam_size=5,
                          batch_bucket=4, device="cpu")
    assert _compare_engines(jax_eng, port_eng, hists) >= len(hists)


def test_untied_hredqs_forward_and_loss_match_jax():
    cfg, params, batch, _, _, _ = hred_setup("gru")
    cfg = cfg.replace(tie_embeddings=False)
    jm = jax_build_model(cfg)
    params = jax.device_get(jm.init({"params": jax.random.key(0)}, batch,
                                    True)["params"])
    assert set(params["generator"]) == {"proj"}
    ref = jm.apply({"params": params}, batch, True)
    pm = hred_model(cfg, params)
    _close(pm(port_batch(batch)), ref)
    loss_j, _ = jax_loss_fn(jm, cfg)(params, batch, jax.random.key(0), True)
    loss, _ = make_loss_fn(pm, PortConfig.from_json(cfg.to_json()))(
        port_batch(batch), deterministic=True)
    _close(loss, loss_j, tol=1e-5 * max(1.0, abs(float(loss_j))))
    assert not can_fuse_generator(pm)
