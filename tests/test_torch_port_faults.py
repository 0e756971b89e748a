"""Repaired faults of the port, and the untied generator, on the CPU.

- The slate pool's gate states what its launcher runs (``pool_supported``:
  H a multiple of 128 from 128 to 1024, at least 8 rows), and
  ``AttentionPool`` routes a width the JAX gate takes but the launcher
  does not (H = 1152) to the plain formulation on CPU tensors.
- An ``Engine`` decodes at any beam up to V: up to the fused generator
  kernels' top-kc (``MAX_KC`` = 128, the JAX kernel's, kc = beam + 1) a
  CARS ``Engine`` takes the fused step (beams 32 and 40, on the kernels'
  plain version here), past it ``make_fused_beam_step`` returns None and
  CARS decodes through its logits step, as the JAX engine does (beam
  128); either way it gives the JAX ``Engine``'s tokens.  The plain
  generator top-k takes any kc up to V.
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
    RESIDENT_HIDDEN,
    pool_jax_gate,
    pool_route,
    pool_supported,
)
from context_attentive_ir_tpu_torch.ops.layers import reset_parameters
from context_attentive_ir_tpu_torch.serve import Engine as PortEngine
from context_attentive_ir_tpu_torch.train import make_loss_fn

# -- the slate pool's widths ---------------------------------------------------


@pytest.mark.parametrize("hidden,ok", [(128, True), (640, True), (768, True),
                                       (896, True), (1024, True),
                                       (1152, True), (1280, True),
                                       (192, False), (64, False)])
def test_pool_supported_is_the_launchers_set(hidden, ok):
    """The launcher (``csrc/slate_pool.cu``) takes every multiple of 128:
    bf16 at 128 and 256 on the resident kernel (documents of Ld tokens),
    every other width and float32 on the wide route, and refuses the rest
    (``pool_route`` None); the gate says exactly that, from 8 rows."""
    assert RESIDENT_HIDDEN == (128, 256)
    for dtype in (torch.float32, torch.bfloat16):
        route = pool_route(hidden, 30, dtype)
        assert route == (None if not ok else "resident"
                         if dtype == torch.bfloat16
                         and hidden in RESIDENT_HIDDEN else "wide"), \
            (hidden, dtype)
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


def _served(**kw):
    """The tiny CARS of ``tests/test_torch_serve.py``: EOS logits that vary
    with the decoder state, so decodes end at different steps."""
    _, cfg, params, _, word_dict, sessions = tiny_setup(**kw)
    params = jax.tree_util.tree_map(np.array, params)
    table = params["embeddings"]["embedding"]
    table[EOS] *= 10.0
    params["generator"]["tie_proj"]["bias"] = (
        0.05 * table[EOS] / (table[EOS] @ table[EOS]))
    pcfg = PortConfig.from_json(cfg.to_json())
    return cfg, word_dict, params, pcfg, sessions


@pytest.fixture(scope="module")
def served():
    return _served()


@pytest.fixture(scope="module")
def served_wide():
    """The same with 120 more words, so beam 128 (kc 129) fits the
    vocabulary with a 160-word shortlist."""
    return _served(extra_words=120)


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


def _compare_engines_tied(jax_eng, port_eng, hists, tol=1e-5):
    """``_compare_engines`` where near-tied scores may swap places: at
    beam 128 an untrained model's hypotheses lie ~1e-6 apart, below what
    float32 sums in another order move them.  The JAX n-best's real
    hypotheses fall into groups whose neighbouring scores lie within
    ``tol``; each group holds the same texts in both lists, save the
    members within ``tol`` of the last real score when the group reaches
    the list's end (a tied hypothesis past the n-th may take one's
    place), and the scores agree rank by rank within 1e-4.  Returns the
    real hypotheses and the texts held, per request."""
    ref, got = jax_eng.suggest_batch(hists), port_eng.suggest_batch(hists)
    assert [len(nb) for nb in got] == [len(nb) for nb in ref]
    counts = []
    for nb_p, nb_j in zip(got, ref):
        real = [k for k, (_, sj) in enumerate(nb_j) if sj > REAL]
        last = nb_j[real[-1]][1] if real else 0.0
        held, start = 0, 0
        for k in range(1, len(real) + 1):
            if k < len(real) and nb_j[real[k - 1]][1] - nb_j[real[k]][1] <= tol:
                continue
            group = real[start:k]
            want = {nb_j[i][0] for i in group}
            have = {nb_p[i][0] for i in group}
            if k == len(real) and group[-1] == len(nb_j) - 1:
                sure = {nb_j[i][0] for i in group if nb_j[i][1] - last > tol}
                assert sure <= have
                held += len(sure)
            else:
                assert have == want
                held += len(group)
            start = k
        for k in real:
            assert abs(nb_p[k][1] - nb_j[k][1]) <= 1e-4
        counts.append((len(real), held))
    return counts


def _fused_calls(monkeypatch):
    """Count the fused step's generator calls (the kernels' wrapper)."""
    from context_attentive_ir_tpu_torch.decode import fusedgen

    calls = []

    def counted(*a, **kw):
        calls.append(a[2])
        return generator_topk_lse(*a, **kw)

    monkeypatch.setattr(fusedgen, "generator_topk_lse", counted)
    return calls


def _engines(served, beam_size, shortlist):
    cfg, wd, params, pcfg, sessions = served
    hists = [list(h) + [q] for q, _, h in _texts(sessions)]
    jax_eng = JaxEngine(cfg, wd, params, beam_size=beam_size, batch_bucket=4,
                        suggest_shortlist=shortlist)
    port_eng = PortEngine(pcfg, PortDictionary.from_json(wd.to_json()),
                          params_from_jax(params, pcfg), beam_size=beam_size,
                          batch_bucket=4, suggest_shortlist=shortlist,
                          device="cpu")
    return jax_eng, port_eng, hists


@pytest.mark.parametrize("shortlist", [0, 48])
@pytest.mark.parametrize("beam_size", [32, 40])
def test_cars_engine_within_the_kernels_top_kc(served, monkeypatch,
                                               beam_size, shortlist):
    """Up to the kernels' top-128 the Engine takes the fused step (with a
    shortlist, over the shortlisted columns), token-equal to the JAX
    Engine's."""
    cfg = served[0]
    assert beam_size + 1 <= MAX_KC and cfg.vocab_size > max(beam_size,
                                                            shortlist)
    jax_eng, port_eng, hists = _engines(served, beam_size, shortlist)
    calls = _fused_calls(monkeypatch)
    assert _compare_engines(jax_eng, port_eng, hists) >= 2 * len(hists)
    assert calls and set(calls) == {beam_size + 1}


@pytest.mark.parametrize("shortlist", [0, 48])
@pytest.mark.parametrize("beam_size", [32, 40])
def test_cars_engine_logits_step_matches_jax(served, monkeypatch, beam_size,
                                            shortlist):
    """The Engine's logits step, or with a shortlist the plain shortlist
    step (the fused step given way, as past the kernels' top-kc), held
    token-equal to the JAX Engine's at beams whose scores do not tie."""
    from context_attentive_ir_tpu_torch import serve

    monkeypatch.setattr(serve, "make_fused_beam_step", lambda *a, **kw: None)
    jax_eng, port_eng, hists = _engines(served, beam_size, shortlist)
    calls = _fused_calls(monkeypatch)
    assert _compare_engines(jax_eng, port_eng, hists) >= 2 * len(hists)
    assert not calls


@pytest.mark.parametrize("shortlist", [0, 160])
@pytest.mark.parametrize("beam_size", [128])
def test_cars_engine_beyond_the_kernels_top_kc(served_wide, monkeypatch,
                                               beam_size, shortlist):
    """Past the kernels' top-kc the Engine takes the logits step, or with a
    shortlist the plain shortlist step on CPU tensors (on CUDA tensors it
    raises), token-equal to the JAX Engine's up to the order of near-tied
    hypotheses."""
    cfg = served_wide[0]
    assert beam_size + 1 > MAX_KC and cfg.vocab_size > max(beam_size,
                                                           shortlist)
    jax_eng, port_eng, hists = _engines(served_wide, beam_size, shortlist)
    calls = _fused_calls(monkeypatch)
    counts = _compare_engines_tied(jax_eng, port_eng, hists)
    assert sum(n for n, _ in counts) >= 2 * len(hists)
    assert all(2 * held >= n for n, held in counts)
    assert not calls


def test_fused_step_gives_way_where_the_kernels_end(served):
    """``make_fused_beam_step`` is None past ``MAX_KC`` = 128 and a step at
    every kc up to it at every E (E = 1,272: x streamed past bf16's whole
    x tile of 1,264 and float32's 496); the plain top-k takes any kc <=
    V."""
    _, _, _, pcfg, _ = served
    model = build_model(pcfg, device="cpu")
    mem = torch.zeros((2, 3, 32))
    mask = torch.ones((2, 3), dtype=torch.bool)
    assert MAX_KC == 128
    assert make_fused_beam_step(model, mem, mask, MAX_KC) is not None
    assert make_fused_beam_step(model, mem, mask, MAX_KC + 1) is None
    wide_model = build_model(pcfg.replace(emsize=1272), device="cpu")
    for dtype in (torch.bfloat16, torch.float32):
        for kc in (6, MAX_KC):
            assert make_fused_beam_step(wide_model, mem, mask, kc,
                                        dtype=dtype) is not None
        assert make_fused_beam_step(wide_model, mem, mask, MAX_KC + 1,
                                    dtype=dtype) is None
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
