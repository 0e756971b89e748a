"""The rankers' data and layers in the port against the JAX package at f32.

- ``RankBatch``: ``rank_examples`` and ``build_rank_batch`` bit-equal to
  the JAX vectorizer (dtypes included), with and without ``max_word_len``
  (the byte ids of ``CharDictionary``), with a padded row and an empty
  candidate slot; the Trainer's ranker iterator (plain and packed, both
  bit-equal to JAX's; packed equal to plain, ``None`` character fields
  passed through).
- Ops: ``masked_mean``, ``sequence_mask``, ``mask_logits``,
  ``cosine_similarity`` (values, and the gradient at a zero vector: finite
  in the port, NaN in JAX -- F12), ``CharCNN`` and ``Conv`` over one and
  two spatial axes at odd and even windows against flax ``nn.Conv``
  (``SAME`` pinned by a one-hot probe).
- The registry: the port's ``MODEL_CLASSES`` holds every JAX model type.

Tolerances: masked means and cosines 1e-6 abs (order-1 values), their
gradients 1e-6 abs; conv values and gradients 1e-5 of the largest
reference value (sums of up to 60 products in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from context_attentive_ir_tpu import data as jdata
from context_attentive_ir_tpu.config import default_config as jax_config
from context_attentive_ir_tpu.constants import CHAR_VOCAB_SIZE
from context_attentive_ir_tpu.models import (
    get_model_class as jax_get_model_class,
)
from context_attentive_ir_tpu.ops import masking as jmask
from context_attentive_ir_tpu.ops.layers import CharCNN as JaxCharCNN
from context_attentive_ir_tpu.ops.layers import (
    cosine_similarity as jax_cosine,
)
from context_attentive_ir_tpu.train.trainer import (
    make_iterator as jax_make_iterator,
)
from context_attentive_ir_tpu_torch import data as pdata
from context_attentive_ir_tpu_torch.config import (
    MODEL_DEFAULTS,
    default_config,
)
from context_attentive_ir_tpu_torch.data import synthetic as psyn
from context_attentive_ir_tpu_torch.models import (
    MODEL_CLASSES,
    get_model_class,
    task_family,
)
from context_attentive_ir_tpu_torch.models.rankers import RANKER_CLASSES
from context_attentive_ir_tpu_torch.ops.layers import (
    CharCNN,
    Conv,
    cosine_similarity,
)
from context_attentive_ir_tpu_torch.ops.masking import (
    NEG_INF,
    mask_logits,
    masked_mean,
    sequence_mask,
)
from context_attentive_ir_tpu_torch.train.trainer import make_iterator

DIMS = dict(max_query_len=5, max_doc_len=7, max_session_len=3,
            num_candidates=4)


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _assert_rank_batch_equal(jb, pb):
    for f in dataclasses.fields(pb):
        a, b = getattr(jb, f.name), getattr(pb, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
            continue
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


# -- RankBatch ----------------------------------------------------------------


def _sessions(mod, seed=0):
    sessions = [mod.Session.from_dict(d) for d in jdata.generate_sessions(
        n_sessions=5, min_turns=1, max_turns=3, n_candidates=6, seed=seed)]
    # an empty candidate slot, a non-ASCII word and a word longer than
    # max_word_len
    q = sessions[0].queries[0]
    q.documents = q.documents[:2]
    q.tokens = q.tokens + ["straße", "x" * 40]
    sessions[1].queries[0].documents = []   # no slate: not an example
    return sessions


@pytest.mark.parametrize("word_len", [0, 6])
def test_build_rank_batch_bit_equal(word_len):
    js, ps = _sessions(jdata), _sessions(pdata)
    jex, pex = jdata.rank_examples(js), pdata.rank_examples(ps)
    assert [q.query_id for q in pex] == [q.query_id for q in jex]
    assert len(pex) == sum(len(s.queries) for s in ps) - 1
    streams = [q.tokens for q in pex] + [d.tokens for q in pex
                                         for d in q.documents]
    jd, pd_ = jdata.build_dictionary(streams), pdata.build_dictionary(streams)
    jshape = jdata.ShapeConfig(**DIMS, max_word_len=word_len)
    pshape = pdata.ShapeConfig(**DIMS, max_word_len=word_len)
    jb = jdata.build_rank_batch(jex, jd, jshape, batch_size=len(jex) + 1)
    pb = pdata.build_rank_batch(pex, pd_, pshape, batch_size=len(pex) + 1)
    _assert_rank_batch_equal(jb, pb)
    assert not pb.row_mask[-1] and not pb.cand_mask[0].all()
    assert (pb.query_chars is None) == (word_len == 0)
    if word_len:
        assert pb.query_chars.shape == (len(pex) + 1, 5, word_len)
        assert pb.doc_chars.shape == (len(pex) + 1, 4, 7, word_len)
        assert pb.query_chars.max() < len(pdata.CharDictionary())
    t = pb.to("cpu")
    assert t.query.dtype == torch.int64 and t.labels.dtype == torch.float32
    assert (t.query_chars is None) == (word_len == 0)


@pytest.mark.parametrize("charngram", [False, True])
@pytest.mark.parametrize("pack", [False, True])
def test_ranker_batch_streams_bit_equal(tmp_path, pack, charngram):
    """The Trainer's ranker iterator: a short last batch, two epochs and a
    resumed epoch, bit-equal to JAX's; ``use_charngram`` adds the byte ids
    (``MAX_WORD_LEN``)."""
    path = psyn.write_fixture(tmp_path / "s.jsonl", n_sessions=9,
                              n_candidates=6, seed=0)
    js, ps = (mod.load_data(str(path), 5, 7, 4, 3) for mod in (jdata, pdata))
    streams = [t for s in ps for q in s.queries
               for t in [q.tokens] + [d.tokens for d in q.documents]]
    jd, pd_ = jdata.build_dictionary(streams), pdata.build_dictionary(streams)
    jcfg = jax_config("dssm", vocab_size=len(jd), use_charngram=charngram,
                      **DIMS)
    pcfg = default_config("dssm", vocab_size=len(pd_),
                          use_charngram=charngram, **DIMS)
    kw = dict(batch_size=4, shuffle=True, seed=3, pack=pack)
    jit, pit = (jax_make_iterator(js, jcfg, jd, **kw),
                make_iterator(ps, pcfg, pd_, **kw))
    n_ex = len(pdata.rank_examples(ps))
    assert len(jit) == len(pit) > 1 and n_ex % 4 != 0
    for epoch in (0, 1):
        pbs = list(pit.epoch(epoch))
        for jb, pb in zip(jit.epoch(epoch), pbs):
            _assert_rank_batch_equal(jb, pb)
        assert sum(int(b.row_mask.sum()) for b in pbs) == n_ex
    for jb, pb in zip(jit.epoch(2, start_batch=1),
                      pit.epoch(2, start_batch=1)):
        _assert_rank_batch_equal(jb, pb)
    if pack:
        plain = make_iterator(ps, pcfg, pd_, **{**kw, "pack": False})
        for a, b in zip(plain.epoch(1), pit.epoch(1)):
            _assert_rank_batch_equal(a, b)
        assert pit.nbytes > 0


def test_shapes_from_config_sets_word_len():
    cfg = default_config("dssm", use_charngram=True)
    assert pdata.shapes_from_config(cfg).max_word_len == 16
    assert pdata.shapes_from_config(
        cfg.replace(use_charngram=False)).max_word_len == 0
    assert len(pdata.CharDictionary()) == CHAR_VOCAB_SIZE


# -- ops ----------------------------------------------------------------------


def test_masking_helpers_match_jax():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(3, 4, 5, 6)).astype(np.float32)
    mask = rng.rand(3, 4, 5) < 0.6
    mask[1, 2] = False                          # a fully masked row
    got = masked_mean(torch.from_numpy(x), torch.from_numpy(mask))
    ref = jmask.masked_mean(jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=1e-6)
    assert torch.equal(got[1, 2], torch.zeros(6))
    lengths = np.array([[0, 3], [5, 1]])
    np.testing.assert_array_equal(
        sequence_mask(torch.from_numpy(lengths), 5).numpy(),
        np.asarray(jmask.sequence_mask(jnp.asarray(lengths), 5)))
    logits = rng.normal(size=(3, 4, 5)).astype(np.float32)
    got = mask_logits(torch.from_numpy(logits), torch.from_numpy(mask))
    np.testing.assert_array_equal(
        _np(got), np.asarray(jmask.mask_logits(jnp.asarray(logits),
                                               jnp.asarray(mask))))
    assert float(got[1, 2].max()) == NEG_INF


def test_cosine_similarity_values_and_finite_gradient_at_zero():
    """Values equal JAX's; at a zero vector (a padded row's or an empty
    slot's masked mean) JAX's gradient is NaN and the port's finite, and
    elsewhere the two agree (F12)."""
    rng = np.random.RandomState(1)
    a = rng.normal(size=(3, 1, 8)).astype(np.float32)
    b = rng.normal(size=(3, 4, 8)).astype(np.float32)
    a[2] = 0.0
    b[0, 1] = 0.0
    w = rng.normal(size=(3, 4)).astype(np.float32)

    def f(aa, bb):
        return jnp.sum(jax_cosine(aa, bb) * w)

    ref = jax_cosine(jnp.asarray(a), jnp.asarray(b))
    ga_j, gb_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at, bt = (torch.from_numpy(v).requires_grad_() for v in (a, b))
    got = cosine_similarity(at, bt)
    assert float(got.detach()[2].abs().max()) == 0.0
    assert float(got.detach()[0, 1]) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=1e-6)
    (got * torch.from_numpy(w)).sum().backward()
    for g_p, g_j, zero in ((at.grad, ga_j, (2,)), (bt.grad, gb_j, (0, 1))):
        g_j = np.asarray(g_j)
        assert not np.isfinite(g_j[zero]).all()      # the JAX reference
        assert torch.isfinite(g_p).all()
        keep = np.isfinite(g_j)
        np.testing.assert_allclose(_np(g_p)[keep], g_j[keep], rtol=0,
                                   atol=1e-6)
    # the zero vector's own gradient is its direct term, w / eps
    assert torch.allclose(bt.grad[0, 1], (at[0, 0] / at[0, 0].norm()
                                          * w[0, 1] / 1e-8).detach(),
                          rtol=1e-5)


def _load_conv(layer, kernel, bias):
    with torch.no_grad():
        layer.kernel.copy_(torch.from_numpy(kernel))
        layer.bias.copy_(torch.from_numpy(bias))


@pytest.mark.parametrize("window", [(3,), (2,), (4,), (3, 3), (2, 3),
                                    (4, 2)])
def test_conv_matches_flax_at_odd_and_even_windows(window):
    """Values, the input gradient and both parameter gradients; the output
    keeps the input's size (SAME) and a one-hot probe at the first
    position pins the padding: flax pads (k - 1) // 2 before, k // 2
    after."""
    rng = np.random.RandomState(len(window) * 10 + window[0])
    spatial = (6,) if len(window) == 1 else (5, 6)
    x = rng.normal(size=(3, *spatial, 5)).astype(np.float32)
    conv = nn.Conv(4, kernel_size=window, padding="SAME")
    kernel = np.array(conv.init(jax.random.key(0),
                                jnp.asarray(x))["params"]["kernel"])
    bias = rng.normal(size=4).astype(np.float32)
    w = rng.normal(size=(3, *spatial, 4)).astype(np.float32)

    def f(p, xx):
        y = conv.apply({"params": p}, xx)
        return jnp.sum(y * w), y

    params = {"kernel": kernel, "bias": bias}
    (_, y_j), (gp_j, gx_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    layer = Conv(5, 4, window, "SAME", device="cpu")
    assert tuple(layer.kernel.shape) == (*window, 5, 4)
    _load_conv(layer, kernel, bias)
    xt = torch.from_numpy(x).requires_grad_()
    y = layer(xt)
    assert tuple(y.shape) == (3, *spatial, 4)
    (y * torch.from_numpy(w)).sum().backward()
    for got, ref in ((y, y_j), (xt.grad, gx_j),
                     (layer.kernel.grad, gp_j["kernel"]),
                     (layer.bias.grad, gp_j["bias"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    # the probe: input 1 at position 0 reaches output i through kernel tap
    # (k - 1) // 2 - i
    probe = torch.zeros(1, *spatial, 5)
    probe[(0,) * (len(window) + 2)] = 1.0
    with torch.no_grad():
        out = layer(probe) - layer.bias
    before = [(k - 1) // 2 for k in window]
    region = tuple(slice(0, b + 1) for b in before)
    taps = kernel[tuple(slice(b, None, -1) for b in before)][..., 0, :]
    np.testing.assert_allclose(_np(out[(0, *region)]), taps, rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="spatial"):
        Conv(5, 4, (3, 3, 3), device="cpu")


def test_char_cnn_matches_jax():
    """Byte ids ``[2, 3, 6]`` -> ``[2, 3, 96]``: the parameter tree
    (``char_emb``, ``conv2``, ``conv3``, ``conv4`` at flax's SAME, even
    windows included), values and every gradient."""
    rng = np.random.RandomState(2)
    ids = rng.randint(0, CHAR_VOCAB_SIZE, size=(2, 3, 6)).astype(np.int32)
    ids[0, 1, 3:] = 0                                  # a short word
    jm = JaxCharCNN(CHAR_VOCAB_SIZE)
    params = jax.device_get(jm.init(jax.random.key(0),
                                    jnp.asarray(ids))["params"])
    params = jax.tree_util.tree_map(np.array, params)
    for w in (2, 3, 4):
        params[f"conv{w}"]["bias"] = rng.normal(size=32).astype(np.float32)
    wgt = rng.normal(size=(2, 3, 96)).astype(np.float32)

    def f(p):
        y = jm.apply({"params": p}, jnp.asarray(ids))
        return jnp.sum(y * wgt), y

    (_, y_j), g_j = jax.value_and_grad(f, has_aux=True)(params)
    layer = CharCNN(CHAR_VOCAB_SIZE, device="cpu")
    assert layer.features == 96
    names = {n: tuple(p.shape) for n, p in layer.named_parameters()}
    assert names == {
        "char_emb.embedding": (CHAR_VOCAB_SIZE, 16),
        **{f"conv{w}.{k}": s for w in (2, 3, 4)
           for k, s in (("kernel", (w, 16, 32)), ("bias", (32,)))}}
    with torch.no_grad():
        layer.char_emb.embedding.copy_(
            torch.from_numpy(params["char_emb"]["embedding"]))
    for w in (2, 3, 4):
        _load_conv(getattr(layer, f"conv{w}"), params[f"conv{w}"]["kernel"],
                   params[f"conv{w}"]["bias"])
    y = layer(torch.from_numpy(ids).long())
    np.testing.assert_allclose(_np(y), np.asarray(y_j), rtol=0, atol=1e-6)
    (y * torch.from_numpy(wgt)).sum().backward()
    grads = {"char_emb.embedding": g_j["char_emb"]["embedding"],
             **{f"conv{w}.{k}": g_j[f"conv{w}"][k] for w in (2, 3, 4)
                for k in ("kernel", "bias")}}
    for name, p in layer.named_parameters():
        ref = np.asarray(grads[name])
        np.testing.assert_allclose(_np(p.grad), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max() + 1e-7)


# -- the registry -------------------------------------------------------------


def test_model_classes_cover_the_jax_zoo():
    from context_attentive_ir_tpu.models import task_family as jax_family

    jax_types = set(MODEL_DEFAULTS)
    assert set(MODEL_CLASSES) == jax_types and len(jax_types) == 14
    for model_type in jax_types:
        jax_get_model_class(model_type)
        assert task_family(model_type) == jax_family(model_type)
        assert get_model_class(model_type) is MODEL_CLASSES[model_type]
    assert {t for t in jax_types if task_family(t) == "ranker"} == set(
        RANKER_CLASSES)
    for bad in ("bert", "DSSM", "match-tensor"):
        with pytest.raises(ValueError, match="unknown"):
            get_model_class(bad)
