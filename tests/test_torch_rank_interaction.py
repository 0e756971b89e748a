"""The interaction rankers ARC-I, ARC-II, DRMM and Match-Tensor (LSTM and
GRU encoders) in the port against the JAX package at f32, through the
checks of ``tests/test_torch_rank_models.py``: the parameter tree, the
slate scores, ``rank_loss`` under every ``loss_type`` with every gradient
(on the ragged batch: a padded row, an empty slot, a row without a click),
three SGD steps.  Then DRMM's histogram: the cosines 1e-6 abs and the bins
exactly equal to JAX's away from the edges (the port's edges are the
float32 values nearest ``linspace(-1, 1, 31)``; ``jnp.linspace`` rounds
some an ulp away, so a cosine within 1e-6 of an edge is left out of the
comparison and counted); and Match-Tensor's match tensor and its RNN
encoders' routing on the CPU.  Tolerances as stated there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rank_models import (
    LOSS_TYPES,
    check_loss_and_grads,
    check_param_tree,
    check_scores,
    check_three_sgd_steps,
    port_batch,
    port_model,
    rank_setup,
)

from context_attentive_ir_tpu.models.rankers.drmm import (
    NUM_BINS as JAX_NUM_BINS,
)
from context_attentive_ir_tpu_torch.models.rankers.drmm import (
    EDGES,
    NUM_BINS,
    _unit,
)

VARIANTS = {
    "arci": ("arci", dict(filter_widths=(2, 3))),
    "arcii": ("arcii", {}),
    "drmm": ("drmm", {}),
    "match_tensor": ("match_tensor", {}),
    "match_tensor-gru": ("match_tensor", dict(rnn_type="gru",
                                              bidirection=False)),
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


def test_drmm_histogram_matches_jax_away_from_the_edges():
    st = rank_setup("drmm")
    assert NUM_BINS == JAX_NUM_BINS and EDGES.shape == (NUM_BINS - 1,)
    table = st.params["embeddings"]["embedding"]
    q = jnp.asarray(table)[np.asarray(st.batch.query)]
    d = jnp.asarray(table)[np.asarray(st.batch.docs)]
    # the JAX model's own construction (models/rankers/drmm.py)
    qn = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-8)
    dn = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
    cos_j = np.asarray(jnp.einsum("bqe,bnde->bnqd", qn, dn))
    edges_j = np.asarray(jnp.linspace(-1.0, 1.0, NUM_BINS + 1)[1:-1])
    bins_j = (cos_j[..., None] > edges_j).sum(-1)
    assert np.abs(edges_j - EDGES).max() <= 1.2e-7
    pm = port_model(st.cfg, st.params)
    b = port_batch(st.batch)
    with torch.no_grad():
        qt, dt = pm.embeddings(b.query), pm.embeddings(b.docs)
        hist = pm.histogram(b, qt, dt)
        cos_p = torch.einsum("bqe,bnde->bnqd", _unit(qt), _unit(dt)).numpy()
    np.testing.assert_allclose(cos_p, cos_j, rtol=0, atol=1e-6)
    bins_p = np.searchsorted(EDGES, cos_p, side="left")
    near = (np.abs(cos_j[..., None] - EDGES).min(-1) <= 1e-6)
    assert near.sum() <= 2, near.sum()
    np.testing.assert_array_equal(bins_p[~near], bins_j[~near])
    # exact matches (cos = 1) land in the top bin
    assert (bins_j[cos_j > 0.9999] == NUM_BINS - 1).all()
    assert (cos_j > 0.9999).any()
    # the counts over the valid pairs, as JAX's one-hot sum
    pm_mask = (np.asarray(st.batch.doc_mask)[:, :, None, :]
               & np.asarray(st.batch.query_mask)[:, None, :, None])
    counts = (np.eye(NUM_BINS)[bins_j] * pm_mask[..., None]).sum(-2)
    if not near.any():
        np.testing.assert_allclose(hist.numpy(), np.log1p(counts), rtol=0,
                                   atol=1e-6)


def test_match_tensor_matches_jax():
    """``[B, N, Lq, Ld, C + 1]`` against the JAX construction over the JAX
    model's own projected states (``q_proj`` / ``d_proj`` outputs captured
    from ``model.apply``), with exact matches; on the CPU the encoders take
    kernel 1's plain version."""
    from context_attentive_ir_tpu.models import build_model as jax_build
    from context_attentive_ir_tpu_torch.models.rankers.match_tensor import (
        match_tensor,
    )

    st = rank_setup("match_tensor")
    jm = jax_build(st.cfg)
    _, inter = jm.apply({"params": st.params}, st.batch, True,
                        capture_intermediates=True,
                        mutable=["intermediates"])
    qp_j = np.asarray(inter["intermediates"]["q_proj"]["__call__"][0])
    dp_j = np.asarray(inter["intermediates"]["d_proj"]["__call__"][0])
    query, docs = np.asarray(st.batch.query), np.asarray(st.batch.docs)
    qm, dm = np.asarray(st.batch.query_mask), np.asarray(st.batch.doc_mask)
    ref = qp_j[:, None, :, None, :] * dp_j[:, :, None, :, :]
    exact = ((query[:, None, :, None] == docs[:, :, None, :])
             & (query[:, None, :, None] != 0))
    ref = np.concatenate([ref, exact[..., None].astype(np.float32)], -1)
    ref = ref * (qm[:, None, :, None] & dm[:, :, None, :])[..., None]

    pm = port_model(st.cfg, st.params)
    b = port_batch(st.batch)
    with torch.no_grad():
        q = pm.embeddings(b.query)
        d = pm.embeddings(b.docs)
        B, N, Ld, E = d.shape
        qs, _ = pm.query_encoder(q, b.query_mask)
        ds, _ = pm.doc_encoder(d.reshape(B * N, Ld, E),
                               b.doc_mask.reshape(B * N, Ld))
        qp, dp = pm.q_proj(qs), pm.d_proj(ds.reshape(B, N, Ld, -1))
        got = match_tensor(qp, dp, b.query, b.docs, b.query_mask,
                           b.doc_mask)
    np.testing.assert_allclose(qp.numpy(), qp_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dp.numpy(), dp_j, rtol=0, atol=1e-6)
    assert got.shape == ref.shape and got.shape[-1] == st.cfg.nfilters + 1
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert float(got[..., -1].sum()) > 0
    assert all(layer.use_kernel for enc in (pm.query_encoder, pm.doc_encoder)
               for layer in enc.children())
