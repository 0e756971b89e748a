"""The logits step's top-k in the port (``decode/beam.py``: ``topk_exact``,
``_topk_rows``, ``_chunk_count``, ``beam_search(topk_method=...)``)
against the JAX package's on the CPU, where JAX's ``exact`` is
``lax.top_k``, ``chunked`` its two-stage form and ``approx``
``lax.approx_max_k``, which there returns ``lax.top_k``'s values and
indices at the beam's widths (2 <= k < V) but breaks ties toward the
higher index at k = 1 and orders signed zeros otherwise at k = V; the
port's ``approx`` is ``exact`` everywhere, so it is held to JAX's
``approx`` at the beam's widths and to ``lax.top_k`` at all of them.

Values are compared bit for bit and indices exactly, on rows with ties
inside the top-k, ties at its edge (the k-th and (k+1)-th equal, with
more tied columns than slots), -0.0 beside +0.0 (``lax.top_k`` ranks
+0.0 higher; a stable sort holds them equal, so ``topk_desc`` is held
to the same answers only on rows without signed zeros), rows masked to
NEG_INF but for a few columns, and bf16-rounded logits over a
50,000-word vocabulary.  Beam search's tokens equal JAX's for every
method, and ``exact`` sorts no row of the vocabulary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.decode import beam as jax_beam
from context_attentive_ir_tpu_torch.decode import beam
from context_attentive_ir_tpu_torch.ops.masking import NEG_INF

METHODS = ("exact", "chunked", "approx", "auto")
REAL = -1e8


def _rows(kind, rng, r, v):
    if kind == "integer":          # ties inside the top-k and at its edge
        return rng.randint(-3, 4, size=(r, v)).astype(np.float32)
    if kind == "signed_zero":      # -0.0 / +0.0 at the edge
        x = rng.choice(np.array([-0.0, 0.0, -1.0, 1.0], np.float32),
                       size=(r, v), p=[0.4, 0.4, 0.15, 0.05])
        return x.astype(np.float32)
    if kind == "masked":           # NEG_INF but for a few columns
        x = np.full((r, v), NEG_INF, np.float32)
        live = rng.rand(r, v) < 0.02
        x[live] = rng.normal(size=live.sum())
        x[:, 0] = rng.normal(size=r)
        return x
    if kind == "bf16":             # logits rounded to bfloat16
        x = torch.from_numpy(rng.normal(size=(r, v)).astype(np.float32) * 3)
        return x.to(torch.bfloat16).float().numpy()
    return rng.normal(size=(r, v)).astype(np.float32)


def _same(got, ref):
    """Values bit for bit (so -0.0 differs from +0.0) and indices."""
    (gv, gi), (rv, ri) = got, ref
    rv, ri = np.asarray(rv), np.asarray(ri)
    assert np.array_equal(gi.numpy(), ri), (gi, ri)
    assert np.array_equal(gv.numpy().view(np.int32), rv.view(np.int32))


def test_chunk_count_matches_jax():
    for v in (7, 40, 96, 1000, 1024, 30000, 50000, 50004, 65536):
        for kc in (1, 2, 6, 11, 32, 41):
            assert beam._chunk_count(v, kc) == jax_beam._chunk_count(v, kc)


@pytest.mark.parametrize("kind", ["integer", "signed_zero", "masked",
                                  "normal"])
@pytest.mark.parametrize("v,k", [(40, 6), (1000, 6), (96, 1), (7, 7)])
def test_topk_rows_match_lax_top_k(kind, v, k):
    rng = np.random.RandomState(v + k)
    x = _rows(kind, rng, 9, v)
    ref = jax.lax.top_k(jnp.asarray(x), k)
    for method in METHODS:
        got = beam._topk_rows(torch.from_numpy(x), k, method)
        _same(got, ref)
        if method != "approx" or 2 <= k < v:
            _same(got, jax_beam._topk_rows(jnp.asarray(x), k, method))
    if kind != "signed_zero":
        _same(beam.topk_desc(torch.from_numpy(x), k), ref)


def test_tied_edges_take_the_lower_columns(monkeypatch):
    """Rows whose k-th value is tied past the k slots go through
    ``_resolve_tied``, and its answer is ``lax.top_k``'s."""
    calls = []
    real = beam._resolve_tied
    monkeypatch.setattr(beam, "_resolve_tied",
                        lambda x, *a: calls.append(x.shape[0]) or real(x, *a))
    x = np.zeros((4, 12), np.float32)
    x[0, [9, 3, 5]] = 2.0                 # 3 tied, k = 2: columns 3, 5
    x[1, 7] = 1.0                         # edge tie over the zeros
    x[2] = -0.0
    x[2, [4, 10]] = 0.0                   # +0.0 above -0.0
    x[3] = np.arange(12)[::-1]            # no tie: not resolved
    got = beam.topk_exact(torch.from_numpy(x), 2)
    _same(got, jax.lax.top_k(jnp.asarray(x), 2))
    np.testing.assert_array_equal(got[1].numpy(),
                                  [[3, 5], [7, 0], [4, 10], [0, 1]])
    assert calls == [3]


def test_bf16_logits_over_the_vocabulary():
    """One beam-5 step's rows at V = 50,000 from bf16 logits (many ties):
    every method gives ``lax.top_k``'s answer; chunked runs 25 chunks."""
    rng = np.random.RandomState(0)
    x = _rows("bf16", rng, 6, 50000)
    assert beam._chunk_count(50000, 6) == 25
    ref = jax.lax.top_k(jnp.asarray(x), 6)
    for method in METHODS:
        _same(beam._topk_rows(torch.from_numpy(x), 6, method), ref)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="topk_method"):
        beam._topk_rows(torch.zeros(2, 8), 2, "fast")
    with pytest.raises(ValueError, match="topk_method"):
        beam.beam_search(lambda s, t: (s, torch.zeros(2, 8)),
                         {"h": torch.zeros(1, 1)}, 1, 2, 2,
                         topk_method="fast")


# -- beam search ------------------------------------------------------------


def _table(v, seed):
    """A next-token logit table [V, V] with integer values (ties) and an
    EOS column that rises with the token id, so beams end at different
    steps."""
    rng = np.random.RandomState(seed)
    t = rng.randint(-4, 3, size=(v, v)).astype(np.float32)
    t[:, 2] = np.linspace(-6, 2, v).astype(np.float32)   # EOS = 2
    return t


@pytest.mark.parametrize("method", METHODS)
def test_beam_search_matches_jax(method):
    V, B, K, T = 120, 3, 5, 7
    table = _table(V, 1)
    init = np.arange(B, dtype=np.float32)[:, None]
    jt = jnp.asarray(table)

    def jstep(state, toks):
        return state, jt[toks] + state[:, :1] * 0.0

    tt = torch.from_numpy(table)

    def pstep(state, toks):
        return state, tt[toks] + state[:, :1] * 0.0

    ref_seqs, ref_scores = jax_beam.beam_search(
        jstep, jnp.asarray(init), B, T, K, return_nbest=True,
        topk_method=method)
    seqs, scores = beam.beam_search(pstep, torch.from_numpy(init), B, T, K,
                                    return_nbest=True, topk_method=method)
    ref_seqs, ref_scores = np.asarray(ref_seqs), np.asarray(ref_scores)
    real = ref_scores > REAL
    assert real.sum() >= B
    np.testing.assert_array_equal(seqs.numpy()[real], ref_seqs[real])
    np.testing.assert_allclose(scores.numpy()[real], ref_scores[real],
                               rtol=0, atol=1e-5)


def test_exact_sorts_no_vocabulary_row(monkeypatch):
    """With ``topk_method="exact"`` every sort the beam runs is over at
    most K * (K + 1) columns (the merge), never over the V of a row."""
    widths = []
    for owner, name in ((torch, "sort"), (torch, "argsort"),
                        (torch.Tensor, "sort"), (torch.Tensor, "argsort")):
        real = getattr(owner, name)

        def spy(x, *a, _real=real, **kw):
            widths.append(x.shape[-1])
            return _real(x, *a, **kw)

        monkeypatch.setattr(owner, name, spy)
    V, K = 1000, 5
    table = torch.from_numpy(_table(V, 2))
    beam.beam_search(lambda s, t: (s, table[t]), torch.zeros(2, 1), 2, 6, K,
                     topk_method="exact")
    assert widths and max(widths) <= K * (K + 1)
