"""The port's beam search (``decode/beam.py``, one bookkeeping) against
both bookkeepings of the JAX package's (``legacy`` and ``fused``, which
the JAX package holds bit-equal to each other): tokens equal and scores to
1e-5 over beam widths 1-8, finished beams, tied scores, n-best output,
early exit, coverage penalties and the fused-generator step.  The steps
read a state that is reordered with the beams, so a reorder that goes
wrong shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.decode import beam as jax_beam
from context_attentive_ir_tpu_torch.constants import EOS
from context_attentive_ir_tpu_torch.decode import beam

V = 40
BOOKKEEPINGS = ("legacy", "fused")


def _table(seed, eos_high=False):
    """A next-token logit table [V, V] of few values (ties between beams
    and tokens) with an EOS column that rises with the token id, so beams
    end at different steps."""
    rng = np.random.RandomState(seed)
    t = rng.randint(-4, 3, size=(V, V)).astype(np.float32)
    t[:, EOS] = np.linspace(-6, 3 if eos_high else 1, V).astype(np.float32)
    return t


class _Torch:
    asarray = staticmethod(torch.from_numpy)
    softmax = staticmethod(lambda x: torch.softmax(x, dim=-1))

    @staticmethod
    def topk(logits, kc):
        vals, idx = beam.topk_exact(logits, kc)
        return vals, idx, torch.logsumexp(logits, -1)

    @staticmethod
    def init(b):
        return {"prev": torch.zeros(b, dtype=torch.long),
                "n": torch.arange(b, dtype=torch.long),
                "h": torch.arange(b * 4, dtype=torch.float32).reshape(b, 4)}


class _Jax:
    asarray = staticmethod(jnp.asarray)
    softmax = staticmethod(lambda x: jax.nn.softmax(x, axis=-1))

    @staticmethod
    def topk(logits, kc):
        vals, idx = jax.lax.top_k(logits, kc)
        return vals, idx, jax.nn.logsumexp(logits, -1)

    @staticmethod
    def init(b):
        return {"prev": jnp.zeros(b, jnp.int32),
                "n": jnp.arange(b, dtype=jnp.int32),
                "h": jnp.arange(b * 4, dtype=jnp.float32).reshape(b, 4)}


def _step(xp, table, attn_len=0, kc=0):
    """(state, tokens) -> (state, logits[, attention]) in ``xp``'s arrays
    (or, with ``kc``, the fused-generator step's (vals, idx, lse)); the
    state carries the previous token, a counter and a vector, so a reorder
    that goes wrong shows."""
    table = xp.asarray(table)

    def step(state, toks):
        row = table[toks]
        new = {"prev": toks, "n": state["n"] + 1,
               "h": state["h"] * 0.5 + row[:, :4]}
        logits = row + 0.5 * (state["n"][:, None] % 3 == 0)
        if kc:
            return new, xp.topk(logits, kc)
        if not attn_len:
            return new, logits
        return new, logits, xp.softmax(row[:, :attn_len] * 0.3
                                       + new["h"][:, :1])
    return step


def _against_jax(bookkeeping, table, b, max_len, k, attn_len=0, kc=0,
                 cov_mask=None, **kw):
    """The port's beam and the JAX one under ``bookkeeping`` on the same
    step: tokens equal, scores to 1e-5."""
    got = beam.beam_search(
        _step(_Torch, table, attn_len, kc), _Torch.init(b), b, max_len, k,
        cov_mask=None if cov_mask is None else torch.from_numpy(cov_mask),
        **kw)
    want = jax_beam.beam_search(
        _step(_Jax, table, attn_len, kc), _Jax.init(b), b, max_len, k,
        cov_mask=None if cov_mask is None else jnp.asarray(cov_mask),
        bookkeeping=bookkeeping, **kw)
    seqs, scores = (g.numpy() for g in got)
    ref_seqs, ref_scores = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(seqs, ref_seqs)
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-5)
    return seqs, scores


@pytest.mark.parametrize("bookkeeping", BOOKKEEPINGS)
@pytest.mark.parametrize("k", range(1, 9))
def test_matches_jax_over_beam_widths(k, bookkeeping):
    seqs, scores = _against_jax(bookkeeping, _table(k), 3, 7, k)
    assert seqs.shape == (3, 7) and np.isfinite(scores).all()


@pytest.mark.parametrize("bookkeeping", BOOKKEEPINGS)
@pytest.mark.parametrize("nbest", [False, True])
@pytest.mark.parametrize("early_exit", [False, True])
def test_matches_jax_with_finished_beams(nbest, early_exit, bookkeeping):
    seqs, _ = _against_jax(bookkeeping, _table(11, eos_high=True), 4, 9, 5,
                           return_nbest=nbest, early_exit=early_exit,
                           min_length=1)
    # beams finished before max_len: EOS inside, PAD after it
    assert (seqs == EOS).any()


@pytest.mark.parametrize("bookkeeping", BOOKKEEPINGS)
def test_matches_jax_with_coverage(bookkeeping):
    mask = np.array([[1, 1, 1, 0, 0, 0], [1] * 6, [1, 1, 0, 0, 0, 0]], bool)
    _against_jax(bookkeeping, _table(5), 3, 6, 4, attn_len=6,
                 coverage_beta=0.3, cov_mask=mask, return_nbest=True)


@pytest.mark.parametrize("bookkeeping", BOOKKEEPINGS)
@pytest.mark.parametrize("kc", [6, 9])
def test_matches_jax_in_the_fused_generator_mode(kc, bookkeeping):
    _against_jax(bookkeeping, _table(7, eos_high=True), 3, 8, 5, kc=kc,
                 return_nbest=True, early_exit=True)
