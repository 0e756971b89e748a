"""Serving parity: a JAX ``Engine`` and the port's ``Engine`` built from the
same params answer the same requests.

The JAX engine decodes on the CPU through its logits step; the port takes
the fused-generator ``(vals, idx, lse)`` step through the kernel's plain
version.  At f32 the two agree token for token (the JAX package holds the
two step modes equal in tests/test_pallas_beamgen.py).  n-best entries are
compared only where the JAX score is a real hypothesis (above NEG_INF):
beams whose total sits at NEG_INF may tie with masked candidates.
"""

import jax
import numpy as np
import pytest
from test_torch_cars import tiny_setup

from context_attentive_ir_tpu.constants import EOS
from context_attentive_ir_tpu.serve import Engine as JaxEngine
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.data import Dictionary as PortDictionary
from context_attentive_ir_tpu_torch.serve import Engine as PortEngine

BUCKET = 4
REAL = -1e8   # n-best scores below this are NEG_INF garbage beams


@pytest.fixture(scope="module")
def served():
    """Tiny CARS whose EOS logit varies strongly with the decoder state
    and carries a small bias, so decodes end at different steps (early
    exit has work to skip) instead of running to max_len."""
    _, cfg, params, _, word_dict, sessions = tiny_setup()
    params = jax.tree_util.tree_map(np.array, params)
    table = params["embeddings"]["embedding"]
    table[EOS] *= 10.0
    params["generator"]["tie_proj"]["bias"] = (
        0.05 * table[EOS] / (table[EOS] @ table[EOS]))
    pcfg = PortConfig.from_json(cfg.to_json())
    port = (pcfg, PortDictionary.from_json(word_dict.to_json()),
            params_from_jax(params, pcfg))
    return cfg, word_dict, params, port, sessions


def _texts(sessions):
    """Five requests (past one bucket edge) with click history, with
    history but no clicks, and with no history."""
    join = " ".join
    out = []
    for s in sessions[:5]:
        *hist, cur = s.queries
        history = [(join(q.tokens), [join(d.tokens) for d in q.documents
                                     if d.label]) for q in hist]
        out.append((join(cur.tokens), [join(d.tokens)
                                       for d in cur.documents], history))
    out[1] = (out[1][0], out[1][1], [h[0] for h in out[1][2]])   # no clicks
    out[2] = (out[2][0], out[2][1][:3], ())                      # no history
    return out


def test_rank_batch_matches_jax(served):
    cfg, wd, params, (pcfg, pwd, psd), sessions = served
    reqs = _texts(sessions)
    ref = JaxEngine(cfg, wd, params, batch_bucket=BUCKET).rank_batch(reqs)
    got = PortEngine(pcfg, pwd, psd, batch_bucket=BUCKET,
                     device="cpu").rank_batch(reqs)
    assert [len(r) for r in got] == [len(r) for r in ref]
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(ref),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("beam_size", [5, 1])
def test_suggest_batch_matches_jax(served, beam_size, early_exit):
    cfg, wd, params, (pcfg, pwd, psd), sessions = served
    reqs = _texts(sessions)
    fast = [list(h) + [q] for q, _, h in reqs]           # decode_init
    heavy = [[(q, docs[:6])] + [q] for q, docs, _ in reqs[:3]]  # > cap
    jax_eng = JaxEngine(cfg, wd, params, beam_size=beam_size,
                        batch_bucket=BUCKET, suggest_early_exit=early_exit)
    port_eng = PortEngine(pcfg, pwd, psd, beam_size=beam_size,
                          batch_bucket=BUCKET, suggest_early_exit=early_exit,
                          device="cpu")
    n_real, words = 0, 0
    for hists in (fast, heavy):
        ref = jax_eng.suggest_batch(hists)
        got = port_eng.suggest_batch(hists)
        assert [len(nb) for nb in got] == [len(nb) for nb in ref]
        for nb_p, nb_j in zip(got, ref):
            for (tp, sp), (tj, sj) in zip(nb_p, nb_j):
                if sj > REAL:
                    n_real += 1
                    words += len(tp.split())
                    assert tp == tj
                    assert abs(sp - sj) <= 1e-4
    assert n_real >= len(fast) and words > 0
