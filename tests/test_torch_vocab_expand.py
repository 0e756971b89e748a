"""The port's ``train/vocab_expand.expand_dictionary`` against the JAX
package's: on the JAX init of a CARS with a tied and with an untied
generator (whose vocabulary-sized ``kernel`` and ``bias`` grow too), new
rows drawn from the seed or read from an embedding file, the grown
parameters equal ``params_from_jax`` of the JAX result bit for bit, and
the new config and dictionary agree; the grown model then builds and
scores."""

import jax
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.data import Dictionary as JaxDictionary
from context_attentive_ir_tpu.train.vocab_expand import (
    expand_dictionary as jax_expand,
)
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.convert import params_from_jax
from context_attentive_ir_tpu_torch.data import Dictionary
from context_attentive_ir_tpu_torch.models import build_model
from context_attentive_ir_tpu_torch.train.vocab_expand import (
    expand_dictionary,
)
from test_torch_cars import tiny_setup

NEW_TEXTS = [["brand", "new", "Words", "jazz"], ["more", "new", "tokens"]]


@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("from_file", [False, True])
def test_expand_dictionary_equals_the_jax_result(tmp_path, tie, from_file):
    _, cfg, params, _, wd, _ = tiny_setup(tie_embeddings=tie)
    emb_file = None
    if from_file:
        emb_file = tmp_path / "emb.txt"
        rows = [f"brand {' '.join(['0.5'] * cfg.emsize)}",
                f"TOKENS {' '.join(['-0.25'] * cfg.emsize)}",
                "bad row"]
        emb_file.write_text("\n".join(rows) + "\n")
        emb_file = str(emb_file)
    jwd = JaxDictionary.from_json(wd.to_json())
    pwd = Dictionary.from_json(wd.to_json())
    pcfg = PortConfig.from_json(cfg.to_json())
    old = params_from_jax(params, pcfg)

    jnew, jcfg, jwd, jn = jax_expand(params, cfg, jwd, NEW_TEXTS,
                                     embedding_file=emb_file, seed=5)
    new, ncfg, pwd2, n = expand_dictionary(old, pcfg, pwd, NEW_TEXTS,
                                           embedding_file=emb_file, seed=5)
    assert pwd2 is pwd and n == jn == 5    # "jazz" is known
    assert pwd.tokens() == jwd.tokens()
    assert ncfg.vocab_size == jcfg.vocab_size == len(pwd)
    want = params_from_jax(jax.device_get(jnew), ncfg)
    assert set(new) == set(want)
    for k, v in new.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    grown = [k for k in new if new[k].shape != old[k].shape]
    assert "embeddings.embedding" in grown
    assert ("generator.proj.kernel" in grown) == (not tie)
    # the old rows are kept, the new ones are the seed's or the file's
    assert torch.equal(new["embeddings.embedding"][:len(wd)],
                       old["embeddings.embedding"])
    if from_file:
        row = new["embeddings.embedding"][pwd["brand"]]
        assert torch.equal(row, torch.full_like(row, 0.5))

    model = build_model(ncfg, device="cpu", seed=None)
    model.load_state_dict(new)


def test_nothing_new_changes_nothing():
    _, cfg, params, _, wd, _ = tiny_setup()
    pcfg = PortConfig.from_json(cfg.to_json())
    pwd = Dictionary.from_json(wd.to_json())
    old = params_from_jax(params, pcfg)
    new, ncfg, _, n = expand_dictionary(old, pcfg, pwd, [wd.tokens()[4:9]])
    assert n == 0 and new is old and ncfg is pcfg
    assert np.array_equal(pwd.tokens(), wd.tokens())
