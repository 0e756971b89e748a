"""Vocabulary expansion before fine-tuning on new data (port of
``context_attentive_ir_tpu/train/vocab_expand.py``): add a corpus's unseen
words to the dictionary and grow every vocabulary-sized parameter.

It works on the port's parameter dict (``model.state_dict()``, dotted
names) with the JAX shape rules, so its result equals the JAX result put
through ``convert.params_from_jax``.  The caller builds the model and the
train state again from the new config: the optimizer moments of the grown
rows start at zero.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..data.dictionary import Dictionary, normalize
from ..data.loader import load_embeddings


def expand_dictionary(
    params: dict[str, torch.Tensor],
    config: ModelConfig,
    word_dict: Dictionary,
    token_streams: Iterable[Iterable[str]],
    embedding_file: Optional[str] = None,
    seed: int = 1234,
) -> tuple[dict[str, torch.Tensor], ModelConfig, Dictionary, int]:
    """Grow the vocabulary with the unseen tokens of ``token_streams``.

    Returns (new params, new config, the same Dictionary grown in place,
    the number of words added).  An ``embedding`` table of the old
    vocabulary's rows gains the new rows, drawn from
    ``np.random.RandomState(seed)`` at scale 0.1 or taken from
    ``embedding_file``; a 2-D ``kernel`` of as many columns (an untied
    generator's projection) and a ``bias`` of as many entries gain zeros.
    """
    old_size = len(word_dict)
    for stream in token_streams:
        for tok in stream:
            word_dict.add(normalize(tok, word_dict.uncase))
    n_new = len(word_dict) - old_size
    if n_new == 0:
        return params, config, word_dict, 0

    rng = np.random.RandomState(seed)
    new_rows = rng.normal(scale=0.1,
                          size=(n_new, config.emsize)).astype(np.float32)
    if embedding_file:
        full, _ = load_embeddings(embedding_file, word_dict, config.emsize)
        new_rows = full[old_size:]

    out = {}
    for name, v in params.items():
        key = name.rsplit(".", 1)[-1]
        if key == "embedding" and v.shape[0] == old_size:
            rows = torch.from_numpy(np.ascontiguousarray(new_rows))
            out[name] = torch.cat([v, rows.to(v.device, v.dtype)], dim=0)
        elif key == "kernel" and v.dim() == 2 and v.shape[1] == old_size:
            out[name] = torch.cat([v, v.new_zeros(v.shape[0], n_new)], dim=1)
        elif key == "bias" and v.dim() == 1 and v.shape[0] == old_size:
            out[name] = torch.cat([v, v.new_zeros(n_new)])
        else:
            out[name] = v
    return out, config.replace(vocab_size=len(word_dict)), word_dict, n_new
