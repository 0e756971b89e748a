"""Candidate-shortlist decoding: restrict the generator to a small
vocabulary subset per request batch (a copy of
``context_attentive_ir_tpu/decode/shortlist.py`` on the port's
``constants.py``).

The generator's cost is linear in V (the fused kernel streams the whole
``[E, V]`` table per step), so a shortlist of size C cuts that stream V/C
fold.

Construction (host-side, cheap): the union of
- the special ids (PAD/UNK/BOS/EOS must always be decodable),
- every token id appearing in the request batch's session queries and
  clicked documents (next queries overwhelmingly reuse session tokens),
- the globally most frequent tokens as fill.  ``build_dictionary`` adds
  words in ``Counter.most_common`` order, so *dictionary ids are already
  frequency-ranked* and the static top-F shortlist is simply the lowest
  F ids -- no separate frequency table needed.

The decode stays a full beam search; only the per-step softmax support
is restricted, so scores are log-probs over the shortlist (an
approximation -- the full-vocab logsumexp differs).  A shortlist covering
the whole vocabulary reproduces the exact decode.  The shortlist is
sorted ascending, so a tie inside it still goes to the lower vocab id.
"""

from __future__ import annotations

import numpy as np

from ..constants import BOS, EOS, PAD, UNK

__all__ = ["build_shortlist"]


def build_shortlist(size: int, vocab_size: int,
                    source_ids=None) -> np.ndarray:
    """int32 [size] sorted unique vocab ids: specials + source tokens +
    most-frequent fill (ids are frequency-ranked by construction).

    ``size`` clamps into [4, vocab_size] (the four specials are always
    decodable, so no smaller shortlist exists); if the source union
    alone exceeds ``size``, the highest (rarest) source ids are dropped
    -- specials and frequent tokens survive.  The returned length is
    exactly the clamped ``size``.
    """
    size = max(min(size, vocab_size), 4)
    take = np.zeros(vocab_size, bool)
    take[[PAD, UNK, BOS, EOS]] = True
    if source_ids is not None:
        ids = np.asarray(source_ids, np.int64).reshape(-1)
        ids = ids[(ids >= 0) & (ids < vocab_size)]
        take[ids] = True
    n = int(take.sum())
    if n < size:
        missing = np.flatnonzero(~take)
        take[missing[: size - n]] = True
    sel = np.flatnonzero(take)
    if len(sel) > size:
        # drop rarest non-special overflow (highest ids)
        sel = np.concatenate([sel[:4], sel[4:][: size - 4]])
    return sel.astype(np.int32)
