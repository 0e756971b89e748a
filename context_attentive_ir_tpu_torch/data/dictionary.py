"""Word and character dictionaries.

Parity target: the reference's ``Dictionary`` in ``neuroir/inputters/utils.py``
(SURVEY.md SS2.1, marker ``exp:``): word<->index maps built from the training
corpus, optional restriction to pretrained-embedding vocabulary, UNK handling
and case folding.

Design: a plain Python object used only on the host side of the input
pipeline.  Device code never sees strings -- only the integer id tensors the
vectorizer emits.  A copy of ``context_attentive_ir_tpu/data/dictionary.py``
(with its byte-level ``CharDictionary``), so the port reads the same
``to_json`` blobs.
"""

from __future__ import annotations

import json
import unicodedata
from collections import Counter
from typing import Iterable, Iterator

from ..constants import (
    BOS,
    BOS_WORD,
    EOS,
    EOS_WORD,
    PAD,
    PAD_WORD,
    SPECIAL_TOKENS,
    UNK,
    UNK_WORD,
)


def normalize(token: str, uncase: bool = True) -> str:
    token = unicodedata.normalize("NFD", token)
    return token.lower() if uncase else token


class Dictionary:
    """Bidirectional word <-> id map with PAD/UNK/BOS/EOS at fixed indices."""

    def __init__(self, uncase: bool = True):
        self.uncase = uncase
        self.tok2ind: dict[str, int] = {
            PAD_WORD: PAD,
            UNK_WORD: UNK,
            BOS_WORD: BOS,
            EOS_WORD: EOS,
        }
        self.ind2tok: dict[int, str] = {v: k for k, v in self.tok2ind.items()}

    def __len__(self) -> int:
        return len(self.tok2ind)

    def __contains__(self, key) -> bool:
        if isinstance(key, int):
            return key in self.ind2tok
        return normalize(key, self.uncase) in self.tok2ind

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.ind2tok.get(key, UNK_WORD)
        return self.tok2ind.get(normalize(key, self.uncase), UNK)

    def __iter__(self) -> Iterator[str]:
        return iter(self.tok2ind)

    def add(self, token: str) -> int:
        token = normalize(token, self.uncase)
        if token not in self.tok2ind:
            index = len(self.tok2ind)
            self.tok2ind[token] = index
            self.ind2tok[index] = token
        return self.tok2ind[token]

    def add_tokens(self, tokens: Iterable[str]) -> None:
        for tok in tokens:
            self.add(tok)

    def tokens(self) -> list[str]:
        """All non-special tokens."""
        return [t for t in self.tok2ind if t not in SPECIAL_TOKENS]

    def encode(self, tokens: Iterable[str]) -> list[int]:
        return [self[t] for t in tokens]

    def decode(self, ids: Iterable[int], stop_at_eos: bool = True) -> list[str]:
        out = []
        for i in ids:
            i = int(i)
            if stop_at_eos and i == EOS:
                break
            if i in (PAD, BOS):
                continue
            out.append(self.ind2tok.get(i, UNK_WORD))
        return out

    # -- persistence ---------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({"uncase": self.uncase, "tokens": list(self.tok2ind)})

    @classmethod
    def from_json(cls, blob: str) -> "Dictionary":
        data = json.loads(blob)
        d = cls(uncase=data["uncase"])
        for tok in data["tokens"]:
            if tok not in d.tok2ind:
                index = len(d.tok2ind)
                d.tok2ind[tok] = index
                d.ind2tok[index] = tok
        return d


def build_dictionary(
    token_streams: Iterable[Iterable[str]],
    uncase: bool = True,
    max_words: int | None = None,
    min_count: int = 1,
    restrict_vocab: set[str] | None = None,
) -> Dictionary:
    """Build a frequency-ordered dictionary from token streams.

    ``restrict_vocab`` mirrors the reference's ``--restrict_vocab`` flag:
    only keep words that appear in the pretrained embedding file.
    """
    counts: Counter[str] = Counter()
    for stream in token_streams:
        for tok in stream:
            counts[normalize(tok, uncase)] += 1
    d = Dictionary(uncase=uncase)
    kept = 0
    for tok, c in counts.most_common():
        if c < min_count:
            break
        if restrict_vocab is not None and tok not in restrict_vocab:
            continue
        if tok in SPECIAL_TOKENS:
            continue
        d.add(tok)
        kept += 1
        if max_words is not None and kept >= max_words:
            break
    return d


class CharDictionary:
    """Byte-level character vocabulary for the char-CNN word vectors
    (DSSM's ``use_charngram``): a word's UTF-8 bytes offset past the special
    ids, cut or padded with PAD to a fixed length.  Closed-world (no OOV
    characters), so shapes stay static."""

    def __init__(self):
        self.offset = len(SPECIAL_TOKENS)

    def __len__(self) -> int:
        return 256 + self.offset

    def encode_word(self, word: str, max_len: int) -> list[int]:
        ids = [b + self.offset for b in word.encode("utf-8")[:max_len]]
        return ids + [PAD] * (max_len - len(ids))
