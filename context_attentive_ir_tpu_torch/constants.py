"""Special tokens and default shape limits.

Parity target: the reference's ``neuroir/inputters/constants.py`` (SURVEY.md
SS2.1 -- reference mount was empty at build time, so the citation is to the
survey's expected layout, marker ``exp:``), which defines PAD/UNK/BOS/EOS
special tokens with fixed low indices.

A copy of ``context_attentive_ir_tpu/constants.py``: the port pads every
batch to the same static ``MAX_*`` targets (``data/vectorize.py``), so both
packages see identical id tensors.
"""

PAD = 0
UNK = 1
BOS = 2
EOS = 3

PAD_WORD = "<blank>"
UNK_WORD = "<unk>"
BOS_WORD = "<s>"
EOS_WORD = "</s>"

SPECIAL_TOKENS = (PAD_WORD, UNK_WORD, BOS_WORD, EOS_WORD)

# Static shape defaults (AOL-scale; see SURVEY.md SS5.7: queries are short,
# documents are titles, "context" is <= ~10 session turns).
MAX_QUERY_LEN = 15
MAX_DOC_LEN = 30
MAX_SESSION_LEN = 10
NUM_CANDIDATES = 50

# Character-level defaults (word hashing / char-CNN analogue, SURVEY.md SS2.3).
MAX_WORD_LEN = 16
# 256 byte values + the 4 special ids (= len(CharDictionary()));
# the single source of truth for char-table sizing (DSSM CharCNN)
CHAR_VOCAB_SIZE = 256 + len(SPECIAL_TOKENS)
