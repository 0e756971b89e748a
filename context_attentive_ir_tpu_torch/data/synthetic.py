"""Synthetic AOL-like fixture generator.

Real AOL logs are not redistributable and not present on this machine
(SURVEY.md SS7 step 1), so this module generates structurally identical
session data: sessions of related queries, each query with a candidate slate
in which topically matching documents carry the click label.  Every model in
the zoo must be able to overfit a small fixture generated here (the
"overfit gate" test strategy, SURVEY.md SS4).

The generator plants learnable structure:
- a topic vocabulary; queries in a session share a topic,
- clicked documents share >=2 tokens with their query; distractors are drawn
  from other topics,
- the next query in a session extends the previous one (so suggestion models
  have signal).

A copy of ``context_attentive_ir_tpu/data/synthetic.py`` (no JAX in it), kept so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TOPICS = [
    "jazz guitar chord lesson music theory scales improvisation swing bebop",
    "hiking boots trail mountain gear backpack waterproof alpine summit ridge",
    "pasta recipe tomato basil garlic olive oil italian sauce dinner cooking",
    "python numpy array tutorial machine learning code gradient tensor model",
    "toyota engine repair brake manual transmission oil filter garage mechanic",
    "beach resort hotel vacation island snorkel sunset tropical flight booking",
    "stock market index fund dividend portfolio invest retirement bond yield",
    "soccer league final score goal striker coach transfer stadium champions",
]


def _word(rng: np.random.RandomState, topic_words: list[str]) -> str:
    return topic_words[rng.randint(len(topic_words))]


def generate_sessions(
    n_sessions: int = 50,
    min_turns: int = 2,
    max_turns: int = 4,
    n_candidates: int = 10,
    seed: int = 0,
) -> list[dict]:
    rng = np.random.RandomState(seed)
    topics = [t.split() for t in TOPICS]
    sessions = []
    for s in range(n_sessions):
        topic = topics[rng.randint(len(topics))]
        n_turns = rng.randint(min_turns, max_turns + 1)
        base = [_word(rng, topic) for _ in range(2)]
        queries = []
        for t in range(n_turns):
            # next query refines the previous one: keep a prefix, add a word
            q_tokens = base[: 2 + t] if len(base) >= 2 + t else base
            if t > 0:
                base = base + [_word(rng, topic)]
                q_tokens = base[: 2 + t]
            n_clicked = 1 + int(rng.rand() < 0.2)
            cands = []
            click_pos = rng.permutation(n_candidates)[:n_clicked]
            for c in range(n_candidates):
                if c in click_pos:
                    doc_tokens = list(q_tokens) + [
                        _word(rng, topic) for _ in range(rng.randint(1, 4))
                    ]
                    label = 1
                else:
                    other = topics[rng.randint(len(topics))]
                    doc_tokens = [_word(rng, other) for _ in range(rng.randint(3, 7))]
                    label = 0
                cands.append(
                    {"id": f"d{s}_{t}_{c}", "title": " ".join(doc_tokens),
                     "label": label}
                )
            queries.append(
                {"id": f"q{s}_{t}", "text": " ".join(q_tokens), "candidates": cands}
            )
        sessions.append({"session_id": f"s{s}", "query": queries})
    return sessions


def write_fixture(path: str | Path, **kwargs) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for sess in generate_sessions(**kwargs):
            f.write(json.dumps(sess) + "\n")
    return path


def write_glove_fixture(path: str | Path, dim: int = 32, seed: int = 1,
                        vocab: list[str] | None = None) -> Path:
    """A tiny GloVe-format file over the synthetic vocabulary.

    ``vocab=None`` covers the topic-overlap corpus; pass
    ``ambiguous_vocab()`` (or a union) for the discriminative corpus.
    """
    rng = np.random.RandomState(seed)
    if vocab is None:
        vocab = sorted({w for t in TOPICS for w in t.split()})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for w in vocab:
            vec = rng.normal(size=(dim,)).astype(np.float32)
            f.write(w + " " + " ".join(f"{v:.5f}" for v in vec) + "\n")
    return path


# ---------------------------------------------------------------------------
# Discriminative ("ambiguous") corpus
# ---------------------------------------------------------------------------
#
# The topic-overlap corpus above is solvable by word overlap alone: the
# first RESULTS showed untrained ESM within 0.01 MAP of CARS, so it proves
# the pipeline, not the model.  This
# second corpus is built so the clicked document is *conditionally*
# relevant: it can only be identified from session history, never from the
# current query alone.  It falsifies the paper's central claim (session
# context improves ranking/suggestion, arXiv:1906.02329; SURVEY.md SS2.6).
#
# Construction, per word group k:
#   AMB_k    -- 9 "ambiguous" words arranged into two query chains that
#               share a 3-word middle segment:
#                 chain_x = px m0 m1 m2 sx0 sx1
#                 chain_y = py m0 m1 m2 sy0 sy1
#   SENSE_kA / SENSE_kB -- disjoint sense vocabularies (documents only).
#
# A session draws (group k, sense s, chain c, key mode) and walks the
# chain with 2-word sliding-window queries.  Every turn's slate holds:
#   1 clicked doc    = query's ambiguous tokens + words from SENSE_s
#   3 confuser docs  = the SAME query tokens    + words from SENSE_s'
#   distractors      = random words from other groups.
# Clicked and confusers overlap the query IDENTICALLY, and senses are
# exactly balanced per group, so a session-blind ranker cannot beat the
# random-tie ceiling (expected AP ~= 0.52 with 3 confusers) on ambiguous
# turns.  The sense is revealed by session history only:
#   query-keyed mode -- turn 0's query carries one SENSE_s word
#                       (query-flow models can disambiguate later turns);
#   click-keyed mode -- every query is ambiguous; only turn 0's *click*
#                       reveals the sense (click-flow models only, i.e.
#                       CARS but not M-NSRF).
# Suggestion targets also need context: the next window after the shared
# middle (m1,m2) is (m2,sx0) or (m2,sy0) depending on the chain, which
# only turn 0's query reveals.
#
# Ideal MAPs (4-turn sessions, half of each mode): session-blind ~= 0.58,
# query-flow-aware ~= 0.76, click-flow-aware ~= 0.94 -- the paper's
# qualitative ladder (blind < M-NSRF < CARS), now falsifiable.

N_GROUPS = 6
N_SENSE_WORDS = 6
N_CONFUSERS = 3
_MIDDLE = 3  # shared-middle length; chains are 1 + _MIDDLE + 2 words long


def _group_vocab(k: int) -> dict:
    amb = [f"g{k}amb{i}" for i in range(9)]
    return {
        "chain_x": [amb[0], amb[2], amb[3], amb[4], amb[5], amb[6]],
        "chain_y": [amb[1], amb[2], amb[3], amb[4], amb[7], amb[8]],
        "amb": amb,
        "sense": {
            "a": [f"g{k}sa{i}" for i in range(N_SENSE_WORDS)],
            "b": [f"g{k}sb{i}" for i in range(N_SENSE_WORDS)],
        },
    }


def ambiguous_vocab(n_groups: int = N_GROUPS) -> list[str]:
    """All words of the discriminative corpus (for GloVe fixtures)."""
    out: list[str] = []
    for k in range(n_groups):
        g = _group_vocab(k)
        out.extend(g["amb"])
        out.extend(g["sense"]["a"])
        out.extend(g["sense"]["b"])
    return out


def generate_ambiguous_sessions(
    n_sessions: int = 64,
    n_candidates: int = 10,
    n_groups: int = N_GROUPS,
    min_turns: int = 4,
    max_turns: int = 5,
    modes: tuple[str, ...] = ("query", "click"),
    seed: int = 0,
) -> list[dict]:
    """Sessions where the click is decidable only from session history.

    ``modes`` restricts the key modes generated (("query",) gives a corpus
    learnable by any session-aware model; ("click",) requires click-flow).
    Senses/groups/chains/modes are enumerated round-robin so the corpus is
    exactly balanced and a blind model cannot exploit priors.
    """
    rng = np.random.RandomState(seed)
    groups = [_group_vocab(k) for k in range(n_groups)]
    combos = [(k, s, c, m)
              for k in range(n_groups)
              for s in ("a", "b")
              for c in ("chain_x", "chain_y")
              for m in modes]
    sessions = []
    for i in range(n_sessions):
        k, sense, chain_name, mode = combos[i % len(combos)]
        g = groups[k]
        chain = g[chain_name]
        own = g["sense"][sense]
        other = g["sense"]["b" if sense == "a" else "a"]
        n_turns = int(rng.randint(min_turns, max_turns + 1))
        n_turns = min(n_turns, len(chain) - 1)
        queries = []
        for t in range(n_turns):
            amb_tokens = [chain[t], chain[t + 1]]
            q_tokens = list(amb_tokens)
            if mode == "query" and t == 0:
                q_tokens.append(own[rng.randint(len(own))])
            # clicked doc: full query tokens + fresh own-sense words
            own_rest = [w for w in own if w not in q_tokens]
            clicked = q_tokens + list(
                rng.choice(own_rest, size=2, replace=False))
            cands = [(clicked, 1)]
            # confusers: the ambiguous tokens + other-sense words (same
            # overlap with the query as the clicked doc on ambiguous turns)
            for _ in range(N_CONFUSERS):
                conf = amb_tokens + list(
                    rng.choice(other, size=2, replace=False))
                cands.append((conf, 0))
            # distractors: words from other groups
            for _ in range(n_candidates - 1 - N_CONFUSERS):
                ok = int(rng.randint(n_groups - 1))
                ok = ok if ok < k else ok + 1
                og = groups[ok]
                pool = og["amb"] + og["sense"]["a"] + og["sense"]["b"]
                d = list(rng.choice(pool, size=4, replace=False))
                cands.append((d, 0))
            order = rng.permutation(len(cands))
            queries.append({
                "id": f"q{i}_{t}",
                "text": " ".join(q_tokens),
                "candidates": [
                    {"id": f"d{i}_{t}_{j}",
                     "title": " ".join(cands[j][0]),
                     "label": cands[j][1]}
                    for j in order
                ],
            })
        sessions.append({"session_id": f"as{i}", "query": queries})
    return sessions


def write_ambiguous_fixture(path: str | Path, **kwargs) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for sess in generate_ambiguous_sessions(**kwargs):
            f.write(json.dumps(sess) + "\n")
    return path


# ---------------------------------------------------------------------------
# Suggestion-discriminative ("long-chain") corpus
# ---------------------------------------------------------------------------
#
# The 2-word-window corpus above makes RANKING falsifiable but degenerates
# for the suggestion head: targets are 2 tokens (BLEU-4 undefined) and only
# one token per session is history-dependent, so every generator printed
# 1.000/0.000 in the RESULTS of that corpus.  This corpus
# extends the chains so suggestion itself separates history-aware from
# history-blind generators:
#
#   chain_x = px m0..m6 x0..x5       (14 words; 7-word shared middle)
#   chain_y = py m0..m6 y0..y5
#
# Queries are 5-token windows sliding by 3:
#   w0 = p  m0 m1 m2 m3   -- reveals the chain (prefix token)
#   w1 = m2 m3 m4 m5 m6   -- fully inside the shared middle: AMBIGUOUS
#   w2 = m5 m6 s0 s1 s2   -- the crossing: 3 chain-dependent tokens
#   w3 = s1 s2 s3 s4 s5   -- chain-specific suffix
#
# Every target is 5 tokens (=> 2 valid 4-grams each; corpus BLEU-4 is
# meaningful).  The target of the ambiguous turn w1 is w2, whose last 3
# tokens -- and BOTH 4-grams -- depend on which chain the session walks,
# revealed only by turn 0's prefix: a generator that sees only the current
# query is capped at corpus BLEU-4 ~= (predictable 4-grams)/(total) ~= 0.5
# (3-turn sessions) to 0.67 (4-turn), while a history-reading generator can
# reach ~1.0.  Ranking keeps the sense construction of the ambiguous corpus
# (clicked = query tokens + own-sense words, confusers identical overlap
# with other-sense words), so multitask models still train both heads.
# Parity anchor: corpus BLEU-1..4 suggestion evaluation, SURVEY.md SS2.8 /
# SS3.4.

N_MIDDLE = 7
N_SUFFIX = 6
SUGGEST_WINDOW = 5
SUGGEST_STEP = 3


def _group_vocab_long(k: int) -> dict:
    mid = [f"g{k}m{i}" for i in range(N_MIDDLE)]
    return {
        "chain_x": [f"g{k}px"] + mid + [f"g{k}x{i}" for i in range(N_SUFFIX)],
        "chain_y": [f"g{k}py"] + mid + [f"g{k}y{i}" for i in range(N_SUFFIX)],
        "sense": {
            "a": [f"g{k}sa{i}" for i in range(N_SENSE_WORDS)],
            "b": [f"g{k}sb{i}" for i in range(N_SENSE_WORDS)],
        },
    }


def suggestion_vocab(n_groups: int = N_GROUPS) -> list[str]:
    """All words of the long-chain corpus (for GloVe fixtures)."""
    out: list[str] = []
    for k in range(n_groups):
        g = _group_vocab_long(k)
        for w in g["chain_x"] + g["chain_y"]:
            if w not in out:
                out.append(w)
        out.extend(g["sense"]["a"])
        out.extend(g["sense"]["b"])
    return out


def chain_windows(chain: list[str], window: int = SUGGEST_WINDOW,
                  step: int = SUGGEST_STEP) -> list[list[str]]:
    """The query sequence a session walks along ``chain``."""
    out = []
    for start in range(0, len(chain) - window + 1, step):
        out.append(chain[start:start + window])
    return out


def generate_suggestion_sessions(
    n_sessions: int = 64,
    n_candidates: int = 10,
    n_groups: int = N_GROUPS,
    min_turns: int = 3,
    max_turns: int = 4,
    modes: tuple[str, ...] = ("query", "click"),
    seed: int = 0,
) -> list[dict]:
    """Sessions whose NEXT-QUERY is decidable only from session history.

    Same enumeration discipline as ``generate_ambiguous_sessions`` (groups,
    senses, chains, modes round-robin -> exactly balanced, no blind
    prior).  Ranking slates follow the sense construction; the query walk
    follows the long chains above.
    """
    rng = np.random.RandomState(seed)
    groups = [_group_vocab_long(k) for k in range(n_groups)]
    combos = [(k, s, c, m)
              for k in range(n_groups)
              for s in ("a", "b")
              for c in ("chain_x", "chain_y")
              for m in modes]
    sessions = []
    for i in range(n_sessions):
        k, sense, chain_name, mode = combos[i % len(combos)]
        g = groups[k]
        windows = chain_windows(g[chain_name])
        own = g["sense"][sense]
        other = g["sense"]["b" if sense == "a" else "a"]
        n_turns = int(rng.randint(min_turns, max_turns + 1))
        n_turns = min(n_turns, len(windows))
        queries = []
        for t in range(n_turns):
            q_tokens = list(windows[t])
            if mode == "query" and t == 0:
                q_tokens.append(own[rng.randint(len(own))])
            own_rest = [w for w in own if w not in q_tokens]
            clicked = q_tokens + list(
                rng.choice(own_rest, size=2, replace=False))
            cands = [(clicked, 1)]
            for _ in range(N_CONFUSERS):
                conf = list(windows[t]) + list(
                    rng.choice(other, size=2, replace=False))
                cands.append((conf, 0))
            for _ in range(n_candidates - 1 - N_CONFUSERS):
                ok = int(rng.randint(n_groups - 1))
                ok = ok if ok < k else ok + 1
                og = groups[ok]
                pool = og["chain_x"] + og["chain_y"][-N_SUFFIX:] \
                    + og["sense"]["a"] + og["sense"]["b"]
                d = list(rng.choice(pool, size=4, replace=False))
                cands.append((d, 0))
            order = rng.permutation(len(cands))
            queries.append({
                "id": f"q{i}_{t}",
                "text": " ".join(q_tokens),
                "candidates": [
                    {"id": f"d{i}_{t}_{j}",
                     "title": " ".join(cands[j][0]),
                     "label": cands[j][1]}
                    for j in order
                ],
            })
        sessions.append({"session_id": f"ls{i}", "query": queries})
    return sessions


def write_suggestion_fixture(path: str | Path, **kwargs) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for sess in generate_suggestion_sessions(**kwargs):
            f.write(json.dumps(sess) + "\n")
    return path


# ---------------------------------------------------------------------------
# Click-keyed suggestion corpus
# ---------------------------------------------------------------------------
#
# On the long-chain corpus above, every history-READING generator saturates
# at BLEU-4 = 1.0 because the chain is revealed by turn 0's QUERY prefix --
# even a doc-blind seq2seq-with-history reads it, so CARS's click-flow
# contributes nothing measurable to its generative head.  This corpus
# moves the chain key into turn 0's CLICKED DOCUMENT:
#
#   middle  m0..m7          -- shared by both chains (8 words)
#   chain_x = m0..m7 x0..x4    chain_y = m0..m7 y0..y4     (13 words)
#
# Queries are the same 5-token/step-3 windows:
#   w0 = m0 m1 m2 m3 m4    w1 = m3 m4 m5 m6 m7    w2 = m6 m7 s0 s1 s2
#
# w0 and w1 are IDENTICAL across chains (pure middle), so no query -- and
# hence no query history -- reveals the chain before the crossing.  The
# session's LAST query is the crossing window w2, used only as a target.
# Turn 0's clicked doc carries 2 own-chain suffix words (its confusers
# carry 2 other-chain words: identical query overlap, identical length);
# every later turn follows the click-mode sense construction (clicked =
# query + own-sense, confusers = query + other-sense -- ranking stays
# solvable only via turn-0's click, as in the ambiguous corpus's click
# mode).  Consequences, enforced by tests/test_discriminative.py:
#
# - a doc-blind generator (seq2seq / HRED-QS / ACG over queries) is
#   structurally capped: both 4-grams of the crossing target are a coin
#   flip (optimal blind corpus BLEU-4 ~= 0.72 at the default T in {2,3}
#   mix; exact oracle computed in-test);
# - a click-reading generator (CARS: clicked-doc repr -> click-flow ->
#   context attention -> decoder init) can reach ~1.0.  M-NSRF cannot:
#   its decoder conditions on the query-flow session state only
#   (models/multitask/mnsrf.py), so it sits at the blind ceiling --
#   making CARS-beats-M-NSRF falsifiable on suggestion, the paper's
#   ordering (SURVEY.md SS2.6, BASELINE.md).
#
# Session shapes: T=3 walks (w0, w1, w2) -- the hard target w2 sits at
# turn 1 and needs turn 0's click through the session RECURRENCE/attention
# memory; T=2 walks (w1, w2) -- the hard target sits at turn 0 and needs
# the INCLUSIVE click state of the current turn.  Both pathways of the
# suggestion head's click plumbing are exercised.

N_MIDDLE_CK = 8
N_SUFFIX_CK = 5


def _group_vocab_click(k: int) -> dict:
    mid = [f"g{k}m{i}" for i in range(N_MIDDLE_CK)]
    return {
        "middle": mid,
        "chain_x": mid + [f"g{k}x{i}" for i in range(N_SUFFIX_CK)],
        "chain_y": mid + [f"g{k}y{i}" for i in range(N_SUFFIX_CK)],
        "sense": {
            "a": [f"g{k}sa{i}" for i in range(N_SENSE_WORDS)],
            "b": [f"g{k}sb{i}" for i in range(N_SENSE_WORDS)],
        },
    }


def click_suggestion_vocab(n_groups: int = N_GROUPS) -> list[str]:
    """All words of the click-keyed corpus (for GloVe fixtures)."""
    out: list[str] = []
    for k in range(n_groups):
        g = _group_vocab_click(k)
        for w in g["chain_x"] + g["chain_y"]:
            if w not in out:
                out.append(w)
        out.extend(g["sense"]["a"])
        out.extend(g["sense"]["b"])
    return out


def generate_click_keyed_suggestion_sessions(
    n_sessions: int = 64,
    n_candidates: int = 10,
    n_groups: int = N_GROUPS,
    turn_counts: tuple[int, ...] = (2, 3),
    seed: int = 0,
) -> list[dict]:
    """Sessions whose NEXT-QUERY is decidable only from turn 0's CLICK.

    Same enumeration discipline as the other discriminative corpora:
    (group, sense, chain, session length) round-robin -> exactly balanced,
    no blind prior.
    """
    rng = np.random.RandomState(seed)
    groups = [_group_vocab_click(k) for k in range(n_groups)]
    combos = [(k, s, c, t)
              for k in range(n_groups)
              for s in ("a", "b")
              for c in ("chain_x", "chain_y")
              for t in turn_counts]
    sessions = []
    for i in range(n_sessions):
        k, sense, chain_name, n_turns = combos[i % len(combos)]
        g = groups[k]
        windows = chain_windows(g[chain_name])       # [w0, w1, w2]
        walk = windows[-n_turns:]                    # end at the crossing
        own = g["sense"][sense]
        other = g["sense"]["b" if sense == "a" else "a"]
        own_chain = g[chain_name][N_MIDDLE_CK:]
        other_name = "chain_y" if chain_name == "chain_x" else "chain_x"
        other_chain = g[other_name][N_MIDDLE_CK:]
        queries = []
        for t, q_tokens in enumerate(walk):
            q_tokens = list(q_tokens)
            own_rest = [w for w in own if w not in q_tokens]
            clicked = q_tokens + list(
                rng.choice(own_rest, size=2, replace=False))
            confuser_extra = [list(rng.choice(other, size=2, replace=False))
                              for _ in range(N_CONFUSERS)]
            if t == 0:
                # the chain key lives ONLY here: clicked doc carries
                # own-chain suffix words, confusers other-chain words
                # (identical query overlap and length either way)
                clicked = clicked + list(
                    rng.choice(own_chain, size=2, replace=False))
                confuser_extra = [ce + list(
                    rng.choice(other_chain, size=2, replace=False))
                    for ce in confuser_extra]
            cands = [(clicked, 1)]
            for ce in confuser_extra:
                cands.append((list(q_tokens) + ce, 0))
            for _ in range(n_candidates - 1 - N_CONFUSERS):
                ok = int(rng.randint(n_groups - 1))
                ok = ok if ok < k else ok + 1
                og = groups[ok]
                pool = (og["chain_x"] + og["chain_y"][-N_SUFFIX_CK:]
                        + og["sense"]["a"] + og["sense"]["b"])
                d = list(rng.choice(pool, size=4, replace=False))
                cands.append((d, 0))
            order = rng.permutation(len(cands))
            queries.append({
                "id": f"q{i}_{t}",
                "text": " ".join(q_tokens),
                "candidates": [
                    {"id": f"d{i}_{t}_{j}",
                     "title": " ".join(cands[j][0]),
                     "label": cands[j][1]}
                    for j in order
                ],
            })
        sessions.append({"session_id": f"cs{i}", "query": queries})
    return sessions


def write_click_keyed_suggestion_fixture(path: str | Path,
                                         **kwargs) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for sess in generate_click_keyed_suggestion_sessions(**kwargs):
            f.write(json.dumps(sess) + "\n")
    return path


# ---------------------------------------------------------------------------
# AOL-scale rehearsal corpus
# ---------------------------------------------------------------------------
# Same planted structure as the topic corpus above, but at real-AOL scale
# knobs: ~100k vocab, sessions up to 10 turns, slate 50, >=10k sessions.
# This is the dress rehearsal for the day the real AOL splits appear
# (SURVEY.md SS6 / SS7 hard part (a)): it exercises the HOST pipeline
# (streaming read, fastvec vectorization, bucketing) and the 100k-row
# tied-embedding generator at production shapes, not oracle separation.
# Tokens are "t<i>w<j>" so vocab size is exactly n_topics*words_per_topic.


def generate_aol_scale_sessions(
    n_sessions: int = 10_000,
    n_topics: int = 2_500,
    words_per_topic: int = 40,
    min_turns: int = 1,
    max_turns: int = 10,
    n_candidates: int = 50,
    seed: int = 0,
):
    """Yields sessions (a generator -- 10k sessions x 50-doc slates is
    ~2.7M documents; callers stream to disk rather than hold the list)."""
    rng = np.random.RandomState(seed)
    for s in range(n_sessions):
        topic = int(rng.randint(n_topics))
        n_turns = int(rng.randint(min_turns, max_turns + 1))
        # one vectorized draw per session covers every topic-word slot:
        # queries extend a growing base (suggestion signal), clicked docs
        # extend their query (rank signal), distractors come from other
        # topics drawn in one batch below
        base = rng.randint(words_per_topic, size=2 + max_turns + 1)
        queries = []
        for t in range(n_turns):
            q_ids = base[: 2 + t]
            q_tokens = [f"t{topic}w{w}" for w in q_ids]
            n_clicked = 1 + int(rng.rand() < 0.2)
            click_pos = set(rng.permutation(n_candidates)[:n_clicked]
                            .tolist())
            d_topics = rng.randint(n_topics, size=(n_candidates, 7))
            d_words = rng.randint(words_per_topic, size=(n_candidates, 7))
            d_lens = rng.randint(3, 8, size=n_candidates)
            extra = rng.randint(1, 4, size=n_candidates)
            cands = []
            for c in range(n_candidates):
                if c in click_pos:
                    doc = q_tokens + [f"t{topic}w{w}"
                                      for w in d_words[c, : extra[c]]]
                    label = 1
                else:
                    doc = [f"t{tt}w{w}" for tt, w in
                           zip(d_topics[c, : d_lens[c]],
                               d_words[c, : d_lens[c]])]
                    label = 0
                cands.append({"id": f"d{s}_{t}_{c}",
                              "title": " ".join(doc), "label": label})
            queries.append({"id": f"q{s}_{t}", "text": " ".join(q_tokens),
                            "candidates": cands})
        yield {"session_id": f"s{s}", "query": queries}


def aol_scale_vocab(n_topics: int = 2_500,
                    words_per_topic: int = 40) -> list[str]:
    return [f"t{t}w{w}" for t in range(n_topics)
            for w in range(words_per_topic)]


def write_aol_scale_fixture(path: str | Path, **kwargs) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for sess in generate_aol_scale_sessions(**kwargs):
            f.write(json.dumps(sess) + "\n")
    return path
