"""Data preparation (port of ``context_attentive_ir_tpu/cli/prepare_data.py``;
its subcommands, flags and defaults, and byte-identical output files):

- ``synthetic``: the synthetic corpus (train / dev / test splits and a toy
  GloVe file) for development and tests;
- ``convert``: a TSV click log into the JSON-lines session format
  (``data/loader.py``);
- ``bm25``: the AOL preparation's slate step -- each query's top-N titles
  by BM25 over a title corpus (``data/bm25.py``, the native scorer where
  it builds), from a click log that holds only the clicked titles.

    python -m context_attentive_ir_tpu_torch.cli.prepare_data bm25 \
        --log clicks.tsv --corpus_file titles.txt --output train.jsonl

``main`` returns what ``convert`` (its session count) and ``bm25`` (its
counts and whether the native scorer ran) report.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..data import (
    ambiguous_vocab,
    write_ambiguous_fixture,
    write_fixture,
    write_glove_fixture,
)


def cmd_synthetic(args) -> None:
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    splits = {"train": (args.n_train, 0), "dev": (args.n_dev, 1),
              "test": (args.n_test, 2)}
    writer = (write_ambiguous_fixture if args.corpus == "ambiguous"
              else write_fixture)
    for name, (n, seed) in splits.items():
        path = writer(out / f"{name}.jsonl", n_sessions=n,
                      n_candidates=args.num_candidates, seed=seed)
        print(f"wrote {path} ({n} sessions)")
    vocab = ambiguous_vocab() if args.corpus == "ambiguous" else None
    glove = write_glove_fixture(out / "glove.txt", dim=args.glove_dim,
                                vocab=vocab)
    print(f"wrote {glove}")


def cmd_convert(args) -> dict:
    """TSV rows: session_id <tab> query <tab> doc_title <tab> clicked."""
    sessions: dict[str, dict] = {}
    with open(args.input) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 4:
                continue
            sid, query, title, clicked = parts[:4]
            sess = sessions.setdefault(sid, {"session_id": sid, "query": []})
            if not sess["query"] or sess["query"][-1]["text"] != query:
                sess["query"].append({"id": f"{sid}_{len(sess['query'])}",
                                      "text": query, "candidates": []})
            cands = sess["query"][-1]["candidates"]
            cands.append({"id": f"d{len(cands)}", "title": title,
                          "label": int(clicked)})
    with open(args.output, "w") as f:
        for sess in sessions.values():
            f.write(json.dumps(sess) + "\n")
    print(f"wrote {args.output} ({len(sessions)} sessions)")
    return {"sessions": len(sessions)}


def read_click_log(path):
    """TSV rows: session_id <tab> query <tab> clicked_title.

    CONSECUTIVE rows repeating a session's query add clicks to the same
    turn (the AOL convention: one row per click of the same issue); a
    re-issue of an earlier query after other turns starts a NEW turn --
    that is a real session event, not a continuation.  Query turns keep
    file order within a session.  Returns
    ``[(sid, [(query, [clicked titles])])]`` in first-seen session order.
    """
    sessions: dict[str, list] = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            sid, query, clicked = parts[0], parts[1], parts[2]
            turns = sessions.setdefault(sid, [])
            if not turns or turns[-1][0] != query:
                turns.append((query, []))
            if clicked:
                turns[-1][1].append(clicked)
    return list(sessions.items())


def cmd_bm25(args) -> dict:
    """Build BM25 top-N candidate slates from a raw click log.

    The AOL preparation's step: candidate pool =
    the title corpus (``--corpus_file``: one title per line, or the
    distinct clicked titles in the log when omitted); per query turn the
    slate is BM25 top-``--num_candidates``; clicked titles are labeled 1.
    A clicked title missing from the top-N is handled per
    ``--on_missing_click``: ``append`` replaces the slate tail with it
    (default; every turn keeps its positive, the reference's usable-data
    convention), ``drop`` discards the turn, ``keep`` leaves the slate
    all-negative (rank metrics then score it as a miss).
    """
    from ..data.bm25 import BM25Index
    from ..data.dictionary import normalize

    def title_key(text: str) -> str:
        # the same NFD+casefold normalization BM25 tokenization applies
        # (data/bm25.py:_tokenize): a click differing from its corpus
        # title only by case/unicode form must still be labeled 1
        return " ".join(normalize(t, True) for t in text.split())

    log = read_click_log(args.log)
    if args.corpus_file:
        with open(args.corpus_file) as f:
            raw = [t.rstrip("\n") for t in f]
        raw = [t for t in raw if t.strip()]
        # dedupe, keeping first occurrence: with duplicates, BM25 ties
        # break to the LOWER doc index while title_ix would map the text
        # to the LAST index, so a click on a duplicated title would be
        # labeled 0 on the retrieved copy and 'append' could then insert
        # the same text twice with conflicting labels
        seen: dict[str, None] = {}
        for t in raw:
            seen.setdefault(t, None)
        titles = list(seen)
        if len(titles) < len(raw):
            print(f"note: {len(raw) - len(titles)} duplicate corpus "
                  "titles collapsed (first occurrence kept)")
    else:
        seen = {}
        for _, turns in log:
            for _, clicks in turns:
                for c in clicks:
                    seen.setdefault(c, None)
        titles = list(seen)
    # exact-title index first (a click that IS a corpus title must label
    # that exact document, even when the corpus also holds a case/unicode
    # variant of it); normalized index as the fallback so clicks
    # differing only by case/unicode form still resolve
    exact_ix = {t: i for i, t in reversed(list(enumerate(titles)))}
    norm_ix: dict[str, int] = {}
    for i, t in enumerate(titles):
        norm_ix.setdefault(title_key(t), i)

    def lookup_click(c: str) -> int | None:
        hit = exact_ix.get(c)
        return norm_ix.get(title_key(c)) if hit is None else hit

    index = BM25Index(titles, use_native=not args.no_native)
    n_turns = n_dropped = n_appended = n_overflow = n_unmatched = 0
    with open(args.output, "w") as f:
        for sid, turns in log:
            queries = []
            for turn_no, (query, clicks) in enumerate(turns):
                n_turns += 1
                idx, _scores = index.search(query, args.num_candidates)
                slate = [int(i) for i in idx]
                hits = {c: lookup_click(c) for c in set(clicks)}
                unmatched = {c for c, i in hits.items() if i is None}
                n_unmatched += len(unmatched)
                clicked_ids = {i for i in hits.values() if i is not None}
                missing = clicked_ids - set(slate)
                if (missing or unmatched) \
                        and args.on_missing_click == "drop":
                    # a click absent from the corpus can never be kept:
                    # under 'drop' the turn goes too, same as a click the
                    # slate cannot hold
                    n_dropped += 1
                    continue
                if missing:
                    if args.on_missing_click == "append":
                        # replace the slate tail (lowest-scored docs that
                        # are not themselves clicked) with the positives
                        n_appended += 1
                        tail = [d for d in reversed(slate)
                                if d not in clicked_ids][:len(missing)]
                        if len(tail) < len(missing):
                            # more missing positives than replaceable
                            # slots (distinct clicks ~ slate size): the
                            # overflow cannot be kept -- count it loudly
                            # rather than silently breaking the 'every
                            # turn keeps its positives' guarantee
                            n_overflow += len(missing) - len(tail)
                        for d, m in zip(tail, sorted(missing)):
                            slate[slate.index(d)] = m
                # number by the turn's original position in the session
                # (stable under 'drop'), not by surviving-queries count
                qid = f"{sid}_{turn_no}"
                queries.append({
                    "id": qid, "text": query,
                    "candidates": [
                        {"id": f"t{d}", "title": titles[d],
                         "label": int(d in clicked_ids)} for d in slate]})
            if queries:
                f.write(json.dumps(
                    {"session_id": sid, "query": queries}) + "\n")
    print(f"wrote {args.output}: {len(log)} sessions, {n_turns} turns "
          f"({n_appended} click-appended, {n_dropped} dropped), "
          f"corpus {len(titles)} titles")
    if n_overflow:
        print(f"WARNING: {n_overflow} clicked positives could not fit "
              f"their turn's slate (more distinct clicks than "
              f"replaceable slots at --num_candidates="
              f"{args.num_candidates}); they were left out")
    if n_unmatched:
        print(f"WARNING: {n_unmatched} clicked titles were not in the "
              f"corpus (after normalization) and could not be labeled; "
              f"their turns were "
              f"{'dropped' if args.on_missing_click == 'drop' else 'kept without that positive'}")
    return {"sessions": len(log), "turns": n_turns, "appended": n_appended,
            "dropped": n_dropped, "overflow": n_overflow,
            "unmatched": n_unmatched, "titles": len(titles),
            "native": index.native}


def main(argv=None) -> dict | None:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    syn = sub.add_parser("synthetic")
    syn.add_argument("--corpus", choices=("topic", "ambiguous"),
                     default="topic",
                     help="topic: overlap-solvable; ambiguous: clicks "
                          "decidable only from session history")
    syn.add_argument("--out_dir", default="data/synthetic")
    syn.add_argument("--n_train", type=int, default=2000)
    syn.add_argument("--n_dev", type=int, default=200)
    syn.add_argument("--n_test", type=int, default=200)
    syn.add_argument("--num_candidates", type=int, default=50)
    syn.add_argument("--glove_dim", type=int, default=300)
    syn.set_defaults(fn=cmd_synthetic)
    conv = sub.add_parser("convert")
    conv.add_argument("--input", required=True)
    conv.add_argument("--output", required=True)
    conv.set_defaults(fn=cmd_convert)
    bm = sub.add_parser("bm25", help="build BM25 candidate slates from a "
                        "click log (session_id\\tquery\\tclicked_title)")
    bm.add_argument("--log", required=True)
    bm.add_argument("--output", required=True)
    bm.add_argument("--corpus_file", default=None,
                    help="title corpus, one per line (default: distinct "
                         "clicked titles from the log)")
    bm.add_argument("--num_candidates", type=int, default=50)
    bm.add_argument("--on_missing_click",
                    choices=("append", "drop", "keep"), default="append")
    bm.add_argument("--no_native", action="store_true",
                    help="force the pure-numpy scorer")
    bm.set_defaults(fn=cmd_bm25)
    args = p.parse_args(argv)
    return args.fn(args)


def console_main() -> None:
    """The ``cair-prepare-data-torch`` console script: ``main`` on
    ``sys.argv``, returning nothing (``main`` returns a summary dict,
    which a console script would take for a failing exit status)."""
    main()


if __name__ == "__main__":
    main()
