"""The port's ``cli/prepare_data.py`` against the JAX package's: the same
arguments give byte-identical output files for ``synthetic`` (both
corpora), ``convert`` and ``bm25`` (each ``--on_missing_click``, with the
native scorer and with ``--no_native``, with and without a corpus file),
on a click log that repeats queries, clicks twice in one turn, clicks a
title that differs from the corpus's only by case, clicks a title outside
the corpus, clicks more titles than the slate holds, and lists a corpus
title twice.  Then the prepared sessions load through the port's
``load_data``."""

import filecmp

import numpy as np
import pytest

from context_attentive_ir_tpu.cli.prepare_data import main as jax_main
from context_attentive_ir_tpu_torch.cli.prepare_data import (
    main,
    read_click_log,
)
from context_attentive_ir_tpu_torch.data import fast_bm25, load_data

TITLES = ["cheap flights to boston", "boston weather forecast",
          "cheap hotels boston downtown", "python programming tutorial",
          "learn python fast", "cheap flights to boston",
          "Jazz Guitar Chords"] + [f"filler title {i} boston"
                                   for i in range(12)]
LOG = [
    ("s1", "cheap flights", "cheap flights to boston"),
    ("s1", "boston hotels", "cheap hotels boston downtown"),
    ("s1", "cheap flights", "filler title 3 boston"),   # a re-issue: new turn
    ("s2", "python tutorial", "python programming tutorial"),
    ("s2", "python tutorial", "learn python fast"),     # two clicks, one turn
    ("s2", "jazz chords", "jazz guitar chords"),         # case differs
    ("s3", "weather", "not a corpus title"),             # unmatched
    ("s3", "weather", ""),                               # no click
    ("s4", "boston", "filler title 11 boston"),          # outside the top-3
    ("s5", "boston", "filler title 1 boston"),           # more clicks than
    ("s5", "boston", "filler title 2 boston"),           # replaceable slots
    ("s5", "boston", "filler title 4 boston"),
    ("s5", "boston", "filler title 5 boston"),
    ("s6", "short",),                                    # malformed row
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prep")
    corpus = tmp / "titles.txt"
    corpus.write_text("\n".join(TITLES) + "\n\n")
    log = tmp / "log.tsv"
    log.write_text("".join("\t".join(r) + "\n" for r in LOG))
    return tmp, corpus, log


def _both(tmp, name, argv, out_flag="--output"):
    """Run both CLIs with ``argv`` + their own output path; return the
    two paths and the port's report."""
    paths = [tmp / f"{name}_jax", tmp / f"{name}_port"]
    jax_main(argv + [out_flag, str(paths[0])])
    report = main(argv + [out_flag, str(paths[1])])
    return paths, report


@pytest.mark.parametrize("corpus_kind", ["topic", "ambiguous"])
def test_synthetic_files_equal_the_jax_cli(files, corpus_kind):
    tmp = files[0]
    (j, p), _ = _both(tmp, f"syn_{corpus_kind}",
                      ["synthetic", "--corpus", corpus_kind, "--n_train",
                       "12", "--n_dev", "3", "--n_test", "3",
                       "--num_candidates", "5", "--glove_dim", "8"],
                      out_flag="--out_dir")
    names = ["train.jsonl", "dev.jsonl", "test.jsonl", "glove.txt"]
    match, mismatch, errors = filecmp.cmpfiles(j, p, names, shallow=False)
    assert match == names, (mismatch, errors)


def test_convert_equals_the_jax_cli(files):
    tmp = files[0]
    tsv = tmp / "clicks4.tsv"
    tsv.write_text("a\tq one\tdoc x\t1\na\tq one\tdoc y\t0\n"
                   "a\tq two\tdoc z\t0\nb\tq three\tdoc w\t1\nshort\trow\n"
                   "a\tq one\tdoc v\t1\n")
    (j, p), report = _both(tmp, "conv.jsonl", ["convert", "--input",
                                               str(tsv)])
    assert filecmp.cmp(j, p, shallow=False)
    assert report == {"sessions": 2}


@pytest.mark.parametrize("policy", ["append", "drop", "keep"])
@pytest.mark.parametrize("no_native", [False, True])
@pytest.mark.parametrize("with_corpus", [True, False])
def test_bm25_equals_the_jax_cli(files, policy, no_native, with_corpus):
    tmp, corpus, log = files
    argv = ["bm25", "--log", str(log), "--num_candidates", "3",
            "--on_missing_click", policy]
    argv += ["--corpus_file", str(corpus)] if with_corpus else []
    argv += ["--no_native"] if no_native else []
    name = f"bm25_{policy}_{no_native}_{with_corpus}.jsonl"
    (j, p), report = _both(tmp, name, argv)
    assert filecmp.cmp(j, p, shallow=False)
    assert report["native"] == (not no_native and fast_bm25.available())
    assert report["sessions"] == 5 and report["turns"] == 8
    if with_corpus:
        assert report["titles"] == len(TITLES) - 1   # one duplicate
        assert report["unmatched"] == 1
        assert report["overflow"] == (1 if policy == "append" else 0)
    if policy == "drop":
        assert report["dropped"] > 0 and report["appended"] == 0


def test_prepared_sessions_load(files):
    tmp, corpus, log = files
    out = tmp / "load.jsonl"
    main(["bm25", "--log", str(log), "--output", str(out), "--corpus_file",
          str(corpus), "--num_candidates", "4"])
    sessions = load_data(str(out), max_query_len=10, max_doc_len=10,
                         num_candidates=4, max_session_len=5)
    assert [len(s.queries) for s in sessions] == [3, 2, 1, 1, 1]
    s2 = sessions[1].queries
    labels = {" ".join(d.tokens): d.label for d in s2[0].documents}
    assert labels["python programming tutorial"] == 1
    assert labels["learn python fast"] == 1
    # the click that differs only by case labels the corpus's title
    assert any(d.label == 1 for d in s2[1].documents)
    assert all(len(q.documents) == 4 for s in sessions for q in s.queries)
    assert np.mean([d.label for s in sessions for q in s.queries
                    for d in q.documents]) > 0


def test_read_click_log(files):
    log = read_click_log(files[2])
    assert [sid for sid, _ in log] == ["s1", "s2", "s3", "s4", "s5"]
    assert log[0][1] == [("cheap flights", ["cheap flights to boston"]),
                         ("boston hotels", ["cheap hotels boston downtown"]),
                         ("cheap flights", ["filler title 3 boston"])]
    assert log[2][1] == [("weather", ["not a corpus title"])]
