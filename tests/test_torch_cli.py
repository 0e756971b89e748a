"""The port's command line (``cli/main.py``): the parser cases of
tests/test_cli.py against the port's parser, every flag of the JAX parser
present with the same default, ``main()`` end to end on a CARS fixture on
the CPU with ``--only_test`` reproducing the metrics, HRED-QS through the
same entry point, and an unknown model type raising before anything is
written."""

import pytest
import torch

from context_attentive_ir_tpu.cli.main import build_parser as jax_parser
from context_attentive_ir_tpu_torch.cli.main import (
    build_parser,
    main,
    prepare,
    run_config_from_args,
)
from context_attentive_ir_tpu_torch.config import (
    RunConfig,
    config_from_args,
    default_config,
)
from context_attentive_ir_tpu_torch.data import write_fixture

SMALL = ["--emsize", "16", "--nhid", "8", "--nhid_ffnn", "16",
         "--num_candidates", "6", "--max_query_len", "6", "--max_doc_len",
         "8", "--max_session_len", "3", "--test_batch_size", "8",
         "--device", "cpu"]


def test_parser_defaults_and_overrides():
    p = build_parser()
    args = p.parse_args([
        "--model_type", "cars", "--train_file", "t.jsonl",
        "--batch_size", "64", "--nhid", "32", "--learning_rate", "0.01",
        "--bidirection", "false", "--session_buckets", "2,4",
        "--beam_size", "5", "--only_test",
    ])
    run = run_config_from_args(args)
    assert run.batch_size == 64
    assert run.beam_size == 5
    assert run.only_test is True
    assert run.session_buckets == (2, 4)
    cfg = config_from_args(args, default_config(args.model_type))
    assert cfg.model_type == "cars"
    assert cfg.nhid == 32
    assert cfg.learning_rate == 0.01
    assert cfg.bidirection is False


def test_parser_model_defaults_apply():
    p = build_parser()
    args = p.parse_args(["--model_type", "dssm"])
    cfg = config_from_args(args, default_config(args.model_type))
    assert cfg.nhid_ffnn == 300   # the dssm bundle of MODEL_DEFAULTS
    args2 = p.parse_args(["--model_type", "dssm", "--nhid_ffnn", "64"])
    cfg2 = config_from_args(args2, default_config(args2.model_type))
    assert cfg2.nhid_ffnn == 64


def test_filter_widths_parsing():
    p = build_parser()
    args = p.parse_args(["--model_type", "cdssm", "--filter_widths", "2,3"])
    cfg = config_from_args(args, default_config(args.model_type))
    assert cfg.filter_widths == (2, 3)


def test_same_flags_and_defaults_as_the_jax_parser():
    ja = vars(jax_parser().parse_args([]))
    pa = vars(build_parser().parse_args([]))
    assert set(pa) - set(ja) == {"device"} and set(ja) <= set(pa)
    assert {k: pa[k] for k in ja} == ja
    argv = ["--model_type", "hredqs", "--no-pack_cache", "--beam_alpha",
            "0.3", "--beam_coverage_beta", "0.2", "--max_vocab", "5000",
            "--restrict_vocab", "--rnn_type", "gru", "--dropout", "0.1"]
    ja, pa = (vars(p.parse_args(argv)) for p in (jax_parser(),
                                                 build_parser()))
    assert {k: pa[k] for k in ja} == ja
    assert run_config_from_args(build_parser().parse_args([])) == RunConfig()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    return (tmp,
            write_fixture(tmp / "train.jsonl", n_sessions=12, n_candidates=6,
                          seed=0),
            write_fixture(tmp / "dev.jsonl", n_sessions=4, n_candidates=6,
                          seed=1))


def test_main_end_to_end_cars(files):
    tmp, train, dev = files
    where = ["--model_dir", str(tmp / "runs"), "--model_name", "clismoke"]
    results = main(["--model_type", "cars", "--train_file", str(train),
                    "--dev_file", str(dev), "--test_file", str(dev), *where,
                    "--num_epochs", "2", "--batch_size", "8",
                    "--display_iter", "5", "--early_stop", "10",
                    "--beam_size", "2", "--no-async_checkpoint", *SMALL])
    assert "fit" in results and "test" in results
    assert [h["epoch"] for h in results["fit"]["history"]] == [0, 1]
    assert 0.0 <= results["test"]["map"] <= 1.0
    assert "bleu-1" in results["test"] and "rouge-l" in results["test"]
    runs = tmp / "runs"
    for name in ("clismoke.test.ranks.jsonl", "clismoke.test.hyps.jsonl",
                 "clismoke.metrics.jsonl", "clismoke.txt"):
        assert (runs / name).exists() and (runs / name).read_text().strip()
    assert (runs / "clismoke.mdl" / "state.msgpack").exists()
    assert (runs / "clismoke.mdl.checkpoint" / "state.msgpack").exists()
    # --only_test reloads the saved model and reproduces the metrics; the
    # architecture comes from the checkpoint, not from the flags
    retest = main(["--model_type", "cars", "--only_test", "--test_file",
                   str(dev), *where, "--beam_size", "2", "--nhid", "4",
                   *SMALL[4:]])
    assert retest["test"] == results["test"] and "fit" not in retest


def test_main_end_to_end_hredqs(files):
    tmp, train, dev = files
    results = main(["--model_type", "hredqs", "--rnn_type", "gru",
                    "--session_rnn_type", "gru", "--train_file", str(train),
                    "--test_file", str(dev), "--model_dir",
                    str(tmp / "runs"), "--model_name", "hred", "--num_epochs",
                    "1", "--batch_size", "8", "--valid_metric", "bleu-1",
                    "--no-pack_cache", "--prefetch_batches", "0", *SMALL],
                   device="cpu")
    # no --dev_file: validation runs on the training sessions
    assert results["fit"]["history"][0]["n_queries"] > 0
    assert "map" not in results["test"] and "bleu-1" in results["test"]
    assert (tmp / "runs" / "hred.test.hyps.jsonl").exists()
    assert not (tmp / "runs" / "hred.test.ranks.jsonl").exists()


@pytest.mark.parametrize("model_type", ["bert", "DSSM", "match-tensor",
                                        "esm2"])
def test_unported_model_type_raises(files, model_type):
    """Every model type of the JAX zoo is ported; a type outside it raises
    ``ValueError`` before the model directory is written."""
    tmp, train, _ = files
    with pytest.raises(ValueError, match=f"unknown model_type '{model_type}'"):
        main(["--model_type", model_type, "--train_file", str(train),
              "--model_dir", str(tmp / "none"), *SMALL])
    assert not (tmp / "none").exists()


def test_default_device_is_the_card(files, monkeypatch):
    tmp, train, _ = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--model_type", "cars", "--train_file", str(train),
            "--model_dir", str(tmp / "nocard"), *SMALL[:-2]]
    with pytest.raises(RuntimeError, match="is_available"):
        main(argv)
    # the caller's device stands when no flag is given; the flag wins
    args = build_parser().parse_args(argv)
    assert prepare(args, device="cpu")[2].device.type == "cpu"
    args = build_parser().parse_args(argv + ["--device", "cpu"])
    assert prepare(args, device="cuda")[2].device.type == "cpu"
