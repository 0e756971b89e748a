"""The train / test entry point of the port.

Port of ``context_attentive_ir_tpu/cli/main.py``, same flags: argparse CLI,
seed setup, data loading, vocabulary building (optionally restricted to the
embedding file's words), init-or-resume, epoch loop with validation and
early stopping, final official test eval, prediction dumps.  One entry point
serves every task family (derived from ``--model_type``) and every model of
the JAX zoo; an unknown model type raises ``ValueError`` before anything is
written.

Runs on the card unless ``--device cpu`` (or ``main(argv, device="cpu")``)
asks for the CPU.

Usage:
    python -m context_attentive_ir_tpu_torch.cli.main \\
        --model_type cars --train_file data/train.jsonl \\
        --dev_file data/dev.jsonl --test_file data/test.jsonl \\
        --model_dir runs --model_name cars_aol [--only_test] [flags...]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from pathlib import Path

import numpy as np

from ..config import (
    ModelConfig,
    RunConfig,
    add_config_args,
    config_from_args,
    default_config,
)
from ..data import (
    build_dictionary,
    load_data,
    load_embedding_words,
    load_embeddings,
)
from ..train import Checkpointer, Trainer
from ..utils import setup_logging

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="context-attentive IR on PyTorch/CUDA: train/test")
    files = p.add_argument_group("files")
    files.add_argument("--train_file", type=str, default="")
    files.add_argument("--dev_file", type=str, default="")
    files.add_argument("--test_file", type=str, default="")
    files.add_argument("--embedding_file", type=str, default="",
                       help="GloVe-format pretrained embeddings")
    files.add_argument("--restrict_vocab", action="store_true",
                       help="keep only words present in --embedding_file")
    files.add_argument("--max_vocab", type=int, default=100_000)
    files.add_argument("--min_word_count", type=int, default=1)
    runtime = p.add_argument_group("runtime")
    runtime.add_argument("--device", type=str, default=None,
                         help="torch device (default: cuda)")
    for f in dataclasses.fields(RunConfig):
        name = "--" + f.name
        if isinstance(f.default, bool):
            runtime.add_argument(name, action=argparse.BooleanOptionalAction,
                                 default=f.default)
        elif isinstance(f.default, tuple):
            runtime.add_argument(name, type=lambda s: tuple(
                int(x) for x in s.split(",") if x), default=f.default)
        else:
            runtime.add_argument(name, type=type(f.default),
                                 default=f.default)
    arch = p.add_argument_group("model")
    add_config_args(arch)
    return p


def run_config_from_args(args) -> RunConfig:
    kw = {f.name: getattr(args, f.name) for f in
          dataclasses.fields(RunConfig)}
    return RunConfig(**kw)


def prepare(args, device="cuda"
            ) -> tuple[ModelConfig, RunConfig, Trainer, list, list, list]:
    run = run_config_from_args(args)
    model_type = args.model_type or "cars"
    config = config_from_args(args, default_config(model_type))

    setup_logging(Path(run.model_dir) / f"{run.model_name}.txt")

    if run.only_test:
        best = Path(run.model_dir) / f"{run.model_name}.mdl"
        config, word_dict, _ = Checkpointer.load_for_test(best, config)
        logger.info("Test mode: architecture restored from %s", best)
        train_sessions = []
    else:
        assert args.train_file, "--train_file required for training"
        train_sessions = load_data(
            args.train_file, config.max_query_len, config.max_doc_len,
            config.num_candidates, config.max_session_len,
            run.max_examples)
        streams = []
        for s in train_sessions:
            for q in s.queries:
                streams.append(q.tokens)
                for d in q.documents:
                    streams.append(d.tokens)
        restrict = None
        if args.restrict_vocab and args.embedding_file:
            restrict = load_embedding_words(args.embedding_file)
        word_dict = build_dictionary(
            streams, max_words=args.max_vocab,
            min_count=args.min_word_count, restrict_vocab=restrict)
        logger.info("Vocabulary: %d words", len(word_dict))
    config = config.replace(vocab_size=len(word_dict))

    pretrained = None
    if args.embedding_file and not run.only_test:
        pretrained, n = load_embeddings(args.embedding_file, word_dict,
                                        config.emsize)
        logger.info("Pretrained embeddings: %d/%d", n, len(word_dict))

    dev_sessions = load_data(
        args.dev_file, config.max_query_len, config.max_doc_len,
        config.num_candidates, config.max_session_len,
        run.max_examples) if args.dev_file else []
    test_sessions = load_data(
        args.test_file, config.max_query_len, config.max_doc_len,
        config.num_candidates, config.max_session_len,
        run.max_examples) if args.test_file else []

    trainer = Trainer(config, run, word_dict, pretrained=pretrained,
                      device=getattr(args, "device", None) or device)
    return config, run, trainer, train_sessions, dev_sessions, test_sessions


def main(argv=None, device="cuda") -> dict:
    """Train and / or test as the flags say; ``--device`` overrides
    ``device``."""
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)
    config, run, trainer, train_s, dev_s, test_s = prepare(args, device)
    logger.info("Config:\n%s", config.to_json())
    results: dict = {}
    if not run.only_test:
        results["fit"] = trainer.fit(train_s, dev_s or train_s)
    if test_s:
        dump = Path(run.model_dir) / f"{run.model_name}.test"
        results["test"] = trainer.test(test_s, dump_prefix=str(dump))
    return results


def console_main() -> None:
    """The ``cair-train-torch`` console script: ``main`` on ``sys.argv``,
    returning nothing (a console script exits with what its function
    returns, and ``main``'s results would read as a failure)."""
    main()


if __name__ == "__main__":
    main()
