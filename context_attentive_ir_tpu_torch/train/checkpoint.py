"""Checkpoint / resume (port of ``context_attentive_ir_tpu/train/checkpoint.py``).

A checkpoint is a directory: the train state (params, optimizer state,
step) as ``state.pt``, a ``torch.save`` of plain tensors and ints that
``torch.load(weights_only=True)`` reads, plus the JSON sidecars
``config.json``, ``vocab.json`` and ``extra.json`` in the JAX package's
format.  ``Checkpointer`` keeps a best (``<name>.mdl``) and a latest
(``<name>.mdl.checkpoint``) slot.  Saves are atomic -- written to a
``.tmp`` directory, then swapped in with the old copy renamed aside to
``.old`` so a complete copy is on disk at every moment (``resolve`` reads
the ``.old`` copy in the swap window) -- and by default run on a writer
thread once the state has been copied to the host.

The port's state file is its own: the JAX package's ``state.msgpack``
(flax msgpack) is not read here.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Optional

import torch

from ..config import ModelConfig, override_model_args
from ..data.dictionary import Dictionary
from .state import TrainState

STATE_FILE = "state.pt"
CONFIG_FILE = "config.json"
VOCAB_FILE = "vocab.json"
EXTRA_FILE = "extra.json"


class Checkpointer:
    """Directory-per-checkpoint saver with best/latest slots."""

    def __init__(self, model_dir: str | Path, model_name: str,
                 async_save: bool = True):
        self.dir = Path(model_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.model_name = model_name
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    @property
    def best_path(self) -> Path:
        return self.dir / f"{self.model_name}.mdl"

    @property
    def latest_path(self) -> Path:
        return self.dir / f"{self.model_name}.mdl.checkpoint"

    # -- saving --------------------------------------------------------------

    def save_best(self, state: TrainState, config: ModelConfig,
                  word_dict: Dictionary, extra: dict | None = None):
        self._save(self.best_path, state, config, word_dict, extra or {})

    def save_latest(self, state: TrainState, config: ModelConfig,
                    word_dict: Dictionary, extra: dict | None = None):
        self._save(self.latest_path, state, config, word_dict, extra or {})

    def _save(self, path: Path, state: TrainState, config: ModelConfig,
              word_dict: Dictionary, extra: dict):
        # snapshot to the host now (the caller may train on); write later
        blob = state.state_dict()
        cfg_json = config.to_json()
        vocab_json = word_dict.to_json()
        extra_json = json.dumps(extra)
        self.wait()

        def write():
            tmp = path.with_suffix(path.suffix + ".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            torch.save(blob, tmp / STATE_FILE)
            (tmp / CONFIG_FILE).write_text(cfg_json)
            (tmp / VOCAB_FILE).write_text(vocab_json)
            (tmp / EXTRA_FILE).write_text(extra_json)
            if path.exists():
                old = path.with_suffix(path.suffix + ".old")
                if old.exists():
                    shutil.rmtree(old)
                path.rename(old)
                tmp.rename(path)
                shutil.rmtree(old, ignore_errors=True)
            else:
                tmp.rename(path)

        if not self.async_save:
            write()
            return

        def run():
            try:
                write()
            except Exception as e:  # reported by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        """Block until the pending save is on disk; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    # -- loading -------------------------------------------------------------

    @staticmethod
    def resolve(path: str | Path) -> Path:
        """The readable copy of a checkpoint: the primary directory, or the
        rename-aside ``.old`` copy if a crash landed inside the swap window
        where the primary name was vacant."""
        path = Path(path)
        if path.exists():
            return path
        old = path.with_suffix(path.suffix + ".old")
        return old if old.exists() else path

    @staticmethod
    def peek(path: str | Path) -> tuple[ModelConfig, Dictionary, dict]:
        """Config, vocabulary and extra of a checkpoint, without its
        state."""
        path = Checkpointer.resolve(path)
        config = ModelConfig.from_json((path / CONFIG_FILE).read_text())
        vocab = Dictionary.from_json((path / VOCAB_FILE).read_text())
        extra = json.loads((path / EXTRA_FILE).read_text())
        return config, vocab, extra

    @staticmethod
    def read_state(path: str | Path) -> dict:
        """The saved train state as plain CPU tensors and ints."""
        path = Checkpointer.resolve(path)
        return torch.load(path / STATE_FILE, map_location="cpu",
                          weights_only=True)

    @staticmethod
    def load(path: str | Path, state_template: TrainState) -> TrainState:
        """Restore a train state into ``state_template`` (in place) and
        return it."""
        blob = Checkpointer.read_state(path)
        try:
            state_template.load_state_dict(blob)
        except ValueError as e:
            raise ValueError(
                f"checkpoint at {Checkpointer.resolve(path)} does not match "
                "the current train-state structure (commonly: it was "
                "written with another optimizer or model configuration). "
                "Retrain, or load params only via Checkpointer.peek + "
                f"Checkpointer.read_state. Original: {e}") from e
        return state_template

    @staticmethod
    def load_for_test(path: str | Path, new_config: ModelConfig
                      ) -> tuple[ModelConfig, Dictionary, dict]:
        """The checkpoint's architecture wins, runtime flags come from
        ``new_config`` (``override_model_args``)."""
        saved_config, vocab, extra = Checkpointer.peek(path)
        return override_model_args(saved_config, new_config), vocab, extra
