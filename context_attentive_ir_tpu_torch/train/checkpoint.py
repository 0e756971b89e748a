"""Checkpoint / resume (port of ``context_attentive_ir_tpu/train/checkpoint.py``).

A checkpoint is a directory: the train state (params, optimizer state,
step) as ``state.msgpack``, plus the JSON sidecars ``config.json``,
``vocab.json`` and ``extra.json``.  Every file is in the JAX package's
format, so run directories cross between the packages both ways: the
state is the JAX ``TrainState``'s state dict (``{"step", "params",
"opt_state"}``, the optimizer state nested as the JAX ``make_optimizer``
chains optax for the config) in flax's msgpack, written and read by
``flax_msgpack`` without flax.  ``state_to_flax`` / ``state_from_flax``
map the port's ``TrainState.state_dict()`` to and from that tree.  A
directory the port wrote before it wrote msgpack holds ``state.pt`` (a
``torch.save`` of the state dict) instead; ``read_state`` reads either.

``Checkpointer`` keeps a best (``<name>.mdl``) and a latest
(``<name>.mdl.checkpoint``) slot.  Saves are atomic -- written to a
``.tmp`` directory, then swapped in with the old copy renamed aside to
``.old`` so a complete copy is on disk at every moment (``resolve`` reads
the ``.old`` copy in the swap window) -- and by default are encoded and
written on a writer thread once the state has been copied to the host.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Optional

import torch

from ..config import ModelConfig, override_model_args
from ..convert import flatten_tree, nest_tree
from ..data.dictionary import Dictionary
from . import flax_msgpack
from .state import TrainState, is_embedding_table

STATE_FILE = "state.msgpack"
TORCH_STATE_FILE = "state.pt"   # the port's own format before msgpack
CONFIG_FILE = "config.json"
VOCAB_FILE = "vocab.json"
EXTRA_FILE = "extra.json"


# -- the state tree in the JAX package's layout ------------------------------


def _has_schedule(config: ModelConfig) -> bool:
    """True where ``make_optimizer``'s learning rate is a schedule, whose
    optax state is a ``count``."""
    return ((config.lr_decay_steps > 0 and config.lr_decay < 1.0)
            or config.warmup_steps > 0)


def _moment_names(config: ModelConfig) -> tuple[str, ...]:
    return ("trace",) if config.optimizer == "sgd" else ("mu", "nu")


def _count(n: int) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


def _opt_tree(config: ModelConfig, opt: dict, names) -> dict:
    """The optax state of the JAX ``make_optimizer`` chain: clip (an empty
    state) -> [multi_transform: train / frozen] -> [add_decayed_weights]
    -> the optimizer's own chain (its moments, then the learning rate's
    scale: a ``count`` under a schedule, else empty).  A frozen table's
    moment leaves are optax's ``MaskedNode``, an empty map."""
    count = _count(opt["count"])
    moments = {k: nest_tree({n: opt[k][n] if n in opt[k] else {}
                             for n in names})
               for k in _moment_names(config)}
    if config.optimizer != "sgd":
        moments = {"count": count, **moments}
    node = {"0": moments, "1": {"count": count} if _has_schedule(config)
            else {}}
    node = {"0": {}, "1": node} if config.weight_decay > 0 else {"0": node}
    if config.fix_embeddings:
        node = {"inner_states": {"train": {"inner_state": node},
                                 "frozen": {"inner_state": {}}}}
    return {"0": {}, "1": node} if config.grad_clipping > 0 else {"0": node}


def _opt_path(config: ModelConfig) -> tuple[str, ...]:
    """Keys from ``opt_state`` down to the optimizer's own chain."""
    path = ("1",) if config.grad_clipping > 0 else ("0",)
    if config.fix_embeddings:
        path += ("inner_states", "train", "inner_state")
    return path + (("1",) if config.weight_decay > 0 else ("0",))


def state_to_flax(blob: dict, config: ModelConfig) -> dict:
    """The port's ``TrainState.state_dict()`` as the JAX ``TrainState``'s
    state dict for ``config``: ``{"step", "params", "opt_state"}``, params
    nested by their dotted names, step and counts as 0-d int32 arrays."""
    params = blob["params"]
    return {"step": _count(blob["step"]), "params": nest_tree(params),
            "opt_state": _opt_tree(config, blob["opt_state"], params)}


def _match_keys(path: str, got, want) -> None:
    """Raise ValueError naming the first place where ``got``'s maps differ
    from ``want``'s (an empty map must be empty; a leaf must be a
    leaf)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            have = sorted(got) if isinstance(got, dict) else type(got).__name__
            raise ValueError(f"{path or 'state'}: keys {have} != "
                             f"{sorted(want)}")
        for k in want:
            _match_keys(f"{path}.{k}" if path else str(k), got[k], want[k])
    elif isinstance(got, dict):
        raise ValueError(f"{path}: a map where the state has a leaf")


def _as_int(path: str, v) -> int:
    if isinstance(v, torch.Tensor) and v.dim() == 0 and not (
            v.dtype.is_floating_point or v.dtype.is_complex
            or v.dtype == torch.bool):
        return int(v)
    if isinstance(v, int) and not isinstance(v, bool):
        return v
    raise ValueError(f"{path}: {v!r} is not an integer count")


def state_from_flax(tree: dict, config: ModelConfig) -> dict:
    """The JAX ``TrainState``'s state dict (as ``flax_msgpack.loads`` reads
    it) for ``config`` -> the port's ``TrainState.state_dict()`` layout.
    ``step`` and the counts may be ints or 0-d integer arrays; every count
    present must agree; SGD without a schedule keeps no count, and the
    port's is ``step`` there.  A key that differs raises ValueError naming
    its path (shapes and dtypes are checked where the state is loaded)."""
    if not isinstance(tree, dict) or not isinstance(tree.get("params"), dict):
        raise ValueError("state: not a train state (no params map)")
    params = dict(flatten_tree(tree["params"]))
    trainable = [n for n in params
                 if not (config.fix_embeddings and is_embedding_table(n))]
    skeleton = state_to_flax(
        {"step": 0, "params": params, "opt_state": {
            "count": 0, **{k: dict.fromkeys(trainable, 0)
                           for k in _moment_names(config)}}}, config)
    _match_keys("", tree, skeleton)
    node = tree["opt_state"]
    for k in _opt_path(config):
        node = node[k]
    step = _as_int("step", tree["step"])
    counts = []
    if config.optimizer != "sgd":
        counts.append(_as_int("opt_state count", node["0"]["count"]))
    if _has_schedule(config):
        counts.append(_as_int("opt_state schedule count",
                              node["1"]["count"]))
    if len(set(counts)) > 1:
        raise ValueError(f"opt_state: counts {counts} disagree")
    opt = {"count": counts[0] if counts else step}
    for k in _moment_names(config):
        flat = dict(flatten_tree(node["0"][k]))
        opt[k] = {n: flat[n] for n in trainable}
    return {"params": params, "opt_state": opt, "step": step}


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
        # snapshot to the host now (the caller may train on); encode and
        # write later
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
            (tmp / STATE_FILE).write_bytes(
                flax_msgpack.dumps(state_to_flax(blob, config)))
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
        """The saved train state as plain CPU tensors and ints, in
        ``TrainState.state_dict()``'s layout: from ``state.msgpack``
        (written by either package; its layout follows the directory's
        ``config.json``) or from a ``state.pt`` the port wrote before."""
        path = Checkpointer.resolve(path)
        if (path / STATE_FILE).exists():
            config = ModelConfig.from_json((path / CONFIG_FILE).read_text())
            tree = flax_msgpack.loads((path / STATE_FILE).read_bytes())
            return state_from_flax(tree, config)
        if (path / TORCH_STATE_FILE).exists():
            return torch.load(path / TORCH_STATE_FILE, map_location="cpu",
                              weights_only=True)
        raise FileNotFoundError(f"no {STATE_FILE} or {TORCH_STATE_FILE} "
                                f"in {path}")

    @staticmethod
    def load(path: str | Path, state_template: TrainState) -> TrainState:
        """Restore a train state into ``state_template`` (in place) and
        return it."""
        try:
            state_template.load_state_dict(Checkpointer.read_state(path))
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
