"""Typed configuration system.

The port's copy of ``context_attentive_ir_tpu/config.py``'s ``ModelConfig``:
the same fields and defaults, so ``ModelConfig.from_json`` reads a config
written by the JAX package.  The kernel flags keep their JAX names:
``use_pallas_rnn`` selects the port's fused CUDA LSTM or GRU kernels for
the encoders (``ops/rnn.py``).  ``RANKERS``, ``RECOMMENDERS`` and
``MULTITASK`` name the model families as in the JAX package.  ``RunConfig``
(the runtime flags of one train / test run) and the argparse bridge
(``add_config_args``, ``config_from_args``) are copies too, so the same
command-line flags parse.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, fields
from typing import Any

from .constants import (
    MAX_DOC_LEN,
    MAX_QUERY_LEN,
    MAX_SESSION_LEN,
    NUM_CANDIDATES,
)

# Fields that define the network and survive checkpoint round trips (the
# JAX package's ARCHITECTURE_FIELDS; ``override_model_args`` keeps them).
ARCHITECTURE_FIELDS = (
    "model_type", "emsize", "nhid", "nlayers", "bidirection", "rnn_type",
    "dropout", "dropout_emb", "dropout_rnn", "attn_type", "fix_embeddings",
    "nhid_ffnn", "pool_size", "nfilters", "filter_widths", "session_rnn_type",
    "use_charngram", "regularize_coeff", "alpha", "tie_embeddings",
    "max_query_len", "max_doc_len", "max_session_len", "num_candidates",
    "loss_type", "margin", "ablate_history", "cars_ablation",
)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture + optimization flags for one model."""

    model_type: str = "cars"
    vocab_size: int = 0          # filled from the Dictionary at build time
    emsize: int = 300            # word embedding dim (GloVe 300-d)
    # per-direction RNN hidden size; the default is 128 (not the paper-era
    # 150) so state tensors land exactly on the TPU's 128-lane registers
    # and the fused Pallas LSTM kernel applies (ops/pallas/lstm.py)
    nhid: int = 128
    nlayers: int = 1
    bidirection: bool = True
    rnn_type: str = "lstm"
    session_rnn_type: str = "lstm"
    dropout: float = 0.2
    dropout_emb: float = 0.2
    dropout_rnn: float = 0.2
    attn_type: str = "general"
    fix_embeddings: bool = False
    tie_embeddings: bool = True   # share decoder generator with embeddings
    nhid_ffnn: int = 256          # MLP tower width (DSSM etc.)
    pool_size: int = 2            # maxout pool size
    nfilters: int = 64            # conv channels (CDSSM/ARC/MatchTensor)
    filter_widths: tuple[int, ...] = (1, 2, 3)
    use_charngram: bool = False
    regularize_coeff: float = 0.0
    alpha: float = 1.0            # multitask mix: L = L_rank + alpha * L_gen
    loss_type: str = "listwise"   # 'listwise' | 'pairwise' | 'pointwise'
    margin: float = 1.0           # pairwise hinge margin
    # diagnostic ablation: seq2seq encodes ONLY the current query (no
    # session history) -- the history-blind floor of the suggestion
    # capability ladder (RESULTS.md; VERDICT r2 next-round #1)
    ablate_history: bool = False
    # CARS component ablations, mirroring the paper's ablation analysis
    # (arXiv:1906.02329 SS4; SURVEY.md SS2.6): 'none' | 'no_click_flow'
    # (click-flow states removed from context memory + decoder init) |
    # 'no_context_attn' (ranking/suggestion see the raw query vector; no
    # history reaches either head).  The discriminative corpus predicts
    # each variant's ceiling -- see RESULTS.md ablation table.
    cars_ablation: str = "none"
    # static shapes
    max_query_len: int = MAX_QUERY_LEN
    max_doc_len: int = MAX_DOC_LEN
    max_session_len: int = MAX_SESSION_LEN
    num_candidates: int = NUM_CANDIDATES
    # optimization
    optimizer: str = "adam"       # 'sgd' | 'adam' | 'adamax'
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clipping: float = 5.0
    lr_decay: float = 0.95
    lr_decay_steps: int = 0       # 0 disables exponential lr decay
    warmup_steps: int = 0
    # precision / kernels
    compute_dtype: str = "float32"   # 'bfloat16' for the serving fast path
    # port: the encoders take the fused CUDA LSTM or GRU kernels
    # (ops/kernels/{lstm,gru}.py) on a CUDA device, their plain versions on
    # the CPU
    use_pallas_rnn: bool = True
    # CARS's doc_pool through the slate-pool kernel (ops/kernels/slate.py,
    # behind ops/attention.AttentionPool); off by default, as in the JAX
    # package
    use_pallas_slate: bool = False
    # suggestion decode: per-turn cap on clicked docs encoded by
    # CARS.encode_session_suggest (exact when turns have <= this many
    # clicks; the slate's other N-C candidates are never encoded)
    suggest_max_clicks: int = 4
    # serving-only int8 embedding table (ops/layers.Embeddings(quantized=
    # True)); Engine.from_checkpoint(quantize_embeddings=True) converts a
    # float checkpoint
    quantize_embeddings: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["filter_widths"] = list(self.filter_widths)
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "ModelConfig":
        d = json.loads(blob)
        if "filter_widths" in d:
            d["filter_widths"] = tuple(d["filter_widths"])
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def override_model_args(saved: ModelConfig, new: ModelConfig) -> ModelConfig:
    """Test-time merge: the checkpoint's architecture (and vocabulary size)
    wins, runtime and optimizer flags come from ``new``."""
    merged = dataclasses.asdict(new)
    for k in ARCHITECTURE_FIELDS:
        merged[k] = getattr(saved, k)
    merged["vocab_size"] = saved.vocab_size
    merged["filter_widths"] = tuple(merged["filter_widths"])
    return ModelConfig(**merged)


@dataclass(frozen=True)
class RunConfig:
    """Runtime flags for one train/test run (the reference's runtime
    argparse group, SURVEY.md SS2.10)."""

    model_dir: str = "runs"
    model_name: str = "model"
    batch_size: int = 32
    test_batch_size: int = 32
    num_epochs: int = 10
    display_iter: int = 25
    valid_metric: str = "map"     # 'map' | 'mrr' | 'bleu-1' | ...
    early_stop: int = 5           # epochs without improvement
    seed: int = 1013
    beam_size: int = 1            # >1 enables beam search at eval
    max_decode_len: int = 0       # 0 -> max_query_len + 1
    # beam penalties (reference translator/penalties.py parity, SS2.7)
    beam_alpha: float = 0.6       # length-penalty strength
    beam_length_penalty: str = "wu"      # 'wu' | 'avg' | 'none'
    beam_coverage_beta: float = 0.0      # 0 disables coverage penalty
    beam_coverage_penalty: str = "wu"    # 'wu' | 'summary'
    min_decode_len: int = 0       # forbid EOS before this many tokens
    resume: bool = False          # resume from <name>.mdl.checkpoint
    pretrained_path: str = ""     # warm-start from another run's best
    only_test: bool = False
    max_examples: int = -1
    async_checkpoint: bool = True
    native_vectorizer: bool = True  # use native fastvec when buildable
    tensorboard: bool = False       # also emit tensorboard scalars
    checkpoint_backend: str = "msgpack"  # 'msgpack' | 'orbax'
    # session-length buckets for multitask training, e.g. (2, 4, 10):
    # each bucket compiles its own static shape so short sessions don't
    # pay max_session_len padding FLOPs; () disables bucketing
    session_buckets: tuple[int, ...] = ()
    # host input pipeline (the reference --data_workers analogue,
    # SURVEY.md SS2.1): vectorize the train set
    # once and serve batches as row gathers ...
    pack_cache: bool = True
    # ... and host-collate this many batches ahead of the device step
    # (0 disables the prefetch thread)
    prefetch_batches: int = 2

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


# Per-model flag bundles -- the role of the reference's scripts/*.sh model
# name -> flags mapping (SURVEY.md SS2.11).
MODEL_DEFAULTS: dict[str, dict[str, Any]] = {
    "esm": dict(fix_embeddings=True),
    "dssm": dict(nhid_ffnn=300, loss_type="listwise"),
    "cdssm": dict(nfilters=300, filter_widths=(3,)),
    "duet": dict(nfilters=300, nhid_ffnn=300),
    "arci": dict(nfilters=128, filter_widths=(3,), nhid_ffnn=128),
    "arcii": dict(nfilters=64, filter_widths=(3,), nhid_ffnn=128),
    "drmm": dict(nhid_ffnn=32),
    "match_tensor": dict(nhid=128, nfilters=32),
    "seq2seq": dict(),
    "hredqs": dict(),
    "acg": dict(),
    "mnsrf": dict(alpha=1.0),
    "m_match_tensor": dict(nhid=128, nfilters=32, alpha=1.0),
    "cars": dict(alpha=1.0),
}


RANKERS = ("esm", "dssm", "cdssm", "duet", "arci", "arcii", "drmm",
           "match_tensor")
RECOMMENDERS = ("seq2seq", "hredqs", "acg")
MULTITASK = ("mnsrf", "m_match_tensor", "cars")


def default_config(model_type: str, **overrides) -> ModelConfig:
    if model_type not in MODEL_DEFAULTS:
        raise ValueError(
            f"unknown model_type {model_type!r}; "
            f"choose from {sorted(MODEL_DEFAULTS)}")
    kw = dict(MODEL_DEFAULTS[model_type])
    kw.update(overrides)
    return ModelConfig(model_type=model_type, **kw)


def add_config_args(parser) -> None:
    """Attach every ModelConfig field as a ``--flag`` (argparse bridge)."""
    for f in fields(ModelConfig):
        name = "--" + f.name
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(name, type=lambda x: x.lower() in
                                ("1", "true", "yes"), default=None)
        elif f.name == "filter_widths":
            parser.add_argument(name, type=lambda s: tuple(
                int(x) for x in s.split(",")), default=None)
        else:
            typ = type(f.default) if f.default is not None else str
            if f.default is dataclasses.MISSING:
                typ = str
            parser.add_argument(name, type=typ, default=None)


def config_from_args(args, base: ModelConfig | None = None) -> ModelConfig:
    overrides = {}
    for f in fields(ModelConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = v
    model_type = overrides.pop("model_type",
                               base.model_type if base else "cars")
    if base is None:
        return default_config(model_type, **overrides)
    return base.replace(model_type=model_type, **overrides)
