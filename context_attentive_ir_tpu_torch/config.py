"""Typed configuration system.

The port's copy of ``context_attentive_ir_tpu/config.py``'s ``ModelConfig``:
the same fields and defaults, so ``ModelConfig.from_json`` reads a config
written by the JAX package.  The kernel flags keep their JAX names:
``use_pallas_rnn`` selects the port's fused CUDA LSTM kernel for the
encoders (``ops/rnn.py``).
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
    # port: eval-mode LSTM encoders take the fused CUDA LSTM kernel
    # (ops/kernels/lstm.py) on a CUDA device, its plain version on the CPU
    use_pallas_rnn: bool = True
    # the slate-pool kernel is not ported yet; the port rejects True
    use_pallas_slate: bool = False
    # suggestion decode: per-turn cap on clicked docs encoded by
    # CARS.encode_session_suggest (exact when turns have <= this many
    # clicks; the slate's other N-C candidates are never encoded)
    suggest_max_clicks: int = 4
    # serving-only int8 embedding table; not ported yet (the port rejects
    # True)
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


def default_config(model_type: str, **overrides) -> ModelConfig:
    if model_type not in MODEL_DEFAULTS:
        raise ValueError(
            f"unknown model_type {model_type!r}; "
            f"choose from {sorted(MODEL_DEFAULTS)}")
    kw = dict(MODEL_DEFAULTS[model_type])
    kw.update(overrides)
    return ModelConfig(model_type=model_type, **kw)
