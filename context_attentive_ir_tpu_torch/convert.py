"""Weight bridge: a JAX param tree (CARS or HRED-QS) -> the port's state
dict.

The port keeps the JAX layouts (dense kernels ``[in, out]``; RNN ``w_ih
[D, G]`` / ``w_hh [H, G]`` in gate order i, f, g, o for an LSTM and r, z, n
plus ``b_hh`` for a GRU; checkpoint shapes at the logical emsize) and names
its parameters after the JAX tree, so the bridge is a rename: the nested
path ``query_encoder/layer0/w_ih_fwd`` becomes
``query_encoder.layer0.w_ih_fwd``.  Any leaf that the port does not have,
any parameter that the tree lacks, and any shape mismatch raise.  A
serving tree from ``quantize_embedding_params`` (int8 ``embedding_q`` and
f32 ``embedding_scale`` in place of ``embedding``) loads into a model
whose config has ``quantize_embeddings``; its int8 leaves stay int8.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch

from torch import nn

from .config import ModelConfig
from .models import build_model


def _flatten(tree: Mapping, prefix: str = "") -> Iterator[tuple[str, object]]:
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flatten(v, name + ".")
        else:
            yield name, v


def params_from_jax(params_np: Mapping,
                    config: ModelConfig) -> dict[str, torch.Tensor]:
    """``params_np``: the JAX param tree as nested dicts of numpy arrays
    (``jax.device_get(model.init(...)["params"])``) of the model that
    ``config.model_type`` names.  Returns CPU tensors keyed by the port's
    parameter names, float32 except the int8 table of a quantized config
    (whose leaf must already be int8)."""
    model = build_model(config, device="meta", seed=None)
    expected = {k: (tuple(v.shape), v.dtype)
                for k, v in model.state_dict().items()}
    flat = dict(_flatten(params_np))
    unknown = sorted(set(flat) - set(expected))
    missing = sorted(set(expected) - set(flat))
    if unknown or missing:
        raise ValueError(f"JAX params do not match the port's "
                         f"{type(model).__name__}: unknown {unknown}, "
                         f"missing {missing}")
    out = {}
    for name, value in flat.items():
        shape, dtype = expected[name]
        if dtype == torch.int8:
            arr = np.asarray(value)
            if arr.dtype != np.int8:
                raise ValueError(f"{name}: JAX dtype {arr.dtype}, port dtype "
                                 "int8")
        else:
            arr = np.asarray(value, dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: JAX shape {arr.shape}, port shape "
                             f"{shape}")
        out[name] = torch.from_numpy(arr.copy())
    return out


def load_jax_params(model: nn.Module, params_np: Mapping) -> None:
    """Copy a JAX param tree into ``model`` (in place)."""
    model.load_state_dict(params_from_jax(params_np, model.config))
