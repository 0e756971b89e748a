"""Shared layers: parameter plumbing, dropout, Dense, Embeddings, MLP.

Port of ``context_attentive_ir_tpu/ops/layers.py`` (``Embeddings``, ``MLP``)
plus flax's ``nn.Dense`` and ``nn.Dropout``.  Weights keep the JAX layout -- dense kernels are
``[in, out]`` and layers compute ``x @ W`` -- so the weight bridge
(``convert.py``) is a rename with no transposes.  Parameters are float32 and
are cast to the module's compute dtype at use, as flax does.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale kept ones by ``1 / (1 - rate)``; the identity when
    ``deterministic`` or ``rate == 0``.  The noise comes from ``generator``
    (on x's device), which a non-deterministic call must pass."""
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a "
                         "torch.Generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def init_param_(p: torch.Tensor, kind: str, gen: torch.Generator) -> None:
    """Fill ``p`` in place from the CPU generator ``gen`` (flax's
    initializer families: glorot-uniform, lecun-normal, orthogonal, the
    embedding normal(0.1), zeros)."""
    shape = tuple(p.shape)
    if kind == "zeros":
        v = torch.zeros(shape)
    elif kind == "embedding":
        v = torch.randn(shape, generator=gen) * 0.1
    elif kind == "glorot":
        limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
        v = (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit
    elif kind == "lecun":
        v = torch.randn(shape, generator=gen) * math.sqrt(1.0 / shape[-2])
    elif kind == "orthogonal":
        rows, cols = shape
        a = torch.randn(max(rows, cols), min(rows, cols), generator=gen)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        v = q.T if rows < cols else q
    else:
        raise ValueError(f"unknown initializer {kind!r}")
    with torch.no_grad():
        p.copy_(v)


class ParamModule(nn.Module):
    """An ``nn.Module`` whose float32 parameters each carry an initializer
    name; ``reset_parameters`` fills a whole tree from one seed."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.inits: dict[str, str] = {}

    def new_param(self, name: str, shape: Sequence[int],
                  init: str) -> nn.Parameter:
        p = nn.Parameter(torch.empty(tuple(shape), dtype=torch.float32,
                                     device=self.device))
        self.register_parameter(name, p)
        self.inits[name] = init
        return p


def reset_parameters(root: nn.Module, seed: int) -> None:
    """Random init of every ``ParamModule`` parameter under ``root`` from a
    CPU ``torch.Generator`` seeded with ``seed`` (module order is fixed, so
    a seed gives the same weights on every device)."""
    gen = torch.Generator().manual_seed(seed)
    for mod in root.modules():
        for name, kind in getattr(mod, "inits", {}).items():
            init_param_(getattr(mod, name), kind, gen)


class Dense(ParamModule):
    """flax ``nn.Dense``: ``x @ kernel [in, out] + bias``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__(device)
        self.dtype = dtype
        self.kernel = self.new_param("kernel", (in_features, features),
                                     "lecun")
        self.bias = (self.new_param("bias", (features,), "zeros")
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Embeddings(ParamModule):
    """Word embedding table ``[V, E]``; lookup (with ``dropout``) and the
    tied-generator ``attend``.  ``fixed=True`` stops the gradient through
    the table in both (``--fix_embeddings``).  The JAX ``lookup_padded``
    lane pad is a TPU layout matter and is exact to drop: the port's
    encoders take the logical width."""

    def __init__(self, vocab_size: int, features: int,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 dropout: float = 0.0, fixed: bool = False):
        super().__init__(device)
        self.features = features
        self.dtype = dtype
        self.dropout = dropout
        self.fixed = fixed
        self.embedding = self.new_param("embedding", (vocab_size, features),
                                        "embedding")

    def _table(self) -> torch.Tensor:
        """The float32 table, cut from the gradient when ``fixed``."""
        return self.embedding.detach() if self.fixed else self.embedding

    def forward(self, ids: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        out = F.embedding(ids, self._table()).to(self.dtype)
        return dropout(out, self.dropout, deterministic, generator)

    def attend(self, h: torch.Tensor) -> torch.Tensor:
        """Tied-generator logits: ``h [..., E] @ table.T -> [..., V]``."""
        return h.to(self.dtype) @ self._table().to(self.dtype).T


class MLP(nn.Module):
    """Plain feed-forward stack (``fc0``, ``fc1``, ...), with ``dropout``
    after every layer but the last."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int],
                 activation: Callable = torch.tanh,
                 final_activation: bool = True,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 dropout: float = 0.0):
        super().__init__()
        self.activation = activation
        self.final_activation = final_activation
        self.dtype = dtype
        self.dropout = dropout
        sizes = [in_features, *layer_sizes]
        self.n_layers = len(layer_sizes)
        for i in range(self.n_layers):
            self.add_module(f"fc{i}", Dense(sizes[i], sizes[i + 1],
                                            dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"fc{i}")(x)
            last = i == self.n_layers - 1
            if not last or self.final_activation:
                x = self.activation(x)
            if not last:
                x = dropout(x, self.dropout, deterministic, generator)
        return x
