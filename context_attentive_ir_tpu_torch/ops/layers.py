"""Shared layers: parameter plumbing, dropout, Dense, Conv, max_pool,
Embeddings, CharCNN, MLP, cosine_similarity.

Port of ``context_attentive_ir_tpu/ops/layers.py`` (``Embeddings``,
``CharCNN``, ``MLP``, ``Highway``, ``Maxout``, ``cosine_similarity``) plus flax's ``nn.Dense``,
``nn.Conv``, ``nn.max_pool`` and ``nn.Dropout``.  Weights keep the JAX
layout -- dense kernels are ``[in, out]`` and layers compute ``x @ W``, conv
kernels are ``[*window, in, out]`` -- so the weight bridge (``convert.py``)
is a rename with no transposes.  Parameters are float32 and are cast to the
module's compute dtype at use, as flax does.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
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
    embedding normal(0.1), zeros, ones, ``constant:<value>``)."""
    shape = tuple(p.shape)
    if kind == "zeros":
        v = torch.zeros(shape)
    elif kind == "ones":
        v = torch.ones(shape)
    elif kind.startswith("constant:"):
        v = torch.full(shape, float(kind.partition(":")[2]))
    elif kind == "embedding":
        v = torch.randn(shape, generator=gen) * 0.1
    elif kind == "glorot":
        limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
        v = (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit
    elif kind == "lecun":
        # fan-in: every axis but the output one (a conv kernel's window too)
        v = torch.randn(shape, generator=gen) * math.sqrt(
            1.0 / math.prod(shape[:-1]))
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
    """An ``nn.Module`` whose parameters (float32 unless said otherwise)
    each carry an initializer name; ``reset_parameters`` fills a whole tree
    from one seed."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.inits: dict[str, str] = {}

    def new_param(self, name: str, shape: Sequence[int], init: str,
                  dtype: torch.dtype = torch.float32,
                  requires_grad: bool = True) -> nn.Parameter:
        p = nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                     device=self.device),
                         requires_grad=requires_grad)
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


class Conv(ParamModule):
    """flax ``nn.Conv`` at stride 1 over channels-last inputs ``[N, *spatial,
    C]`` with one or two spatial axes (``kernel_size=(w,)`` over ``[N, T,
    C]``, ``(kh, kw)`` over ``[N, H, W, C]``): ``kernel [*window, in, out]``
    (the JAX layout, so the weight bridge stays a rename) and ``bias
    [out]``, permuted to ``[out, in, *window]`` at use.  ``padding="SAME"``
    pads as flax does, ``(k - 1) // 2`` before and ``k // 2`` after: the
    same on both sides for an odd window (``conv*d``'s own padding), one
    more after for an even one (an ``F.pad`` first); ``"VALID"`` pads
    nothing.  The product is ``conv1d`` / ``conv2d`` (cuDNN on the card) on
    a channels-last view of the input: a permute, no copy."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: tuple[int, ...] = (3, 3),
                 padding: str = "SAME", dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__(device)
        if len(kernel_size) not in (1, 2):
            raise ValueError(f"Conv takes 1 or 2 spatial axes, got "
                             f"kernel_size {kernel_size}")
        if padding == "SAME":
            self.pad = tuple(((k - 1) // 2, k // 2) for k in kernel_size)
        elif padding == "VALID":
            self.pad = tuple((0, 0) for _ in kernel_size)
        else:
            raise ValueError(f"unknown padding {padding!r}")
        self.dtype = dtype
        self.kernel = self.new_param("kernel", (*kernel_size, in_features,
                                                features), "lecun")
        self.bias = self.new_param("bias", (features,), "zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, *spatial, in] -> [N, *spatial, out]."""
        nd = len(self.pad)
        w = self.kernel.to(self.dtype).permute(nd + 1, nd, *range(nd))
        x = x.to(self.dtype).movedim(-1, 1)
        if all(lo == hi for lo, hi in self.pad):
            padding = tuple(lo for lo, _ in self.pad)
        else:
            # F.pad lists the last axis first
            x = F.pad(x, [n for lo_hi in reversed(self.pad) for n in lo_hi])
            padding = 0
        conv = F.conv1d if nd == 1 else F.conv2d
        return conv(x, w, self.bias.to(self.dtype),
                    padding=padding).movedim(1, -1)


def max_pool(x: torch.Tensor, window: tuple[int, int],
             strides: tuple[int, int]) -> torch.Tensor:
    """flax ``nn.max_pool`` with ``padding="VALID"`` over channels-last
    ``[N, H, W, C]``: output sizes floor, and the gradient goes to the first
    maximum of each window, as in JAX."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window,
                        strides).permute(0, 2, 3, 1)


class Embeddings(ParamModule):
    """Word embedding table ``[V, E]``; lookup (with ``dropout``) and the
    tied-generator ``attend``.  ``fixed=True`` stops the gradient through
    the table in both (``--fix_embeddings``).  The JAX ``lookup_padded``
    lane pad is a TPU layout matter and is exact to drop: the port's
    encoders take the logical width.

    ``quantized=True`` is the serving-time int8 table of the JAX module:
    ``embedding_q`` int8 ``[V, E]`` and a per-row ``embedding_scale`` f32
    ``[V, 1]`` (``quantize_embedding_table``), neither trainable.  Lookup
    multiplies the gathered rows by their scales in the compute dtype, as
    the JAX module does; ``attend`` applies the scale after the product."""

    def __init__(self, vocab_size: int, features: int,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 dropout: float = 0.0, fixed: bool = False,
                 quantized: bool = False):
        super().__init__(device)
        self.features = features
        self.dtype = dtype
        self.dropout = dropout
        self.fixed = fixed
        self.quantized = quantized
        if quantized:
            self.embedding_q = self.new_param(
                "embedding_q", (vocab_size, features), "zeros",
                dtype=torch.int8, requires_grad=False)
            self.embedding_scale = self.new_param(
                "embedding_scale", (vocab_size, 1), "ones",
                requires_grad=False)
        else:
            self.embedding = self.new_param("embedding",
                                            (vocab_size, features),
                                            "embedding")

    def _table(self) -> torch.Tensor:
        """The float32 table, cut from the gradient when ``fixed``."""
        return self.embedding.detach() if self.fixed else self.embedding

    def forward(self, ids: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.quantized:
            out = (self.embedding_q[ids].to(self.dtype)
                   * self.embedding_scale[ids].to(self.dtype))
        else:
            out = F.embedding(ids, self._table()).to(self.dtype)
        return dropout(out, self.dropout, deterministic, generator)

    def attend(self, h: torch.Tensor) -> torch.Tensor:
        """Tied-generator logits: ``h [..., E] @ table.T -> [..., V]``."""
        if self.quantized:
            logits = h.to(self.dtype) @ self.embedding_q.to(self.dtype).T
            return logits * self.embedding_scale[:, 0].to(self.dtype)
        return h.to(self.dtype) @ self._table().to(self.dtype).T


class Highway(nn.Module):
    """``y = g * activation(x @ lin{i}) + (1 - g) * x`` with ``g =
    sigmoid(x @ gate{i})``, ``num_layers`` times (the JAX ``Highway``;
    ``activation`` relu by default)."""

    def __init__(self, dim: int, num_layers: int = 1,
                 activation: Callable = torch.relu,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.activation = activation
        self.dtype = dtype
        for i in range(num_layers):
            self.add_module(f"lin{i}", Dense(dim, dim, dtype=dtype,
                                             device=device))
            self.add_module(f"gate{i}", Dense(dim, dim, dtype=dtype,
                                              device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.num_layers):
            h = self.activation(getattr(self, f"lin{i}")(x))
            g = torch.sigmoid(getattr(self, f"gate{i}")(x))
            x = g * h + (1.0 - g) * x
        return x


class Maxout(nn.Module):
    """The max over ``pool_size`` linear pieces of each of ``features``
    outputs (the JAX ``Maxout``; its one dense layer is ``Dense_0``, out
    axis ordered feature-major)."""

    def __init__(self, in_features: int, features: int, pool_size: int = 2,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.features = features
        self.pool_size = pool_size
        self.Dense_0 = Dense(in_features, features * pool_size, dtype=dtype,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.Dense_0(x)
        return out.reshape(*out.shape[:-1], self.features,
                           self.pool_size).amax(-1)


def quantize_embedding_table(table) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization of a ``[V, E]`` table (a copy of
    the JAX package's numpy function): ``(q int8 [V, E], scale f32
    [V, 1])`` with ``scale = max(max|row|, 1e-8) / 127`` and ``q =
    clip(round(row / scale), -127, 127)``, rounding half to even."""
    table = np.asarray(table, np.float32)
    scale = np.maximum(np.abs(table).max(axis=1, keepdims=True),
                       1e-8) / 127.0
    q = np.clip(np.round(table / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


class CharCNN(nn.Module):
    """Character-level conv word encoder: byte ids ``[..., Lw]`` -> word
    vectors ``[..., len(filter_widths) * num_filters]``.  ``char_emb`` (no
    dropout), then per width ``w`` a ``SAME`` convolution ``conv{w}`` over
    the word's characters, ReLU and a max over all ``Lw`` positions (padding
    characters included, as in JAX)."""

    def __init__(self, char_vocab: int, char_dim: int = 16,
                 filter_widths: Sequence[int] = (2, 3, 4),
                 num_filters: int = 32, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        self.filter_widths = tuple(filter_widths)
        self.features = len(self.filter_widths) * num_filters
        self.char_emb = Embeddings(char_vocab, char_dim, dtype=dtype,
                                   device=device)
        for w in self.filter_widths:
            self.add_module(f"conv{w}", Conv(char_dim, num_filters, (w,),
                                             dtype=dtype, device=device))

    def forward(self, char_ids: torch.Tensor) -> torch.Tensor:
        emb = self.char_emb(char_ids)
        x = emb.reshape(-1, *emb.shape[-2:])               # [N, Lw, C]
        feats = [torch.relu(getattr(self, f"conv{w}")(x)).amax(dim=-2)
                 for w in self.filter_widths]
        out = torch.cat(feats, dim=-1)
        return out.reshape(*emb.shape[:-2], out.shape[-1])


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


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
                      eps: float = 1e-8) -> torch.Tensor:
    """``sum((a / max(|a|, eps)) * (b / max(|b|, eps)))`` over ``dim``: the
    JAX forward.  At a zero vector (a padded row, an empty candidate slot)
    the gradient is finite: ``vector_norm``'s subgradient at 0 is 0, where
    ``jnp.linalg.norm``'s is NaN even behind the ``maximum``."""
    na = torch.linalg.vector_norm(a, dim=dim, keepdim=True)
    nb = torch.linalg.vector_norm(b, dim=dim, keepdim=True)
    return ((a / na.clamp_min(eps)) * (b / nb.clamp_min(eps))).sum(dim)
