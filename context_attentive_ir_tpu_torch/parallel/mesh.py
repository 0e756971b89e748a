"""Device mesh and data-parallel layout (port of
``context_attentive_ir_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process holds a ``('data',)``
mesh, batches shard on their leading axis, parameters and optimizer state
replicate, and XLA inserts the gradient all-reduce.  The port keeps that
shape with no process group: one process drives every replica in turn.  A
``Mesh`` is an ordered list of devices, one replica each; a device may
repeat (``["cuda:0", "cuda:0"]`` runs two replicas on one card,
``["cpu"] * 8`` eight on the CPU), and each replica then holds its own
copy of the weights.  Replica 0 is the primary: the parameters and the
optimizer state that are trained and saved live there.

- ``shard_batch`` splits every leaf of a batch into ``mesh.size`` equal
  contiguous parts on axis 0, each moved onto its replica's device;
- ``replicated`` places a parameter tree, or a model, on every replica
  (real copies, never aliases, also on a repeated device);
- ``gather`` concatenates per-replica outputs in replica order on the
  primary;
- ``reduce_grads`` sums per-replica gradients onto the primary in replica
  order, so the result does not depend on timing.

The JAX ``batch_sharding`` (a ``NamedSharding``) has no counterpart: the
port's layout is the list of shards ``shard_batch`` returns.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """One replica per entry of ``devices``, in order; replica 0 is the
    primary."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        return self.devices[0]


def make_mesh(devices: Sequence | None = None) -> Mesh:
    """A mesh over ``devices`` (names or ``torch.device``\\ s; one replica
    per entry, repeats allowed), by default every visible CUDA device.
    Raises when no CUDA device is visible: the default never falls back to
    the CPU, which must be named (``make_mesh(["cpu"] * 8)``)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "make_mesh() meshes every visible CUDA device and none is "
                "visible; name the devices, e.g. make_mesh(['cpu'] * 8)")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = []
    for d in devices:
        dev = torch.device(d)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {dev} requested but "
                                   "torch.cuda.is_available() is False")
            dev = torch.device("cuda", torch.cuda.current_device()
                               if dev.index is None else dev.index)
        devs.append(dev)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs))


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def split_batch(batch, n: int) -> list:
    """``n`` contiguous equal parts of axis 0 of an array or tensor, or of
    every leaf of a batch dataclass (``None`` leaves stay ``None``).
    Raises ValueError unless ``n`` divides the rows."""
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        leaves = {None: batch}
    else:
        leaves = {f.name: getattr(batch, f.name)
                  for f in dataclasses.fields(batch)}
    rows = {len(v) for v in leaves.values() if v is not None}
    if len(rows) != 1:
        raise ValueError(f"batch leaves disagree on axis 0: {sorted(rows)}")
    (b,) = rows
    if b % n:
        raise ValueError(f"batch of {b} rows does not split into {n} equal "
                         "shards; pad it to a multiple of the mesh size")
    k = b // n
    parts = [{name: None if v is None else v[i * k:(i + 1) * k]
              for name, v in leaves.items()} for i in range(n)]
    if None in leaves:
        return [p[None] for p in parts]
    return [type(batch)(**p) for p in parts]


def shard_batch(batch, mesh: Mesh) -> list:
    """A batch dataclass, numpy array or tensor split into ``mesh.size``
    equal contiguous shards on axis 0, shard ``r`` on replica ``r``'s
    device (numpy leaves become tensors, as ``batch.to`` makes them)."""
    return [to_device(shard, dev) for shard, dev in
            zip(split_batch(batch, mesh.size), mesh.devices)]


def to_device(x, device):
    """A batch dataclass (``batch.to``), numpy array or tensor on
    ``device``."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return x.to(device)


def _copy_to(x, dev: torch.device, copy: bool):
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev, copy=copy)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    if isinstance(x, dict):
        return {k: _copy_to(v, dev, copy) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_copy_to(v, dev, copy) for v in x)
    return x


def replicated(value: Any, mesh: Mesh) -> list:
    """``value`` on every replica: a list of ``mesh.size`` entries.

    A model (``nn.Module``): entry 0 is the model itself, which must lie
    on the primary device; every other entry is a model of the same class
    and config built on its replica's device, holding copies of the
    primary's parameters and buffers.  A tree of tensors (dicts, lists,
    tuples; numpy arrays become tensors; ``None`` stays): entry 0 on the
    primary without a copy when it already lies there, the others as
    copies.  No two entries share storage."""
    if isinstance(value, nn.Module):
        from ..models import build_model

        dev = _module_device(value)
        if dev != mesh.primary:
            raise ValueError(f"the model lies on {dev}, the mesh's primary "
                             f"is {mesh.primary}")
        models = [value]
        for d in mesh.devices[1:]:
            m = build_model(value.config, device=d, seed=None)
            m.load_state_dict(value.state_dict())
            m.train(value.training)
            models.append(m)
        return models
    return [_copy_to(value, d, r > 0) for r, d in enumerate(mesh.devices)]


def _module_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def model_replicas(model: nn.Module, mesh: Mesh) -> list:
    """``replicated(model, mesh)``, built once per (model, mesh) and kept
    on the model, so the steps, the decoder and the Engine over one model
    share one set of copies.  Call ``sync_replicas`` before using them."""
    cache = model.__dict__.setdefault("_mesh_replicas", {})
    if mesh not in cache:
        cache[mesh] = replicated(model, mesh)
    return cache[mesh]


@torch.no_grad()
def sync_replicas(models: Sequence[nn.Module]) -> None:
    """Copy the primary's (``models[0]``) parameters into every other
    replica."""
    src = list(models[0].parameters())
    for m in models[1:]:
        for p, q in zip(m.parameters(), src):
            p.copy_(q)


def gather(outs: Sequence, mesh: Mesh):
    """Per-replica outputs concatenated on axis 0 in replica order, on the
    primary (tensors, or tuples / lists of them)."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(mesh.primary) for o in outs])
    if isinstance(first, (list, tuple)):
        return type(first)(gather([o[i] for o in outs], mesh)
                           for i in range(len(first)))
    raise TypeError(f"cannot gather {type(first).__name__}")


def reduce_grads(grads: Sequence[dict], mesh: Mesh) -> dict:
    """``{name: sum over replicas}`` on the primary, summed in replica
    order; a name whose gradient is None on every replica stays None."""
    out = {}
    for name in grads[0]:
        total = None
        for g in grads:
            t = g[name]
            if t is None:
                continue
            t = t.to(mesh.primary)
            total = t.clone() if total is None else total + t
        out[name] = total
    return out
