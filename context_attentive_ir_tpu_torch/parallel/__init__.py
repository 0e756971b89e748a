"""Data parallelism over a ``('data',)`` mesh of replicas, driven by one
process (port of ``context_attentive_ir_tpu/parallel``)."""

from .mesh import (
    DATA_AXIS,
    Mesh,
    gather,
    make_mesh,
    model_replicas,
    pad_to_multiple,
    reduce_grads,
    replicated,
    shard_batch,
    split_batch,
    sync_replicas,
    to_device,
)

__all__ = ["DATA_AXIS", "Mesh", "gather", "make_mesh", "model_replicas",
           "pad_to_multiple", "reduce_grads", "replicated", "shard_batch",
           "split_batch", "sync_replicas", "to_device"]
