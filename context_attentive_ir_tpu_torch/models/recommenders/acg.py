"""ACG: attend-copy-generate query suggestion (Dehghani et al. 2017; port
of ``context_attentive_ir_tpu/models/recommenders/acg.py``).

Seq2seq over the concatenated session queries (``Seq2seq``'s encoder,
decoder and generator, always over the flat source) plus a copy mechanism:
a gate ``copy_gate`` (``Dense(H2, 1)``) mixes the generator's softmax with
the decoder's attention over the source tokens, scattered onto the
vocabulary.  The model returns the normalised mixture probabilities, so its
loss is ``copy_generator_nll_loss`` and its decode scores are ``log(p)``.

The JAX model scatters with one ``align @ one_hot(source, V)`` einsum (a
matmul on the TPU's matrix unit); the port adds the alignment into the
vocabulary axis with ``scatter_add_`` in float32, the same sums in another
order, and never builds the ``[B, T, S*Lq, V]`` one-hot (1.92 GB in float32
at B = 64, S*Lq = 150, V = 50,000).
"""

from __future__ import annotations

import torch

from ...config import ModelConfig
from ...data.vectorize import SuggestBatch
from ...device import resolve_device
from ...ops.layers import Dense, reset_parameters
from ..base import compute_dtype
from ..losses import copy_generator_nll_loss
from .seq2seq import Seq2seq


class ACG(Seq2seq):
    model_type = "acg"
    # ``forward`` returns the mixture's probabilities, not logits
    target_nll = staticmethod(copy_generator_nll_loss)

    def __init__(self, config: ModelConfig, device="cuda",
                 seed: int | None = 0):
        super().__init__(config, device=device, seed=None)
        dev = resolve_device(device)
        self.copy_gate = Dense(self.h2, 1, dtype=compute_dtype(config),
                               device=dev)
        if seed is not None and dev.type != "meta":
            reset_parameters(self, seed)

    def encode(self, batch: SuggestBatch, deterministic: bool = True,
               generator: torch.Generator | None = None):
        """The flat source, whatever ``ablate_history`` says (as in JAX:
        the copy scatter reads the source tokens)."""
        return self._encode(batch.source, batch.source_mask, deterministic,
                            generator)

    def _mix(self, attn_h: torch.Tensor, align: torch.Tensor,
             source: torch.Tensor, source_mask: torch.Tensor
             ) -> torch.Tensor:
        """The mixture ``(1 - p_copy) * softmax(gen) + p_copy * copy``
        ``[..., V]`` (JAX ``ACG._mix``): ``attn_h [..., H2]``, ``align
        [..., S]`` over source ids ``[..., S]`` (broadcast against
        ``align``'s leading axes) and their mask."""
        gen = torch.softmax(self.generator(attn_h, self.embeddings), dim=-1)
        p_copy = torch.sigmoid(self.copy_gate(attn_h))           # [..., 1]
        align = align * source_mask.to(align.dtype)
        align = align / align.sum(-1, keepdim=True).clamp_min(1e-10)
        index = source.expand(align.shape)
        copy = torch.zeros((*align.shape[:-1], gen.shape[-1]),
                           dtype=torch.float32, device=gen.device)
        copy = copy.scatter_add_(-1, index, align.float()).to(gen.dtype)
        return (1.0 - p_copy) * gen + p_copy * copy

    def forward(self, batch: SuggestBatch, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Normalised probabilities ``[B, Lt, V]`` (not logits)."""
        attn_hs, aligns = self._unroll(batch, deterministic, generator)
        return self._mix(attn_hs, aligns, batch.source[:, None, :],
                         batch.source_mask[:, None, :])

    def decode_kwargs(self, batch: SuggestBatch) -> dict:
        """The source ids and mask that ``decode_step``'s copy mixture
        scatters onto the full vocabulary, one row per batch row (a caller
        repeats them per beam).  With them the decoders take this logits
        step: no fused generator step and no shortlist, as in JAX."""
        return {"source": batch.source, "source_mask": batch.source_mask}

    @torch.inference_mode()
    def decode_step(self, state, tokens, memory, memory_mask,
                    source: torch.Tensor | None = None,
                    source_mask: torch.Tensor | None = None):
        """Without ``source``: (state, raw logits [R, V], align).  With the
        (beam-repeated) ``source`` ids and mask: the copy path, (state,
        ``log(max(p, 1e-10))`` [R, V], align) -- already normalised, so the
        decoders' log-softmax shifts it by about 0."""
        state, attn_h, align = self.decoder.step(state, self.embeddings(tokens),
                                                 memory, memory_mask)
        if source is None:
            return state, self.generator(attn_h, self.embeddings), align
        probs = self._mix(attn_h, align, source, source_mask)
        return state, torch.log(probs.clamp_min(1e-10)), align
