"""CARS: Context Attentive document-Ranking and query-Suggestion (port of
``context_attentive_ir_tpu/models/multitask/cars.py``).

Same structure as the JAX model: encoders run over flattened ``[B*S(,N)]``
slates (LSTM or GRU, ``rnn_type``); the two session recurrences (query
flow, click flow; ``session_rnn_type``) run over the S turns; context attention over previous turns is one causally-masked
attention over the 2S-slot (query-flow + click-flow) memory, gated into the
query vector; the ranking head scores the whole ``[B, S, N]`` slate in one
MLP; the suggestion head is an attention LSTM decoder over ``[B*S]`` rows
with a tied generator (or an untied one, ``tie_embeddings=False``, which
decodes through the logits step).  Parameter names mirror the JAX tree, so
``convert.params_from_jax`` is a rename.

``forward`` is the training forward (scores and teacher-forced generator
logits); ``deterministic`` and a dropout ``generator`` are threaded through
the embeddings, encoders, ranking MLP and decoder as the JAX model threads
``deterministic``.  The inference methods run under
``torch.inference_mode`` with dropout off.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...config import ModelConfig
from ...data.vectorize import SessionBatch
from ...device import resolve_device
from ...ops.attention import AttentionPool
from ...ops.decoder import AttnLSTMDecoder
from ...ops.layers import MLP, Dense, reset_parameters
from ...ops.masking import masked_softmax
from ...ops.rnn import RNNEncoder, RNNLayer
from ..base import check_rnn_types, compute_dtype, make_embeddings
from ..generator import Generator


def clicks_exceed_suggest_cap(batch: SessionBatch, cap: int) -> bool:
    """Host-side guard for ``encode_session_suggest``'s exactness boundary:
    True when any turn has more than ``cap`` clicked candidates, i.e. the
    fast ``decode_init`` would drop clicks.  Call on numpy batches."""
    clicks = np.asarray(batch.clicks) * np.asarray(batch.cand_mask)
    if clicks.size == 0:
        return False
    return int((clicks > 0).sum(axis=-1).max()) > cap


class CARS(nn.Module):
    """``seed`` fills the weights from a seeded CPU generator; ``seed=None``
    leaves them uninitialised, for loading a state dict (and on the
    ``meta`` device, for reading the parameter names and shapes)."""

    def __init__(self, config: ModelConfig, device="cuda",
                 seed: int | None = 0):
        super().__init__()
        cfg = config
        if cfg.model_type != "cars":
            raise ValueError(f"CARS needs model_type 'cars', got "
                             f"{cfg.model_type!r}")
        check_rnn_types(cfg)
        if cfg.cars_ablation not in ("none", "no_click_flow",
                                     "no_context_attn"):
            raise ValueError(f"unknown cars_ablation {cfg.cars_ablation!r}")
        dev = resolve_device(device)
        dt = compute_dtype(cfg)
        self.config = cfg
        h2 = cfg.nhid * (2 if cfg.bidirection else 1)
        self.embeddings = make_embeddings(cfg, dev)
        for name in ("query_encoder", "doc_encoder"):
            self.add_module(name, RNNEncoder(
                cfg.emsize, cfg.nhid, cfg.nlayers, cfg.bidirection,
                use_kernel=cfg.use_pallas_rnn, dtype=dt, device=dev,
                dropout=cfg.dropout_rnn, rnn_type=cfg.rnn_type))
        self.query_pool = AttentionPool(h2, h2, use_query=False, dtype=dt,
                                        device=dev)
        self.doc_pool = AttentionPool(h2, h2, use_query=True, dtype=dt,
                                      device=dev,
                                      use_kernel=cfg.use_pallas_slate)
        # the session recurrences take no kernel, as in JAX (their click
        # mask has interior gaps: a turn without a click)
        self.query_flow = RNNLayer(h2, h2, bidirectional=False, dtype=dt,
                                   device=dev, rnn_type=cfg.session_rnn_type)
        # an ablation drops the layers it never calls, as the JAX param
        # tree does (flax creates parameters only for called submodules)
        if cfg.cars_ablation != "no_click_flow":
            self.click_flow = RNNLayer(h2, h2, bidirectional=False, dtype=dt,
                                       device=dev,
                                       rnn_type=cfg.session_rnn_type)
        if cfg.cars_ablation != "no_context_attn":
            self.ctx_wq = Dense(h2, h2, dtype=dt, device=dev)
            self.ctx_wm = Dense(h2, h2, use_bias=False, dtype=dt, device=dev)
            self.ctx_v = Dense(h2, 1, use_bias=False, dtype=dt, device=dev)
            self.ctx_gate = Dense(2 * h2, h2, dtype=dt, device=dev)
        self.rank_mlp = MLP(3 * h2, (cfg.nhid_ffnn, 1), activation=torch.tanh,
                            final_activation=False, dtype=dt, device=dev,
                            dropout=cfg.dropout)
        self.mem_proj = Dense(2 * h2, h2, dtype=dt, device=dev)
        self.init_proj = Dense(3 * h2, h2, dtype=dt, device=dev)
        self.decoder = AttnLSTMDecoder(h2, cfg.emsize, cfg.nlayers,
                                       cfg.attn_type, dtype=dt, device=dev,
                                       dropout=cfg.dropout_rnn)
        self.generator = Generator(h2, self.embeddings,
                                   tie=cfg.tie_embeddings,
                                   vocab_size=cfg.vocab_size, dtype=dt,
                                   device=dev)
        if seed is not None and dev.type != "meta":
            reset_parameters(self, seed)

    # -- session encoding ----------------------------------------------------

    def encode_docs(self, docs: torch.Tensor, doc_mask: torch.Tensor,
                    deterministic: bool = True,
                    generator: torch.Generator | None = None) -> torch.Tensor:
        """Query-independent document token states: docs [..., Ld] ->
        [..., Ld, H2]."""
        lead, Ld = docs.shape[:-1], docs.shape[-1]
        d = self.embeddings(docs, deterministic, generator)
        d_states, _ = self.doc_encoder(d.reshape(-1, Ld, d.shape[-1]),
                                       doc_mask.reshape(-1, Ld),
                                       deterministic, generator)
        return d_states.reshape(*lead, *d_states.shape[-2:])

    def encode_docs_proj(self, d_states: torch.Tensor) -> torch.Tensor:
        """The query-independent half of the doc pooling, ``tanh(d_states
        @ W_p + b_p)``: cacheable per corpus beside ``encode_docs``."""
        return self.doc_pool(d_states, proj_only=True)

    def _encode_queries(self, batch: SessionBatch, deterministic: bool = True,
                        generator: torch.Generator | None = None):
        B, S, Lq = batch.query.shape
        q = self.embeddings(batch.query, deterministic, generator)
        q_states, _ = self.query_encoder(q.reshape(B * S, Lq, -1),
                                         batch.query_mask.reshape(B * S, Lq),
                                         deterministic, generator)
        q_states = q_states.reshape(B, S, Lq, -1)
        qv = self.query_pool(q_states, batch.query_mask)        # [B, S, H2]
        return q_states, qv

    @staticmethod
    def _per_candidate(qv: torch.Tensor, d_states: torch.Tensor):
        return qv[:, :, None, :].expand(*d_states.shape[:3], qv.shape[-1])

    def encode_session(self, batch: SessionBatch,
                       d_states: torch.Tensor | None = None,
                       d_proj: torch.Tensor | None = None,
                       deterministic: bool = True,
                       generator: torch.Generator | None = None):
        q_states, qv = self._encode_queries(batch, deterministic, generator)
        if d_states is None:
            d_states = self.encode_docs(batch.docs, batch.doc_mask,
                                        deterministic, generator)
        # query-aware pooling: each candidate pools its tokens w.r.t. its
        # query vector
        dv = self.doc_pool(d_states, batch.doc_mask,
                           self._per_candidate(qv, d_states),
                           proj_states=d_proj)                  # [B,S,N,H2]
        sq, _ = self.query_flow(qv, batch.turn_mask)            # [B, S, H2]
        if self.config.cars_ablation == "no_click_flow":
            sc = torch.zeros_like(sq)
        else:
            clicks = batch.clicks * batch.cand_mask.to(batch.clicks.dtype)
            n_clicks = clicks.sum(-1, keepdim=True).clamp_min(1.0)
            click_repr = torch.einsum("bsn,bsnh->bsh",
                                      (clicks / n_clicks).to(dv.dtype), dv)
            has_click = (clicks.sum(-1) > 0) & batch.turn_mask
            sc, _ = self.click_flow(click_repr, has_click)      # [B, S, H2]
        return q_states, qv, dv, sq, sc

    def encode_session_suggest(self, batch: SessionBatch):
        """Suggestion-only session encoding: encode only the top
        ``suggest_max_clicks`` clicked candidates of each turn (exact while
        no turn has more clicks; ``clicks_exceed_suggest_cap`` detects the
        boundary on the host)."""
        cfg = self.config
        q_states, qv = self._encode_queries(batch)
        sq, _ = self.query_flow(qv, batch.turn_mask)
        if cfg.cars_ablation == "no_click_flow":
            return q_states, qv, sq, torch.zeros_like(sq)
        clicks = batch.clicks * batch.cand_mask.to(batch.clicks.dtype)
        C = min(cfg.suggest_max_clicks, clicks.shape[-1])
        # lax.top_k order: descending, ties to the lower index
        cw, cidx = torch.sort(clicks, dim=-1, descending=True, stable=True)
        cw, cidx = cw[..., :C], cidx[..., :C]                   # [B, S, C]
        Ld = batch.docs.shape[-1]
        gidx = cidx[..., None].expand(*cidx.shape, Ld)
        docs_c = torch.gather(batch.docs, 2, gidx)
        mask_c = torch.gather(batch.doc_mask, 2, gidx) & (cw[..., None] > 0)
        d_states = self.encode_docs(docs_c, mask_c)
        dv_c = self.doc_pool(d_states, mask_c,
                             self._per_candidate(qv, d_states))
        n_clicks = cw.sum(-1, keepdim=True).clamp_min(1.0)
        click_repr = torch.einsum("bsc,bsch->bsh",
                                  (cw / n_clicks).to(dv_c.dtype), dv_c)
        has_click = (cw.sum(-1) > 0) & batch.turn_mask
        sc, _ = self.click_flow(click_repr, has_click)
        return q_states, qv, sq, sc

    def context_attend(self, qv, sq, sc, turn_mask):
        """Gated attention over all previous query-flow + click-flow states
        (2S memory slots; turn t sees slots of turns < t).  Ablations as in
        the JAX model: ``no_context_attn`` passes the query vector through,
        ``no_click_flow`` keeps only the S query-flow slots."""
        ablation = self.config.cars_ablation
        if ablation == "no_context_attn":
            return qv
        S = sq.shape[1]
        tri = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                    device=sq.device), diagonal=-1)
        if ablation == "no_click_flow":
            memory = sq                                         # [B, S, H]
            cmask = tri[None] & turn_mask[:, None, :]
        else:
            memory = torch.cat([sq, sc], dim=1)                 # [B, 2S, H]
            cmask = (torch.cat([tri, tri], dim=1)[None]
                     & torch.cat([turn_mask, turn_mask], -1)[:, None, :])
        scores = self.ctx_v(torch.tanh(
            self.ctx_wq(qv)[:, :, None, :]
            + self.ctx_wm(memory)[:, None, :, :]))[..., 0]      # [B, S, 2S]
        align = masked_softmax(scores, cmask, dim=-1)
        context = torch.einsum("btm,bmh->bth", align, memory)
        g = torch.sigmoid(self.ctx_gate(torch.cat([qv, context], dim=-1)))
        has_ctx = cmask.any(-1)[..., None].to(qv.dtype)
        g = g * has_ctx + (1.0 - has_ctx)
        return g * qv + (1.0 - g) * context

    def rank_scores(self, q_ctx, dv, deterministic: bool = True,
                    generator: torch.Generator | None = None):
        qb = q_ctx[:, :, None, :].expand_as(dv)
        feats = torch.cat([qb, dv, qb * dv], dim=-1)
        return self.rank_mlp(feats, deterministic,
                             generator)[..., 0]                 # [B, S, N]

    def _decoder_inputs(self, q_states, q_ctx, sq, sc, batch):
        """Context-enriched decoder memory + init state, flattened [B*S]."""
        B, S, Lq = batch.query.shape
        if self.config.cars_ablation == "no_context_attn":
            # no history reaches either head under this ablation
            sq, sc = torch.zeros_like(sq), torch.zeros_like(sc)
        ctx_b = q_ctx[:, :, None, :].expand(*q_states.shape[:3],
                                            q_ctx.shape[-1])
        memory = torch.tanh(self.mem_proj(
            torch.cat([q_states, ctx_b], dim=-1)))              # [B,S,Lq,H2]
        init = torch.tanh(self.init_proj(
            torch.cat([q_ctx, sq, sc], dim=-1)))                # [B, S, H2]
        return (memory.reshape(B * S, Lq, -1),
                batch.query_mask.reshape(B * S, Lq),
                init.reshape(B * S, -1))

    # -- training forward ----------------------------------------------------

    def forward(self, batch: SessionBatch, deterministic: bool = True,
                generator: torch.Generator | None = None) -> dict:
        """``{"scores" [B, S, N], "gen_logits" [B, S, Lt, V]}``: the slate
        scores and the teacher-forced suggestion logits (JAX
        ``CARS.__call__``).  ``deterministic=False`` turns dropout on, its
        noise drawn from ``generator``."""
        B, S, _ = batch.query.shape
        Lt = batch.target_in.shape[-1]
        q_states, qv, dv, sq, sc = self.encode_session(
            batch, deterministic=deterministic, generator=generator)
        q_ctx = self.context_attend(qv, sq, sc, batch.turn_mask)
        scores = self.rank_scores(q_ctx, dv, deterministic, generator)
        memory, mem_mask, init = self._decoder_inputs(q_states, q_ctx, sq,
                                                      sc, batch)
        tgt = self.embeddings(batch.target_in, deterministic, generator)
        attn_hs, _ = self.decoder(tgt.reshape(B * S, Lt, -1), memory,
                                  mem_mask, init, deterministic, generator)
        logits = self.generator(attn_hs, self.embeddings)
        return {"scores": scores, "gen_logits": logits.reshape(B, S, Lt, -1)}

    # -- inference -----------------------------------------------------------

    @torch.inference_mode()
    def score(self, batch: SessionBatch,
              d_states: torch.Tensor | None = None,
              d_proj: torch.Tensor | None = None) -> torch.Tensor:
        """Slate scores [B, S, N]."""
        _, qv, dv, sq, sc = self.encode_session(batch, d_states, d_proj)
        q_ctx = self.context_attend(qv, sq, sc, batch.turn_mask)
        return self.rank_scores(q_ctx, dv)

    @torch.inference_mode()
    def decode_init(self, batch: SessionBatch):
        q_states, qv, sq, sc = self.encode_session_suggest(batch)
        q_ctx = self.context_attend(qv, sq, sc, batch.turn_mask)
        memory, mem_mask, init = self._decoder_inputs(q_states, q_ctx, sq,
                                                      sc, batch)
        return self.decoder.init_state(memory.shape[0], init), memory, mem_mask

    @torch.inference_mode()
    def decode_init_full(self, batch: SessionBatch):
        """Exact decode init at any clicks-per-turn count (full slate)."""
        q_states, qv, _dv, sq, sc = self.encode_session(batch)
        q_ctx = self.context_attend(qv, sq, sc, batch.turn_mask)
        memory, mem_mask, init = self._decoder_inputs(q_states, q_ctx, sq,
                                                      sc, batch)
        return self.decoder.init_state(memory.shape[0], init), memory, mem_mask

    def decode_kwargs(self, batch: SessionBatch) -> dict:
        """Extra per-row tensors ``decode_step`` takes (none here)."""
        return {}

    @torch.inference_mode()
    def decode_step(self, state, tokens, memory, memory_mask):
        """-> (state, raw logits [R, V], align)."""
        state, attn_h, align = self.decoder.step(state, self.embeddings(tokens),
                                                 memory, memory_mask)
        return state, self.generator(attn_h, self.embeddings), align

    @torch.inference_mode()
    def decode_step_fused(self, state, tokens, memory, memory_mask):
        """``decode_step`` minus the generator matmul: returns the tied
        E-dim projection for the fused generator kernel."""
        state, attn_h, align = self.decoder.step(state, self.embeddings(tokens),
                                                 memory, memory_mask)
        return (state, self.generator(attn_h, self.embeddings,
                                      project_only=True), align)
