"""Fused query-aware attention pool (kernel 10).

Replaces the TPU kernel ``_pool_kernel`` reached through
``_pool_fused_impl`` / ``attn_pool_pallas`` in
``context_attentive_ir_tpu/ops/pallas/slate.py``: for every row (a
candidate document), pool its ``[T, H]`` token states into one vector
attended by the row's query vector,

    h_t    = tanh(states_t @ W_p + b_p)
    s_t    = h_t . q
    pooled = sum_t softmax_masked(s)_t * states_t

streaming the tokens once with an online softmax (running max, sum and
weighted sum in float32; masked tokens score -1e30 and weigh 0), so the
``[R, T, H]`` projection never reaches device memory.  A fully masked row
pools to exactly 0.  The output has the states' dtype.

The kernel is ``csrc/slate_pool.cu``: a block owns 64 rows (32 when
H > 256); per token it stages the rows' states in shared memory as f32,
computes ``states_t @ W_p`` with CUDA-core FMAs (W_p in shared memory for
bf16 at H <= 256, from L2 otherwise), then the scores and the softmax
update from registers.

Bound on the H100 (CARS slate, R = B*S*N = 16,000 rows, T = 30, H = 256,
bf16): 2*R*T*H^2 = 6.3e10 flops (0.064 ms at the bf16 tensor-core peak)
against 262 MB of states, queries and output (0.078 ms): memory-bound.
This first version runs the product on CUDA cores, far above that bound;
``PERF.md`` records the gap.

``AttnPoolFn`` is the differentiable form (the JAX ``custom_vjp``): the
kernel forward, and a backward that replays autograd of the plain version,
as the JAX ``_pool_bwd`` replays XLA.  The TPU kernel has no backward
kernel.
"""

from __future__ import annotations

import torch

from ...device import check_on, resolve_device
from ..masking import masked_softmax

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pool_supported(hidden: int, rows: int) -> bool:
    """Whether the fused pool kernel takes this shape (the JAX contract:
    128-aligned features, at least 8 rows)."""
    return hidden % 128 == 0 and rows >= 8


def attn_pool_reference(states: torch.Tensor, mask: torch.Tensor,
                        query: torch.Tensor, w_p: torch.Tensor,
                        b_p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, the JAX ``attn_pool_reference``: states
    [R, T, H], mask bool [R, T], query [R, H] -> pooled [R, H]."""
    h = torch.tanh(states @ w_p + b_p)
    scores = torch.einsum("rth,rh->rt", h, query)
    align = masked_softmax(scores, mask, dim=-1)
    return torch.einsum("rt,rth->rh", align, states)


def _check_cuda_args(states, mask, query, w_p, b_p):
    if states.dtype not in _DTYPES or any(t.dtype != states.dtype
                                          for t in (query, w_p, b_p)):
        raise TypeError("attn_pool: states, query, w_p, b_p must share one "
                        f"dtype, float32 or bfloat16; got {states.dtype}, "
                        f"{query.dtype}, {w_p.dtype}, {b_p.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"attn_pool: mask must be bool, got {mask.dtype}")
    if states.dim() != 3:
        raise ValueError("attn_pool: states must be [R, T, H], got "
                         f"{tuple(states.shape)}")
    R, T, H = states.shape
    if (tuple(mask.shape) != (R, T) or tuple(query.shape) != (R, H)
            or tuple(w_p.shape) != (H, H) or tuple(b_p.shape) != (H,)):
        raise ValueError(
            f"attn_pool: shapes states {tuple(states.shape)}, mask "
            f"{tuple(mask.shape)}, query {tuple(query.shape)}, w_p "
            f"{tuple(w_p.shape)}, b_p {tuple(b_p.shape)} do not form one "
            "pool")
    if not pool_supported(H, R):
        raise ValueError(f"attn_pool: the kernel needs H % 128 == 0 and at "
                         f"least 8 rows; got H={H}, R={R}")
    if not all(t.is_contiguous() for t in (states, mask, query, w_p, b_p)):
        raise ValueError("attn_pool needs contiguous tensors")
    return R, T, H


def attn_pool(states: torch.Tensor, mask: torch.Tensor, query: torch.Tensor,
              w_p: torch.Tensor, b_p: torch.Tensor,
              device="cuda") -> torch.Tensor:
    """states [R, T, H], mask bool [R, T], query [R, H], w_p [H, H], b_p
    [H] (one dtype, float32 or bfloat16) -> pooled [R, H] in that dtype.

    On CUDA tensors this launches ``cair_slate_pool``; on CPU tensors
    (``device="cpu"``) it runs ``attn_pool_reference``.  It computes no
    gradient (``AttnPoolFn`` is the differentiable form)."""
    dev = resolve_device(device)
    check_on(dev, states, mask, query, w_p, b_p)
    if dev.type == "cpu":
        return attn_pool_reference(states, mask, query, w_p, b_p)
    if dev.type != "cuda":
        raise ValueError(f"attn_pool runs on cuda or cpu, not {dev}")
    R, T, H = _check_cuda_args(states, mask, query, w_p, b_p)
    out = torch.empty((R, H), dtype=states.dtype, device=states.device)
    from .build import check, load_library

    # the launcher reports a hidden size its blocks cannot hold
    check(load_library().cair_slate_pool(
        states.data_ptr(), mask.data_ptr(), query.data_ptr(),
        w_p.data_ptr(), b_p.data_ptr(), out.data_ptr(), R, T, H,
        _DTYPES[states.dtype],
        torch.cuda.current_stream(states.device).cuda_stream),
        "cair_slate_pool")
    attn_pool.launches += 1
    return out


attn_pool.launches = 0


class AttnPoolFn(torch.autograd.Function):
    """Differentiable pool: ``attn_pool`` forward; the backward replays
    autograd of ``attn_pool_reference`` on the saved inputs (the JAX
    ``_pool_bwd``).  The mask gets no gradient."""

    @staticmethod
    def forward(ctx, states, mask, query, w_p, b_p, device):
        ctx.save_for_backward(states, mask, query, w_p, b_p)
        return attn_pool(states, mask, query, w_p, b_p, device)

    @staticmethod
    def backward(ctx, g):
        states, mask, query, w_p, b_p = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in (states, query, w_p,
                                                         b_p)]
        with torch.enable_grad():
            out = attn_pool_reference(inputs[0], mask, *inputs[1:])
        ds, dq, dw, db = torch.autograd.grad(out, inputs, g)
        return ds, None, dq, dw, db, None


def attn_pool_train(states: torch.Tensor, mask: torch.Tensor,
                    query: torch.Tensor, w_p: torch.Tensor,
                    b_p: torch.Tensor, device="cuda") -> torch.Tensor:
    """``attn_pool``'s output with gradients for states, query, w_p and
    b_p (``AttnPoolFn``)."""
    return AttnPoolFn.apply(states, mask, query, w_p, b_p, device)
