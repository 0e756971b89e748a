"""Fused query-aware attention pool (kernel 10).

Replaces the TPU kernel ``_pool_kernel`` reached through
``_pool_fused_impl`` / ``attn_pool_pallas`` in
``context_attentive_ir_tpu/ops/pallas/slate.py``: for every row (a
candidate document), pool its ``[T, H]`` token states into one vector
attended by the row's query vector,

    h_t    = tanh(states_t @ W_p + b_p)
    s_t    = h_t . q
    pooled = sum_t softmax_masked(s)_t * states_t

reading the tokens once with the softmax's max, sum and weighted sum in
float32 (masked tokens score -1e30 and weigh 0), so the ``[R, T, H]``
projection never reaches device memory.  A fully masked row pools to
exactly 0.  The output has the states' dtype.

The kernel is ``csrc/slate_pool.cu``.  In bfloat16 at H = 128 and 256
with 1 <= T <= 64 (``pool_tensor_cores``) it runs the projection as the
GEMM ``[R*T, H] @ [H, H]`` on tensor cores (``mma.sync.m16n8k16``, bf16 in,
f32 accumulate): a persistent block per SM stages W_p once in shared memory
and walks tiles of whole documents (``pool_tiles``: 64 token rows, each
document's T padded to a multiple of 16), copied by ``cp.async.bulk`` into
one buffer while it works on the other; the scores come out of the
accumulators' epilogue, each document takes its masked softmax over its T
scores at once, and the pooled vector is summed off the staged tile in
f32.  That per-document softmax differs from the online one only in
rounding.  float32, H = 384 and 512 (whose W_p does not fit in shared
memory) and T above one tile keep the first version: a block owns 64 rows
(32 when H > 256), stages each token's states in f32 and runs the
projection on CUDA cores with an online softmax.

Bound on the H100 (CARS slate, R = B*S*N = 16,000 rows, T = 30, H = 256,
bf16): 2*R*T*H^2 = 6.3e10 flops (0.064 ms at the bf16 tensor-core peak)
against 262 MB of states, queries and output (0.078 ms): memory-bound with
the projection on tensor cores (on CUDA cores alone it needs >= 0.94 ms).
``PERF.md`` records the times.

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


# the bf16 tensor-core kernel (csrc/slate_pool.cu, slate_pool_tc_kernel)
SMEM_LIMIT = 232448   # dynamic shared memory a block may use on sm_90
TILE_ROWS = 64        # token rows of a document tile
MAX_DOCS = TILE_ROWS // 16


def pool_tiles(steps: int) -> tuple[int, int]:
    """(padded T, documents a tile) of the tensor-core kernel: each
    document's ``steps`` tokens padded to a multiple of 16, as many whole
    documents as ``TILE_ROWS`` rows hold."""
    t_pad = -(-steps // 16) * 16
    return t_pad, TILE_ROWS // t_pad


def pool_smem_bytes(hidden: int) -> int:
    """Dynamic shared memory of the tensor-core kernel at width ``hidden``
    (``tc_smem`` in ``csrc/slate_pool.cu``): the buffers' mbarriers (64
    bytes), W_p and two buffers of ``TILE_ROWS`` token rows in bf16 (rows
    padded by 16 bytes), two buffers' queries, the score exchange (8 warps
    x ``TILE_ROWS`` f32), the softmax weights and denominators."""
    row = 2 * hidden + 16
    return (64 + hidden * row + 2 * TILE_ROWS * row + 2 * MAX_DOCS * hidden
            * 2 + 8 * TILE_ROWS * 4 + TILE_ROWS * 4 + MAX_DOCS * 4)


def pool_tensor_cores(hidden: int, steps: int, dtype: torch.dtype) -> bool:
    """Whether ``attn_pool`` runs the tensor-core kernel for this shape (the
    launcher's gate): bfloat16, H = 128 or 256 (W_p and both buffers fit a
    block's shared memory; at H = 384 W_p alone does not), and a document
    fits one tile (1 <= T <= ``TILE_ROWS``).  Every other shape that
    ``pool_supported`` holds runs the CUDA-core kernel."""
    return (dtype == torch.bfloat16 and hidden in (128, 256)
            and 1 <= steps <= TILE_ROWS
            and pool_smem_bytes(hidden) <= SMEM_LIMIT)


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

    On CUDA tensors this launches ``cair_slate_pool`` (the tensor-core
    kernel where ``pool_tensor_cores`` says so, the CUDA-core kernel
    otherwise); on CPU tensors (``device="cpu"``) it runs
    ``attn_pool_reference``.  It computes no gradient (``AttnPoolFn`` is the
    differentiable form)."""
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
