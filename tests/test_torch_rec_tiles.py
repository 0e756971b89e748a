"""What surrounds kernel 6's bf16 tensor-core route (``csrc/lstm_rec.cu``,
``ops/kernels/lstm.py``) on the host: the shared-memory sum at and beyond its
limit (``rec_smem_bytes``), the route between the tensor-core and the
CUDA-core kernels (``rec_tensor_cores``), the hidden sizes the wrapper
holds (any multiple of 128: above 512 the step route, ``tests/
test_torch_step_lstm.py``), the staged W_hh the kernel keeps resident, and a plain-PyTorch
emulation of the tensor-core kernel's tile walk held to the JAX package.

The emulation follows ``lstm_rec_mma_kernel``: blocks of M = 64 rows (the
kernel's two 32-row groups of a block run the same arithmetic on their own
rows), the tail block's rows past B zero in the x_proj tile and never
written; per step in processing order the x_proj tile of the block's rows
starts the f32 accumulators, ``bf16(h) @ W_hh`` is added from the staged h tile and the
resident staged W_hh, the cell update keeps c in f32, and a masked step
carries (h, c) and writes 0.

JAX side: ``_lstm_pallas_fwd_impl`` in Pallas interpret mode (block 16, time
chunk 4) and ``lstm_pallas_reference`` (the scan), at f32: tolerance 2e-5
abs, as ``tests/test_torch_lstm_rec.py`` (f32 sums of 128 terms in another
order).  At bf16 the emulation is held to the port's plain version within
2e-2 of max |plain| (the kernel's tolerance on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from context_attentive_ir_tpu.ops.pallas.lstm import (
    _lstm_pallas_fwd_impl,
    lstm_pallas_reference,
)
from context_attentive_ir_tpu_torch.ops.kernels import lstm as L

TOL = 2e-5
BF16, F32 = torch.bfloat16, torch.float32


def _inputs(seed, b, t, h=128, masks="front"):
    """Row 0 fully valid and, with two rows or more, row 1 fully masked."""
    rng = np.random.RandomState(seed)
    x_proj = (rng.normal(size=(b, t, 4 * h)) * 0.5).astype(np.float32)
    w_hh = (rng.normal(size=(h, 4 * h)) * 0.3).astype(np.float32)
    if masks == "front":
        lens = rng.randint(0, t + 1, size=(b,))
        mask = np.arange(t)[None, :] < lens[:, None]
    else:   # interior gaps
        mask = rng.rand(b, t) < 0.6
    mask[0] = True
    if b > 1:
        mask[1] = False
    return x_proj, mask, w_hh


def _max_err(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# -- shared memory, the route and the wrapper's limits -------------------------

@pytest.mark.parametrize("h,n_bytes", [
    (128, 64 + 133_120 + 66_560 + 17_408),   # the main path: 217,152
    (64, 64 + (64 + 64) * 528 + 64 * 144),   # fits, but H % 128 != 0
    (160, 0),     # W_hh and the tiles: 311,872 bytes
    (256, 0),     # W_hh alone is 528,384 bytes
    (512, 0),
    (100, 0),     # not a multiple of 32
])
def test_rec_smem_bytes_at_and_beyond_the_limit(h, n_bytes):
    assert L.rec_smem_bytes(h) == n_bytes
    assert n_bytes <= L.SMEM_LIMIT


def test_the_main_path_fits_one_block_of_64_rows():
    """H = 128, blocks of 64 rows (two groups of 32 rows and 8 warps); the
    resident W_hh is the staged matrix's bytes."""
    assert L.REC_HIDDEN == 128 and L.REC_ROWS == 64
    staged = L.stage_lstm_weights(torch.zeros((0, 512)),
                                  torch.zeros((128, 512)))
    w_bytes = staged.numel() * 2   # bf16 on the card
    assert w_bytes == 133_120
    assert L.rec_smem_bytes(128) == (64 + w_bytes + 64 * (8 * 128 + 16)
                                     + 64 * (2 * 128 + 16))
    assert L.SMEM_LIMIT - L.rec_smem_bytes(128) == 15_296


@pytest.mark.parametrize("h,dtype,tensor_cores", [
    (128, BF16, True),
    (128, F32, False),    # float32 keeps the CUDA-core kernel
    (256, BF16, False),   # W_hh does not fit: the CUDA-core kernel
    (384, BF16, False),
    (512, BF16, False),
    (640, BF16, False),
    (64, BF16, False),    # not a hidden size the wrapper holds
])
def test_route(h, dtype, tensor_cores):
    assert L.rec_tensor_cores(h, dtype) is tensor_cores


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("h", [128, 256, 384, 512])
def test_wrapper_holds_every_hidden_size_up_to_512(h, dtype):
    xp, mask, whh = (torch.from_numpy(a) for a in _inputs(0, 3, 2, h))
    assert L._check_rec_args(xp.to(dtype), mask, whh.to(dtype)) == (3, 2, h)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("h,why", [(704, "multiple of 128"),
                                   (192, "multiple of 128"),
                                   (64, "multiple of 128")])
def test_wrapper_refuses_other_hidden_sizes(h, why, dtype):
    xp, mask, whh = (torch.from_numpy(a) for a in _inputs(0, 3, 2, h))
    with pytest.raises(ValueError, match=why):
        L._check_rec_args(xp.to(dtype), mask, whh.to(dtype))


@pytest.mark.parametrize("h", [128, 256])
def test_staged_w_hh_is_the_resident_layout(h):
    """``stage_lstm_weights`` with an empty W_ih: one [H, 4H + 8] matrix, 8
    zero columns a row, so row r is the contiguous range r * (8H + 16) ..
    r * (8H + 16) + 8H bytes and the whole is one bulk copy."""
    w = torch.from_numpy(_inputs(1, 1, 1, h)[2]).to(BF16)
    staged = L.stage_lstm_weights(w[:0], w)
    assert staged.shape == (h, 4 * h + 8) and staged.is_contiguous()
    assert staged.dtype == BF16 and staged.data_ptr() % 16 == 0
    assert staged.stride(0) * staged.element_size() == 8 * h + 16
    assert torch.equal(staged[:, :4 * h], w)
    assert not staged[:, 4 * h:].any()
    flat = staged.reshape(-1)
    for r in (0, h // 2, h - 1):
        row = flat[r * (4 * h + 8):r * (4 * h + 8) + 4 * h]
        assert torch.equal(row, w[r])


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_wrapper_takes_plain_version_on_cpu(dtype, monkeypatch):
    monkeypatch.setattr(L.lstm_recurrence, "launches", 0)
    xp, mask, whh = (torch.from_numpy(a) for a in _inputs(2, 5, 3))
    xp, whh = xp.to(dtype), whh.to(dtype)
    want = L.lstm_recurrence_reference(xp, mask, whh, True)
    assert torch.equal(L.lstm_recurrence_fwd(xp, mask, whh, True, "cpu"),
                       want)
    assert L.lstm_recurrence.launches == 0


# -- the tile walk at ragged shapes, against JAX -------------------------------

def tile_walk(x_proj, mask, w_hh, reverse):
    """Kernel 6's tensor-core algorithm in plain PyTorch (see the module
    note): ``out [B, T, H]`` in x_proj's dtype."""
    B, T, G = x_proj.shape
    H = G // 4
    M = L.REC_ROWS
    w = L.stage_lstm_weights(w_hh[:0], w_hh)[:, :G].float()   # resident
    out = torch.zeros((B, T, H), dtype=x_proj.dtype)
    for row0 in range(0, B, M):
        valid = min(M, B - row0)
        x_tile = torch.zeros((M, G))   # rows past B stay zero
        h_tile = torch.zeros((M, H))   # bf16(h) as the product reads it
        c = torch.zeros((M, H))
        for s in range(T):
            t = T - 1 - s if reverse else s
            x_tile[:valid] = x_proj[row0:row0 + valid, t].float()
            acc = x_tile + h_tile @ w
            i, f, g, o = acc.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            m = torch.zeros((M, 1), dtype=torch.bool)
            m[:valid, 0] = mask[row0:row0 + valid, t]
            c = torch.where(m, c_new, c)
            v = torch.where(m, h_new, torch.zeros(())).to(x_proj.dtype)
            h_tile = torch.where(m, v.float(), h_tile)
            out[row0:row0 + valid, t] = v[:valid]
    return out


# (rows, T): one row, one short of the 64-row block, one past it with T = 1,
# two blocks and a tail; T off the JAX time chunk (4) throughout
RAGGED = [(1, 5), (63, 9), (65, 1), (130, 6)]


@pytest.mark.parametrize("masks", ["front", "interior"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t", RAGGED)
def test_tile_walk_matches_jax_at_ragged_shapes(b, t, reverse, masks):
    xp, mask, whh = _inputs(3, b, t, masks=masks)
    jx = [jnp.asarray(a) for a in (xp, mask, whh)]
    kernel = _lstm_pallas_fwd_impl(*jx, reverse=reverse, block_b=16,
                                   time_chunk=4, interpret=True)
    scan = lstm_pallas_reference(*jx, reverse=reverse)
    got = tile_walk(*(torch.from_numpy(a) for a in (xp, mask, whh)), reverse)
    assert got.dtype == F32 and tuple(got.shape) == (b, t, 128)
    assert _max_err(got, kernel) <= TOL
    assert _max_err(got, scan) <= TOL
    assert (got.numpy()[~mask] == 0).all()
    if b > 1:
        assert not got[1].any()   # the fully masked row


@pytest.mark.parametrize("masks", ["front", "interior"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t", RAGGED)
def test_tile_walk_bf16_holds_the_plain_version(b, t, reverse, masks):
    xp, mask, whh = _inputs(4, b, t, masks=masks)
    xp, mask, whh = (torch.from_numpy(a) for a in (xp, mask, whh))
    xp, whh = xp.to(BF16), whh.to(BF16)
    got = tile_walk(xp, mask, whh, reverse)
    ref = L.lstm_recurrence_reference(xp, mask, whh, reverse)
    assert got.dtype == BF16
    assert _max_err(got, ref.float()) <= 2e-2 * float(ref.float().abs().max())
    assert (got[~mask] == 0).all()
