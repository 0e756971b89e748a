"""Split-TF32 tiles of float32 kernels 5 and 9 (``csrc/tf32_mma.cuh``,
``csrc/lstm_mma.cuh``), on the CPU.

- ``tf32``: the rounding of ``cvt.rna.tf32.f32`` (to nearest, ties away
  from zero, on the float32 bit pattern: 10 mantissa bits kept), and
  ``split_mm``, the split product the tiles compute -- each operand split
  into hi = tf32(v) and lo = v - hi rounded toward zero to tf32 (the
  tensor core ignores its low 13 bits), per k step of 8 the three
  products lo*hi, hi*lo, hi*hi added into the f32 accumulator in that
  order (``rev_mm``: the reverse products' order) -- held to the float64
  product within its error bound: a product
  a*b keeps all but the dropped lo*lo term (below 2^-22 |a| |b|) and the
  operands' residues (each below 2^-21 |v|), 5 * 2^-22 |a| |b|, plus
  K * 2^-24 of f32 accumulation over the sum of |a| |b|.
- ``lstm_tiles`` / ``gru_tiles``, an emulation of the float32 phase A of
  kernels 5 and 9 and of phases B and C: the operands zero-padded as the
  wrappers pad them (``f32_tile_hidden``), each rank's staged weights
  (``stage_lstm_weights(..., ranks)``), the recompute ``[x_t | h] @ W``
  in split TF32 from the bias on, the cell in f32, the reverse pass's
  gradient slots times the rank's slab rows in split TF32 (``rev_mm``:
  the k extent split over the warps a tile leaves idle, small and large
  terms, even and odd k steps in accumulators of their own; a single
  block's dx_t from its W_ih rows; in a cluster dx is phase C's product
  with W_ih over all rows), each rank's partial of dh added in rank order,
  dW in split TF32 over the (row, step) pairs, each 32-row slab's sum
  promoted into an f32 one (phase B) -- against the
  JAX package's ``lstm_pallas_fused`` / ``gru_pallas_fused`` backward
  (Pallas interpret mode) at H = 32, 64 and 136, an odd E, one block and
  a cluster of 2.

Tolerances as ``tests/test_torch_lstm_tiles.py``: gradients 2e-5 times the
largest magnitude of the JAX gradient (split TF32 keeps about 22 bits;
dW sums B*T terms in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gru_bwd_tiles import _inputs as _gru_inputs
from test_torch_lstm_tiles import _close_rel
from test_torch_lstm_tiles import _inputs as _lstm_inputs
from test_torch_wide_lstm import f32_tiles_smem

from context_attentive_ir_tpu.ops.pallas.gru import (
    _gru_fused_bwd_impl,
    _gru_fused_res_impl,
)
from context_attentive_ir_tpu.ops.pallas.lstm import (
    _lstm_fused_bwd_impl,
    _lstm_fused_res_impl,
)
from context_attentive_ir_tpu_torch.ops.kernels import gru as G
from context_attentive_ir_tpu_torch.ops.kernels import lstm as K

K_STEP = 8   # k values of one m16n8k8 tile


# -- the split product ------------------------------------------------------

def tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero -- half an ulp added to the magnitude
    bits, the low 13 bits cleared."""
    bits = v.float().contiguous().view(torch.int32).to(torch.int64)
    bits = ((bits & 0xFFFFFFFF) + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(v: torch.Tensor):
    """(hi, lo) as the tiles split v: hi = tf32(v); lo = v - hi, which the
    tensor core reads rounded toward zero (its low 13 bits ignored)."""
    hi = tf32(v)
    rest = (v.float() - hi).view(torch.int32) & -0x2000
    return hi, rest.view(torch.float32)


def split_mm(a: torch.Tensor, b: torch.Tensor,
             acc: torch.Tensor | None = None,
             promote: int | None = None) -> torch.Tensor:
    """acc + a @ b as the split-TF32 tiles compute it: per k step of 8,
    lo_a @ hi_b, hi_a @ lo_b, hi_a @ hi_b added in that order in f32;
    ``promote``: every that many k steps (phases B and C: a 32-row slab)
    into a fresh partial, which is then added to the sum."""
    m, k = a.shape
    n = b.shape[1]
    pad = -k % K_STEP
    a = torch.nn.functional.pad(a.float(), (0, pad))
    b = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    (ah, al), (bh, bl) = split(a), split(b)
    steps = (k + pad) // K_STEP

    def per_step(x, y):
        return torch.einsum("msj,sjn->smn", x.reshape(m, steps, K_STEP),
                            y.reshape(steps, K_STEP, n))

    terms = (per_step(al, bh), per_step(ah, bl), per_step(ah, bh))
    out = torch.zeros((m, n)) if acc is None else acc.float().clone()
    run = promote or steps
    for s0 in range(0, steps, run):
        part = torch.zeros((m, n)) if promote else out
        for s in range(s0, min(s0 + run, steps)):
            for term in terms:
                part = part + term[s]
        out = out + part if promote else part
    return out


def rev_mm(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """a @ b as the backwards' reverse products compute it in float32
    (``tf32_rev_product``): the k steps of 8 split into ``parts`` ranges,
    one a warp; in each, a step adds lo*hi, then (into its own
    accumulator) hi*hi, then hi*lo, even and odd steps apart, the range's
    sum (small even + small odd) + (big even + big odd); the ranges' sums
    added in order."""
    m, k = a.shape
    pad = -k % K_STEP
    a = torch.nn.functional.pad(a.float(), (0, pad))
    b = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    (ah, al), (bh, bl) = split(a), split(b)
    steps = (k + pad) // K_STEP
    out = None
    for p in range(parts):
        small = [torch.zeros((m, b.shape[1])) for _ in range(2)]
        big = [torch.zeros((m, b.shape[1])) for _ in range(2)]
        for i, s in enumerate(range(p * steps // parts,
                                    (p + 1) * steps // parts)):
            c = slice(s * K_STEP, (s + 1) * K_STEP)
            small[i % 2] = small[i % 2] + al[:, c] @ bh[c]
            big[i % 2] = big[i % 2] + ah[:, c] @ bh[c]
            small[i % 2] = small[i % 2] + ah[:, c] @ bl[c]
        part = (small[0] + small[1]) + (big[0] + big[1])
        out = part if out is None else out + part
    return out


def rev_parts(hp: int, gates: int, ranks: int) -> int:
    """Warps a reverse product's tile splits its k extent over: 8 over
    the tiles of a slab, MT 16-row tiles times one (slabs of 8 or 16
    k-rows) or two 16-column groups (32)."""
    _, m, ks = f32_tiles_smem(hp, gates, depth=True, ranks=ranks)
    return 8 // ((m // 16) * max(1, ks // 16))


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10
    for v, want in ((one + ulp / 2, one + ulp),        # a tie: away
                    (one + ulp / 2 - 2 ** -23, one),  # below it: down
                    (-(one + ulp / 2), -(one + ulp)),
                    (one + 3 * ulp / 2, one + 2 * ulp),
                    (0.0, 0.0), (2.0 ** -100, 2.0 ** -100)):
        got = tf32(torch.tensor([v], dtype=torch.float32))
        assert float(got) == want, (v, float(got), want)
    v = torch.from_numpy(np.random.RandomState(0).normal(
        size=4096).astype(np.float32))
    hi = tf32(v)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert float(((v - hi).abs() / v.abs()).max()) <= 2.0 ** -11
    hi, lo = split(v)
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert float(((v - hi - lo).abs() / v.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("m,k,n", [(16, 8, 8), (33, 200, 17), (7, 1000, 5)])
def test_split_product_within_its_bound(m, k, n):
    rng = np.random.RandomState(m + k)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = split_mm(ta, tb).double().numpy()
    promoted = split_mm(ta, tb, promote=4).double().numpy()
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    bound = (5 * 2.0 ** -22 + (k + 3) * 2.0 ** -24) * scale
    assert np.all(np.abs(got - exact) <= bound)
    assert np.all(np.abs(promoted - exact) <= bound)
    # the reverse products' accumulation, its k split over 1, 4 or 8 warps
    for parts in (1, 4, 8):
        rev = rev_mm(ta, tb, parts).double().numpy()
        assert np.all(np.abs(rev - exact) <= bound)
    # a single TF32 product (hi * hi alone) misses it by far
    ah, bh = tf32(torch.from_numpy(a)), tf32(torch.from_numpy(b))
    one = (ah.double() @ bh.double()).numpy()
    assert np.abs(one - exact).max() > 50 * np.abs(got - exact).max()


# -- the emulation of phase A, B and C ---------------------------------------

def _pad(b, t, e, h, gates):
    """(Ep, Hp, ranks) float32 kernels 5 and 9 run (E, H) at."""
    hp = K.f32_tile_hidden(h)
    return K._round_up(e, K.TILE_ALIGN), hp, K.f32_cluster(hp)


def _rank_weights(w_ih, w_hh, ranks, gates):
    """Each rank's [E + H, gates * Hc] staged weights, padding cut."""
    staged = K.stage_lstm_weights(w_ih, w_hh, ranks, gates)
    return (staged if ranks > 1 else staged[None])[..., :-8]


def _phase_b(x2, hp2, g2, parts):
    """dW_ih and dW_hh from phase B's split products over all (row, step)
    pairs: ``parts`` maps the gradient slots' columns to dW columns."""
    dw_ih = split_mm(x2.T, g2[:, parts[0]], promote=4)
    dw_hh = torch.cat([split_mm(hp2.T, g2[:, c], promote=4)
                       for c in parts[1]], 1)
    return dw_ih, dw_hh


def lstm_tiles(x, mask, w_ih, b, w_hh, hb, cb, dout, ranks, reverse=False,
               time_chunk=2):
    """Kernel 5 in float32 as the tiles compute it, on padded operands:
    ranks of Hc = H / ranks units, each from its own staged weights.
    Returns (dx, dw_ih, db, dw_hh)."""
    B, T, E = x.shape
    H = w_hh.shape[0]
    hc = H // ranks
    parts = rev_parts(H, 4, ranks)
    tc = K.chunk_len(T, time_chunk)
    w = _rank_weights(w_ih, w_hh, ranks, 4)
    bias = b.reshape(4, ranks, hc).permute(1, 0, 2).reshape(ranks, 4 * hc)
    cols = [torch.cat([torch.arange(q * H + r * hc, q * H + (r + 1) * hc)
                       for q in range(4)]) for r in range(ranks)]
    dgates = torch.zeros((B, T, 4 * H))
    h_prev = torch.zeros((B, T, H))
    dx = torch.zeros((B, T, E))
    dh, dc, db = torch.zeros((B, H)), torch.zeros((B, H)), torch.zeros(4 * H)
    n_chunks = -(-T // tc)
    for q in range(n_chunks):
        chunk = q if reverse else n_chunks - 1 - q
        steps = range(chunk * tc, min((chunk + 1) * tc, T))
        h, c = hb[chunk].clone(), cb[chunk].clone()
        saved = []
        for t in (reversed(steps) if reverse else steps):
            m = mask[:, t, None]
            xh = torch.cat([x[:, t], h], 1)
            h_next, c_next, acts = h.clone(), c.clone(), []
            for r in range(ranks):
                u = slice(r * hc, (r + 1) * hc)
                acc = split_mm(xh, w[r], bias[r].expand(B, -1))
                i, f, g, o = acc.reshape(B, 4, hc).unbind(1)
                i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f),
                              torch.tanh(g), torch.sigmoid(o))
                c_new = f * c[:, u] + i * g
                acts.append((i, f, g, o, c[:, u], c_new))
                h_next[:, u] = torch.where(m, o * torch.tanh(c_new), h[:, u])
                c_next[:, u] = torch.where(m, c_new, c[:, u])
            saved.append((t, h, acts))
            h, c = h_next, c_next
        for t, hp, acts in reversed(saved):
            m = mask[:, t, None].float()
            partials, dx_t = [], torch.zeros((B, E))
            for r, (i, f, g, o, c_prev, c_new) in enumerate(acts):
                u = slice(r * hc, (r + 1) * hc)
                dh_new = m * (dout[:, t, u] + dh[:, u])
                tanh_c = torch.tanh(c_new)
                dcn = m * dc[:, u] + dh_new * o * (1.0 - tanh_c * tanh_c)
                d = torch.cat([dcn * g * i * (1.0 - i),
                               dcn * c_prev * f * (1.0 - f),
                               dcn * i * (1.0 - g * g),
                               dh_new * tanh_c * o * (1.0 - o)], 1)
                dc[:, u] = (1.0 - m) * dc[:, u] + dcn * f
                dgates[:, t, cols[r]] = d
                db[cols[r]] += d.sum(0)
                # the rank's partial of dh over every unit, from its slabs'
                # W_hh rows; a single block's dx_t from its W_ih rows
                partials.append(rev_mm(d, w[r, E:].T, parts))
                if ranks == 1:
                    dx_t = rev_mm(d, w[r, :E].T, parts)
            total = partials[0]
            for p in partials[1:]:
                total = total + p
            dh = (1.0 - m) * dh + total
            dx[:, t] = dx_t
            h_prev[:, t] = hp
    g2 = dgates.reshape(B * T, 4 * H)
    if ranks > 1:   # phase C
        dx = split_mm(g2, w_ih.T, promote=4).reshape(B, T, E)
    dw_ih, dw_hh = _phase_b(x.reshape(B * T, E), h_prev.reshape(B * T, H),
                            g2, (slice(0, 4 * H), (slice(0, 4 * H),)))
    return dx, dw_ih, db, dw_hh


def gru_tiles(x, mask, w_ih, b_ih, w_hh, b_hh, hb, dout, ranks,
              reverse=False, time_chunk=2):
    """Kernel 9 in float32 as the tiles compute it, on padded operands:
    slots r, z (x and h slabs), xn (x slabs), hn (h slabs); the gradient
    slots [da_r, da_z, da_n, da_n * r], dh from slots 0, 1, 3 against the
    rank's W_hh rows (rank order), then dh' z.  Returns (dx, dw_ih, db_ih,
    dw_hh, db_hh)."""
    B, T, E = x.shape
    H = w_hh.shape[0]
    hc = H // ranks
    parts = rev_parts(H, 3, ranks)
    tc = K.chunk_len(T, time_chunk)
    w = _rank_weights(w_ih, w_hh, ranks, 3)

    def of_rank(v, r):
        return v.reshape(3, ranks, hc)[:, r].reshape(3 * hc)

    slots = torch.zeros((B, T, 4 * H))
    h_prev = torch.zeros((B, T, H))
    dx = torch.zeros((B, T, E))
    dh, dbs = torch.zeros((B, H)), torch.zeros(4 * H)
    n_chunks = -(-T // tc)
    for q in range(n_chunks):
        chunk = q if reverse else n_chunks - 1 - q
        steps = range(chunk * tc, min((chunk + 1) * tc, T))
        h = hb[chunk].clone()
        saved = []
        for t in (reversed(steps) if reverse else steps):
            m = mask[:, t, None]
            xh = torch.cat([x[:, t], h], 1)
            h_next, acts = h.clone(), []
            for r in range(ranks):
                u = slice(r * hc, (r + 1) * hc)
                bi, bh = of_rank(b_ih, r), of_rank(b_hh, r)
                rz = split_mm(xh, w[r, :, :2 * hc],
                              (bi[:2 * hc] + bh[:2 * hc]).expand(B, -1))
                xn = split_mm(x[:, t], w[r, :E, 2 * hc:],
                              bi[2 * hc:].expand(B, -1))
                hn = split_mm(h, w[r, E:, 2 * hc:], bh[2 * hc:].expand(B, -1))
                rg, zg = torch.sigmoid(rz).split(hc, 1)
                ng = torch.tanh(xn + rg * hn)
                acts.append((h[:, u], rg, zg, ng, hn))
                h_next[:, u] = torch.where(m, (1.0 - zg) * ng + zg * h[:, u],
                                           h[:, u])
            saved.append((t, h, acts))
            h = h_next
        for t, hp, acts in reversed(saved):
            m = mask[:, t, None].float()
            partials, dhz, dx_t = [], [], torch.zeros((B, E))
            for r, (hpr, rg, zg, ng, hn) in enumerate(acts):
                u = slice(r * hc, (r + 1) * hc)
                dh_new = m * (dout[:, t, u] + dh[:, u])
                dz = dh_new * (hpr - ng)
                da_n = dh_new * (1.0 - zg) * (1.0 - ng * ng)
                d = [da_n * hn * rg * (1.0 - rg), dz * zg * (1.0 - zg), da_n,
                     da_n * rg]
                for s in range(4):
                    slots[:, t, s * H + r * hc:s * H + (r + 1) * hc] = d[s]
                    dbs[s * H + r * hc:s * H + (r + 1) * hc] += d[s].sum(0)
                partials.append(rev_mm(torch.cat([d[0], d[1], d[3]], 1),
                                       w[r, E:].T, parts))
                dhz.append(dh_new * zg)
                if ranks == 1:
                    dx_t = rev_mm(torch.cat(d[:3], 1), w[r, :E].T, parts)
            total = partials[0]
            for p in partials[1:]:
                total = total + p
            dh = torch.where(m > 0, total + torch.cat(dhz, 1), dh)
            dx[:, t] = dx_t
            h_prev[:, t] = hp
    g2 = slots.reshape(B * T, 4 * H)
    if ranks > 1:   # phase C
        dx = split_mm(g2[:, :3 * H], w_ih.T, promote=4).reshape(B, T, E)
    dw_ih, dw_hh = _phase_b(
        x.reshape(B * T, E), h_prev.reshape(B * T, H), g2,
        (slice(0, 3 * H), (slice(0, 2 * H), slice(3 * H, 4 * H))))
    db_ih = dbs[:3 * H]
    db_hh = torch.cat([dbs[:2 * H], dbs[3 * H:]])
    return dx, dw_ih, db_ih, dw_hh, db_hh


# (rows, T, E, H, time chunk, ranks, reverse): one block at H = 32 and 64
# (64 rows) with an odd E, the unit split of a cluster of 2 at 64, the
# card's 2 ranks at 136 (padded to 160) in both directions and its 4 at
# 300 (padded to 320)
CASES = [(16, 3, 37, 32, 2, 1, False), (16, 3, 64, 64, 2, 1, False),
         (16, 3, 64, 64, 2, 2, False), (12, 4, 40, 136, 2, 2, False),
         (12, 4, 40, 136, 2, 2, True), (8, 3, 40, 300, 2, 4, False)]


def _cut(v, h, hp, gates):
    return K._cut_gates(v, h, hp, gates)


@pytest.mark.parametrize("b,t,e,h,tc,ranks,reverse", CASES)
def test_lstm_tiles_match_jax(b, t, e, h, tc, ranks, reverse):
    x, mask, w_ih, bias, w_hh, dout = _lstm_inputs(21, b, t, e, h)
    jx = list(map(jnp.asarray, (x, mask, w_ih, bias, w_hh)))
    _, hb_j, cb_j = _lstm_fused_res_impl(*jx, reverse=reverse, block_b=16,
                                         time_chunk=tc, interpret=True)
    ref = _lstm_fused_bwd_impl(*jx, hb_j, cb_j, jnp.asarray(dout),
                               reverse=reverse, block_b=16, time_chunk=tc,
                               interpret=True)
    ep, hp, c = _pad(b, t, e, h, 4)
    if ranks != c:   # a cluster at a width one block holds
        hp = K._round_up(h, max(32, 16 * ranks))
    tx, tw, tb, th = K.pad_lstm_operands(
        *map(torch.from_numpy, (x, w_ih, bias, w_hh)), hp)
    tm = torch.from_numpy(mask)
    assert th.shape[0] == hp and tx.shape[-1] == ep
    hb, cb = (K._pad_last(torch.from_numpy(np.asarray(v)[:, :b]), hp)
              for v in (hb_j, cb_j))
    dx, dw_ih, db, dw_hh = lstm_tiles(
        tx, tm, tw, tb, th, hb, cb,
        K._pad_last(torch.from_numpy(dout), hp), ranks, reverse, tc)
    got = (dx[..., :e], _cut(dw_ih[:e], h, hp, 4), _cut(db, h, hp, 4),
           _cut(dw_hh[:h], h, hp, 4))
    for g, r in zip(got, ref):
        assert g.shape == tuple(np.shape(r))
        _close_rel(g, np.asarray(r))


@pytest.mark.parametrize("b,t,e,h,tc,ranks,reverse", CASES)
def test_gru_tiles_match_jax(b, t, e, h, tc, ranks, reverse):
    args, dout = _gru_inputs(23, b, t, e, h)
    jx = list(map(jnp.asarray, args))
    _, hb_j = _gru_fused_res_impl(*jx, reverse=reverse, block_b=16,
                                  time_chunk=tc, interpret=True)
    ref = _gru_fused_bwd_impl(*jx, hb_j, jnp.asarray(dout), reverse=reverse,
                              block_b=16, time_chunk=tc, interpret=True)
    ep, hp, c = _pad(b, t, e, h, 3)
    if ranks != c:   # a cluster at a width one block holds
        hp = K._round_up(h, max(32, 16 * ranks))
    x, mask, w_ih, b_ih, w_hh, b_hh = map(torch.from_numpy, args)
    tx, tw_ih, tb_ih, tw_hh, tb_hh = G.pad_gru_operands(x, w_ih, b_ih, w_hh,
                                                        b_hh, hp)
    assert tw_hh.shape[0] == hp and tx.shape[-1] == ep
    hb = K._pad_last(torch.from_numpy(np.asarray(hb_j)[:, :b]), hp)
    got = gru_tiles(tx, mask, tw_ih, tb_ih, tw_hh, tb_hh, hb,
                    K._pad_last(torch.from_numpy(dout), hp), ranks, reverse,
                    tc)
    dx, dw_ih, db_ih, dw_hh, db_hh = got
    got = (dx[..., :e], _cut(dw_ih[:e], h, hp, 3), _cut(db_ih, h, hp, 3),
           _cut(dw_hh[:h], h, hp, 3), _cut(db_hh, h, hp, 3))
    for g, r in zip(got, ref):
        assert g.shape == tuple(np.shape(r))
        _close_rel(g, np.asarray(r))


def test_padding_is_the_wrappers():
    """The widths the emulation runs at are the wrappers': E to 32, H to
    ``f32_tile_hidden`` (16 C in a cluster of C), the launchers' ranks."""
    assert _pad(16, 3, 37, 32, 4) == (64, 32, 1)
    assert _pad(12, 4, 40, 136, 4) == (64, 160, 2)
    assert _pad(8, 2, 8, 300, 3) == (32, 320, 4)
    assert _pad(8, 2, 8, 520, 3) == (32, 640, 8)
    assert _pad(8, 2, 8, 1000, 4) == (32, 1024, 8)
