"""The decode step's two kernels' arithmetic, emulated on the CPU, against
the plain versions and the reference.

A CUDA kernel has no CPU mode, so this file repeats in torch the order in
which kernels 4 and 5 (``kernels/csrc/paged_decode.cu``,
``kernels/csrc/int8_matmul.cu``) form their sums, and holds that twin, on
numpy inputs from a seed, to the reference's Pallas kernels in interpret
mode and to the port's plain versions, at the tolerances of
``test_torch_kernels_ref.py``.

- **Paged decode, split context.** Each split of TOK tokens (whole pool
  blocks; TOK from the kernel's geometry) forms its scores (per lane an
  fma chain over 16 bytes of the row, then a shuffle tree over the row's
  lanes), its max, p = e^(s - m) once per token (0 past the position), and
  l and acc = sum p v (per thread over its rounds, a shuffle tree over
  the warp's token groups, then the four warps in order).  A split wholly
  past the position writes (m, l, acc) = (-1e30, 0, 0).  The merge runs in
  split order: M = max m_s, w_s = e^(m_s - M), L and acc by fma, acc / L.
- **int8 matmul, K split over warps.** The activation is pre-scaled as
  fp32(operand(x * s)) (rounded to bf16 for bf16).  On the CUDA cores each
  of the CTA's 32 row groups takes every 32nd K row of its rank's run by
  fma; a warp's 8 row groups fold by a halving butterfly, the 4 warps add
  in order, and the cluster's ranks (the K split across CTAs, chosen from
  the shapes as the kernel chooses it) add in rank order.  On the tensor
  cores (bf16, M >= 3) the weight is read in the ``mma.m16n8k16``
  fragment order (``tc_pack``, checked here by reading it back through
  the fragment layout), each 16-row K tile's exact products are summed
  into fp32, the 4 warps take a chunk's tile pairs in turn and add in
  order, then the ranks.

fma is emulated in float64 (exact products, one rounding to fp32 in all
but rare double-rounding cases); the card's ``expf`` may differ from
torch's ``exp`` in the last bit.  The card runs the kernels themselves
against the plain versions (``test_torch_cuda_decode.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanompi_tpu.ops import quant as jquant
from theanompi_tpu.ops.pallas_paged_attention import (
    paged_attend_decode as j_paged,
)

from theanompi_torch.convert import quantized_from_jax
from theanompi_torch.ops import quant as tquant
from theanompi_torch.ops.paged_attention import paged_attend_decode_ref

#: test_torch_kernels_ref.py's tolerances
RTOL, ATOL = 1e-5, 1e-6
NEG_INF = -1e30


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def fma(a, b, c):
    """``fmaf(a, b, c)``: the product exact in float64, one rounding."""
    return (a.double() * b.double() + c.double()).float()


def tree(v):
    """A shuffle butterfly over the last axis (a power of two): each round
    adds the upper half to the lower, as lane i adds lane i ^ (n / 2)."""
    while v.shape[-1] > 1:
        n = v.shape[-1] // 2
        v = v[..., :n] + v[..., n:]
    return v[..., 0]


def pair_tree(v):
    """A butterfly whose rounds run over the lowest index bit first (xor
    offsets LT, 2 LT, ... over the token groups of a warp)."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


# -- kernel 4: paged decode, split context ------------------------------------

def split_geometry(elt: int, d: int, bs: int):
    """The kernel's ``Geo``: 16-byte loads of ``elt``-byte elements, four
    warps, sixteen rounds of loads a split, whole pool blocks.  -> (elements
    a lane, lanes a token row, tokens a warp load, tokens a split)."""
    epl = 16 // elt
    lt = d // epl
    tpw = 32 // lt
    tok = max(bs, 16 * 4 * tpw)
    return epl, lt, tpw, tok


def paged_split_partials(kp, vp, tables, bs, q, positions):
    """Each split's (m, l, acc) as the split kernel forms them:
    ``[B, H, S]``, ``[B, H, S]``, ``[B, H, S, Dh]`` in fp32."""
    b, h, d = q.shape
    nb = tables.shape[1]
    epl, lt, tpw, tok = split_geometry(q.element_size(), d, bs)
    tpr, n_split = 4 * tpw, -(-nb * bs // tok)
    qf = q.float() * torch.tensor(d ** -0.5, dtype=torch.float32)
    ms = torch.full((b, h, n_split), NEG_INF)
    ls = torch.zeros((b, h, n_split))
    accs = torch.zeros((b, h, n_split, d))
    for s in range(n_split):
        tt = torch.arange(tok)
        t = s * tok + tt
        j = s * (tok // bs) + tt // bs
        jc = j.clamp(max=nb - 1)
        blk = tables[:, jc].long()                              # [B, TOK]
        k = kp[blk, (tt % bs)[None, :]].float()                 # [B, TOK, H, D]
        v = vp[blk, (tt % bs)[None, :]].float()
        ok = (t[None, :] <= positions[:, None].long()) & (j < nb)[None, :]
        lane_k = k.reshape(b, tok, h, lt, epl)
        lane_q = qf.reshape(b, 1, h, lt, epl)
        part = torch.zeros(b, tok, h, lt)
        for e in range(epl):
            part = fma(lane_q[..., e], lane_k[..., e], part)
        sc = torch.where(ok[:, :, None], tree(part),
                         torch.tensor(NEG_INF))                 # [B, TOK, H]
        m = sc.amax(dim=1)                                      # [B, H]
        p = torch.where(ok[:, :, None], torch.exp(sc - m[:, None]),
                        torch.tensor(0.0))
        # token tt = r * TPR + warp * TPW + tg: [B, R, WARPS, TPW, H]
        p_r = p.reshape(b, tok // tpr, 4, tpw, h)
        v_r = v.reshape(b, tok // tpr, 4, tpw, h, d)
        l_t = torch.zeros(b, 4, tpw, h)
        acc_t = torch.zeros(b, 4, tpw, h, d)
        for r in range(tok // tpr):
            l_t = l_t + p_r[:, r]
            acc_t = fma(p_r[:, r, ..., None], v_r[:, r], acc_t)
        l_w = pair_tree(l_t.movedim(2, -1))                     # [B, 4, H]
        acc_w = pair_tree(acc_t.movedim(2, -1))                 # [B, 4, H, D]
        l_s, acc_s = l_w[:, 0], acc_w[:, 0]
        for w in range(1, 4):
            l_s, acc_s = l_s + l_w[:, w], acc_s + acc_w[:, w]
        active = (s * tok <= positions.long())[:, None]         # [B, 1]
        ms[:, :, s] = torch.where(active, m, torch.tensor(NEG_INF))
        ls[:, :, s] = torch.where(active, l_s, torch.tensor(0.0))
        accs[:, :, s] = torch.where(active[..., None], acc_s,
                                    torch.tensor(0.0))
    return ms, ls, accs


def paged_merge(ms, ls, accs, dtype):
    """The combine: the partials merged in split order."""
    big_m = ms.amax(dim=-1)
    big_l = torch.zeros_like(big_m)
    acc = torch.zeros_like(accs[..., 0, :])
    for s in range(ms.shape[-1]):
        w = torch.exp(ms[..., s] - big_m)
        big_l = fma(ls[..., s], w, big_l)
        acc = fma(accs[..., s, :], w[..., None], acc)
    return (acc / big_l[..., None]).to(dtype)


def paged_twin(kp, vp, tables, bs, q, positions):
    return paged_merge(*paged_split_partials(kp, vp, tables, bs, q,
                                             positions), q.dtype)


def _pools(seed, n_blocks, bs, h, d, b):
    rng = np.random.RandomState(seed)
    kp = rng.randn(n_blocks, bs, h, d).astype(np.float32)
    vp = rng.randn(n_blocks, bs, h, d).astype(np.float32)
    q = rng.randn(b, h, d).astype(np.float32)
    return kp, vp, q


def _own_tables(positions, bs, nb):
    """Each active slot on its own run of blocks (from 1), null tails; a
    slot at position 0 keeps an all-null table (inactive)."""
    tables = np.zeros((len(positions), nb), np.int32)
    nxt = 1
    for i, p in enumerate(positions):
        if p:
            need = p // bs + 1
            tables[i, :need] = np.arange(nxt, nxt + need)
            nxt += need
    return tables, nxt


#: fp32, head dim 32: 256 tokens a split (32 blocks of 8, 16 of 16), tables
#: of 512 tokens.  Slot positions at the last token of a split (255), the
#: first of the next (256), an inactive slot (0) and, for bs 16, slots
#: sharing leading blocks with slot 0
PAGED_CASES = [
    (8, 64, [255, 256, 0, 300]),
    (16, 32, [255, 256, 511, 5]),
    (8, 64, [511, 0, 1, 200]),
    (16, 32, [511]),
]


@pytest.mark.parametrize("bs,nb,positions", PAGED_CASES)
def test_paged_split_twin_matches_reference(bs, nb, positions):
    h, d = 2, 32
    tables, n_used = _own_tables(positions, bs, nb)
    if bs == 16 and len(positions) > 1:
        tables[3, :1] = tables[0, :1]        # slot 3 shares slot 0's block
        tables[1, :2] = tables[0, :2]        # slot 1 its two leading blocks
    kp, vp, q = _pools(bs * nb + len(positions), n_used, bs, h, d,
                       len(positions))
    pos = np.asarray(positions, np.int32)
    _, _, _, tok = split_geometry(4, d, bs)
    assert tok == 256
    got = paged_twin(_t(kp), _t(vp), _t(tables), bs, _t(q), _t(pos))
    assert torch.isfinite(got).all()
    plain = paged_attend_decode_ref(_t(kp), _t(vp), _t(tables), bs, _t(q),
                                    _t(pos))
    kern = np.asarray(j_paged(jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(tables), bs, jnp.asarray(q),
                              jnp.asarray(pos), interpret=True))
    np.testing.assert_allclose(got.numpy(), kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("bs", [8, 16])
def test_split_past_position_merges_with_weight_zero(bs):
    """A split wholly past the position (m = -1e30, l = 0, acc = 0) merges
    with weight exactly 0: bit for bit the merge without it.  The slot at
    position 0 (inactive, null table) has only such splits beside its
    first, and stays finite."""
    h, d, nb = 2, 32, 512 // bs
    positions = [140, 0, 511]
    tables, n_used = _own_tables(positions, bs, nb)
    kp, vp, q = _pools(bs, n_used, bs, h, d, len(positions))
    ms, ls, accs = paged_split_partials(_t(kp), _t(vp), _t(tables), bs,
                                        _t(q), _t(np.asarray(positions,
                                                             np.int32)))
    assert ms.shape[-1] == 2
    # slots 0 at 140 and 1 at 0: split 1 is past
    assert (ms[:2, :, 1] == NEG_INF).all() and (ls[:2, :, 1] == 0).all()
    assert (accs[:2, :, 1] == 0).all()
    full = paged_merge(ms, ls, accs, torch.float32)
    assert torch.isfinite(full).all()
    assert torch.equal(full[0], paged_merge(ms[0:1, :, :1], ls[0:1, :, :1],
                                            accs[0:1, :, :1],
                                            torch.float32)[0])
    assert torch.equal(full[1], paged_merge(ms[1:2, :, :1], ls[1:2, :, :1],
                                            accs[1:2, :, :1],
                                            torch.float32)[0])
    # the inactive slot attends to token 0 of the null block alone
    torch.testing.assert_close(full[1], _t(vp[0, 0]), rtol=0, atol=0)


# -- kernel 5: int8 matmul, K split over warps --------------------------------

#: the kernel's column tile, threads, K rows a CTA step (4 lanes a row),
#: warps, least K rows a CTA, SMs
TN, THREADS, SMS, MIN_K = 64, 128, 132, 128
RS, WARPS = THREADS // 4, THREADS // 32


def int8_splits(m: int, din: int, dout: int):
    """The kernel's K split across a cluster: -> (splits, K rows a CTA)."""
    mr = next(r for r in (1, 2, 4, 8) if m <= r or r == 8)
    tiles = -(-dout // TN) * -(-m // mr)
    splits = 1
    while (splits < 8 and tiles * splits * 2 <= 2 * SMS
           and din >= splits * 2 * MIN_K):
        splits *= 2
    rows = -(-din // splits)
    return splits, -(-rows // RS) * RS


def int8_twin(x, qt):
    """Kernel 5's sums: ``x [..., Din] -> [..., Dout]`` in ``x.dtype``."""
    q2d, scales, bands = qt.layout()
    din, dout = q2d.shape
    x2 = x.reshape(-1, din)
    m = x2.shape[0]
    band = torch.arange(dout) // (dout // bands)
    a = x2.float()[:, None, :] * scales[band][None]        # [M, Dout, Din]
    if x.dtype == torch.bfloat16:
        a = a.to(torch.bfloat16).float()
    w = q2d.float()
    splits, k_per = int8_splits(m, din, dout)
    thread = torch.zeros(splits, RS, m, dout)                # (rank, group)
    for k in range(din):
        z, rg = k // k_per, (k % k_per) % RS
        thread[z, rg] = fma(a[:, :, k], w[k][None, :], thread[z, rg])
    # row group = warp * 8 + (lane >> 2); the fold runs over lane bits 4,
    # 3, 2, i.e. row-group bits 2, 1, 0
    per_warp = tree(thread.reshape(splits, WARPS, 8, m, dout)
                    .movedim(2, -1))
    cta = per_warp[:, 0]
    for w_ in range(1, WARPS):
        cta = cta + per_warp[:, w_]
    out = torch.zeros(m, dout)
    for z in range(splits):
        out = out + cta[z]
    return out.to(x.dtype).reshape(*x.shape[:-1], dout)


def _payload(seed, din, dout, chunk):
    """A reference int8 payload and its port twin (same bytes)."""
    key = jax.random.PRNGKey(seed)
    w = jax.random.normal(key, (din, dout), jnp.float32)
    q, s = jquant.quantize_chunked(w, jax.random.fold_in(key, 1), chunk)
    jqt = jquant.QuantizedTensor(q, s, (din, dout), jnp.dtype(jnp.float32))
    tqt = quantized_from_jax(np.asarray(q), np.asarray(s), (din, dout),
                             "float32")
    return jqt, tqt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_twin_one_k_row_is_the_plain_version_bit_for_bit(dtype):
    """With one K row no sum order can matter: the pre-scaled activation
    (rounded to bf16 for bf16 where the plain version rounds it) times
    the weight must be the plain version's result bit for bit."""
    _, tqt = _payload(11, 1, 64, 64)
    x = _t(np.random.RandomState(4).randn(8, 1).astype(np.float32))
    x = x.to(getattr(torch, dtype))
    assert torch.equal(int8_twin(x, tqt), tquant.int8_matmul_ref(x, tqt))


#: the CUDA-core kernel (fp32; bf16 at M <= 2 or where the tensor-core
#: kernel does not take the shape): row bands (one band; 24 columns, not
#: a multiple of 16: the narrow path), column bands of 16 (several bands a
#: tile: narrow) and of 64 (wide), a K split over 4 and over 8 cluster
#: ranks (the last two ranks empty), at M = 1, 3 and 8
INT8_CASES = [
    (64, 24, 48, 3, "float32"),
    (16, 48, 16, 8, "float32"),
    (512, 64, 64, 1, "float32"),
    (1100, 64, 64, 8, "float32"),
    (256, 128, 64, 1, "bfloat16"),
    (96, 48, 16, 3, "bfloat16"),
]


@pytest.mark.parametrize("din,dout,chunk,m,dtype", INT8_CASES)
def test_int8_twin_matches_reference(din, dout, chunk, m, dtype):
    jqt, tqt = _payload(din + dout + m, din, dout, chunk)
    assert tquant.int8_matmul_supported((din, dout), chunk)
    x = np.random.RandomState(m).randn(m, din).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(jquant.int8_matmul(jnp.asarray(x, jdt), jqt,
                                        interpret=True).astype(jnp.float32))
    xt = _t(x).to(getattr(torch, dtype))
    got = int8_twin(xt, tqt)
    plain = tquant.int8_matmul_ref(xt, tqt)
    # fp32: (x * s) @ q in another order (test_torch_kernels_ref's
    # limits); bf16: the operands round to bf16 as the reference's do
    rtol = RTOL if dtype == "float32" else 1e-2
    for other in (ref, plain.float().numpy()):
        np.testing.assert_allclose(got.float().numpy(), other, rtol=rtol,
                                   atol=rtol * np.abs(ref).max())


def _unpack_fragments(packed, din, dout):
    """The weight as the tensor-core kernel's lanes see it: each lane's 16
    bytes of an n-tile and a K tile pair read back through the
    ``mma.m16n8k16`` A-fragment layout (row = output column n, col = K
    row): -> ``[Din, Dout]``."""
    w = torch.zeros(din, dout, dtype=packed.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        # registers a0a1, a2a3, a4a5, a6a7: (row, col) of A for each byte
        rc = [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1),
              (g, 2 * t + 8), (g, 2 * t + 9), (g + 8, 2 * t + 8),
              (g + 8, 2 * t + 9)]
        for h in range(2):
            for j, (n, k) in enumerate(rc):
                w.view(din // 32, 2, 16, dout // 16, 16)[:, h, k, :, n] = (
                    packed[:, :, lane, 8 * h + j].t())
    return w


def test_tc_pack_is_the_mma_fragment_order():
    """The payload that kernel 5's bf16 tensor-core path loads, read back
    through the fragment layout, is the weight itself."""
    _, tqt = _payload(21, 96, 48, 48)
    q2d = tqt.layout()[0]
    assert tquant.tc_shape(96, 48, 48)
    packed = tquant.tc_pack(q2d)
    assert packed.shape == (3, 3, 32, 16)
    assert torch.equal(_unpack_fragments(packed, 96, 48), q2d)


def int8_tc_twin(x, qt):
    """The tensor-core path's sums (bf16, M <= 8): each 16-row K tile's
    exact products summed into fp32, the tiles added in each warp's order
    (the warps take a chunk's K tile pairs in turn), then the warps in
    order and the cluster's ranks in order."""
    q2d, scales, bands = qt.layout()
    din, dout = q2d.shape
    w = _unpack_fragments(tquant.tc_pack(q2d), din, dout).double()
    x2 = x.reshape(-1, din)
    m = x2.shape[0]
    band = torch.arange(dout) // (dout // bands)
    a = (x2.float()[:, None, :] * scales[band][None]).to(
        torch.bfloat16).double()                             # [M, Dout, Din]
    splits, k_per = int8_splits(m, din, dout)
    warps = torch.zeros(splits, 4, m, dout)
    for kt in range(din // 16):
        k = 16 * kt
        z = k // k_per
        warp = ((k % k_per) % 512) // 32 % 4
        tile = (a[:, :, k:k + 16] * w[k:k + 16].t()[None]).sum(-1).float()
        warps[z, warp] = warps[z, warp] + tile
    out = torch.zeros(m, dout)
    for z in range(splits):
        cta = warps[z, 0]
        for w_ in range(1, 4):
            cta = cta + warps[z, w_]
        out = out + cta
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("din,dout,chunk,m", [(512, 64, 64, 8),
                                              (1024, 128, 64, 3)])
def test_int8_tc_twin_matches_reference(din, dout, chunk, m):
    """bf16 on the tensor cores, at a K split over a cluster (512 rows:
    4 ranks of 128) and over several chunks (1024 rows, 64-column bands)."""
    jqt, tqt = _payload(din + m, din, dout, chunk)
    x = np.random.RandomState(m).randn(m, din).astype(np.float32)
    ref = np.asarray(jquant.int8_matmul(jnp.asarray(x, jnp.bfloat16), jqt,
                                        interpret=True).astype(jnp.float32))
    got = int8_tc_twin(_t(x).bfloat16(), tqt).float().numpy()
    plain = tquant.int8_matmul_ref(_t(x).bfloat16(), tqt).float().numpy()
    for other in (ref, plain):
        np.testing.assert_allclose(got, other, rtol=1e-2,
                                   atol=1e-2 * np.abs(ref).max())


def test_int8_cluster_split_at_the_decode_shapes():
    """The K split across CTAs that the decode step's shapes take (M=8):
    4 at [512, 512] and [512, 2048], 8 at [2048, 512], none at the head."""
    assert int8_splits(8, 512, 512) == (4, 128)
    assert int8_splits(8, 512, 2048) == (4, 128)
    assert int8_splits(8, 2048, 512) == (8, 256)
    assert int8_splits(8, 512, 32768) == (1, 512)
    assert int8_splits(1, 512, 512) == (4, 128)
