"""fp32 kernel 3's arithmetic, emulated on the CPU, against the plain
version and the reference.

On the card fp32 dk/dv (``kernels/csrc/flash_bwd.cu``,
``flash_bwd_dkv_tf32x3_kernel``) runs each product on the tensor cores as
three TF32 passes (``kernels/csrc/tf32x3.cuh``), with keys as the
accumulators' rows: Sᵀ = k.qsᵀ and dPᵀ = v.dOᵀ over D, then dV += Pᵀ.dO
and dK += dSᵀ.qs over the queries of each q tile.  A CUDA kernel has no CPU
mode, so this file repeats its arithmetic in torch on the split and
three-pass product of ``test_torch_tf32x3.py`` (al.bh + ah.bl + ah.bh over
each 8-deep step into an fp32 accumulator): qs = q * scale in fp32, the
queries of dV and dK taken in the kernel's pair order (8j + 2t,
8j + 2t + 1), the two 32-query halves of every q tile summed apart over
the whole loop and added at the end, and dPᵀ of the last causal key
tile's diagonal tile in plain fp32.  The emulation is held, on numpy
inputs from a seed, to the plain version (``flash_attention_bwd_ref``) and
to ``jax.grad`` through the reference's Pallas flash attention in
interpret mode, at the card's fp32 limit ``1e-4 |ref| + 1e-4 rms(ref's
row)`` with no floor.  One TF32 pass is shown to break the limit, and so
are three without the plain dPᵀ where the last key's dp - delta cancels.
The emulation adds in fp32 rounded to nearest, where the mma on the card
rounds its sums otherwise (toward zero, as the card's errors suggest), so
the card's margins are smaller than these.  The card runs the kernel
itself against the plain version (``test_torch_cuda_flash_dkv_fp32.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_tf32x3 import KEY_ORDER, _inputs, _t, product, worst_ratio
from theanompi_tpu.ops.pallas_attention import flash_attention as j_flash

from theanompi_torch.ops.flash_attention import (
    _delta,
    flash_attention_bwd_ref,
    flash_attention_ref,
)

#: the kernel's warps per 16-key row group, each taking one half of every
#: q tile: 32 queries, four 8-query n-tiles
HALVES, NJ = 2, 4


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def emulated_dkv(q, k, v, out, lse, d_out, causal, passes=3,
                 exact_last=True):
    """fp32 (dk, dv) as kernel 3 computes them on the card (see the module
    doc); ``exact_last=False`` takes the last causal diagonal tile's dPᵀ in
    three TF32 passes too."""
    b, t, h, d = q.shape
    scale = d ** -0.5
    tp = -(-t // 64) * 64  # zero rows past T, as the kernel's loads give

    def heads(x):
        x = x.permute(0, 2, 1, 3)
        return torch.nn.functional.pad(x, (0, 0, 0, tp - t))

    qs = heads(q * torch.tensor(scale, dtype=torch.float32))
    kf, vf, dof = heads(k), heads(v), heads(d_out)
    pad = torch.nn.functional.pad
    lse_p, delta = pad(lse, (0, tp - t)), pad(_delta(out, d_out), (0, tp - t))
    # a half's queries in the order of its 8-deep steps
    order = torch.tensor([j0 + i for j0 in range(0, 8 * NJ, 8)
                          for i in KEY_ORDER])
    dk, dv = torch.zeros(b, h, tp, d), torch.zeros(b, h, tp, d)
    for k0 in range(0, tp, 64):
        keys = slice(k0, k0 + 64)
        kt, vt = kf[:, :, keys], vf[:, :, keys]
        dk_h = [torch.zeros(b, h, 64, d) for _ in range(HALVES)]
        dv_h = [torch.zeros(b, h, 64, d) for _ in range(HALVES)]
        for q0 in range(k0 if causal else 0, tp, 64):
            rows = slice(q0, q0 + 64)
            zero = torch.zeros(b, h, 64, 64)
            st = product(zero, kt, qs[:, :, rows].transpose(-1, -2), passes)
            if exact_last and causal and q0 == k0 == tp - 64:
                # plain fp32, as the plain version forms dp
                dpt = (dof[:, :, rows] @ vt.transpose(-1, -2)).transpose(
                    -1, -2)
            else:
                dpt = product(zero, vt, dof[:, :, rows].transpose(-1, -2),
                              passes)
            pt = torch.exp(st - lse_p[:, :, None, rows])
            ki = torch.arange(k0, k0 + 64)[:, None]
            qi = torch.arange(q0, q0 + 64)[None, :]
            keep = (qi < t) & ((ki <= qi) | (not causal))
            pt = torch.where(keep, pt, torch.zeros_like(pt))
            dst = pt * (dpt - delta[:, :, None, rows])
            for half in range(HALVES):
                cols = order + 8 * NJ * half
                dv_h[half] = product(dv_h[half], pt[..., cols],
                                     dof[:, :, q0 + cols], passes)
                dk_h[half] = product(dk_h[half], dst[..., cols],
                                     qs[:, :, q0 + cols], passes)
        dk[:, :, keys] = dk_h[0] + dk_h[1]
        dv[:, :, keys] = dv_h[0] + dv_h[1]

    def back(x):
        return x[:, :, :t].permute(0, 2, 1, 3).contiguous()

    return back(dk), back(dv)


@pytest.mark.parametrize("b,t,d,causal", [
    (1, 128, 32, True), (2, 256, 64, True), (1, 208, 64, True),
    (1, 128, 128, True), (2, 128, 64, False), (1, 256, 128, False),
    (1, 192, 32, False)])
def test_emulated_dkv_matches_plain_and_reference(b, t, d, causal):
    q, k, v, g = _inputs(t + d + causal, b, t, d)
    out, lse = flash_attention_ref(_t(q), _t(k), _t(v), causal)
    got = emulated_dkv(_t(q), _t(k), _t(v), out, lse, _t(g), causal)
    plain = flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse, _t(g),
                                    causal)[1:]

    def f(k, v):
        return jnp.sum(j_flash(jnp.asarray(q), k, v, causal=causal,
                               interpret=True) * g)

    ref = jax.grad(f, argnums=(0, 1))(jnp.asarray(k), jnp.asarray(v))
    for name, x, p, r in zip(("dk", "dv"), got, plain, ref):
        assert worst_ratio(x, p) <= 1, name
        assert worst_ratio(x, _t(r)) <= 1, name


def test_one_tf32_pass_breaks_the_fp32_limit():
    """The written reason for three passes: at B=1 T=256 H=2 D=64 causal,
    dk and dv from one TF32 pass a product miss the fp32 limit by far,
    where three passes meet it."""
    q, k, v, g = map(_t, _inputs(11, 1, 256, 64))
    out, lse = flash_attention_ref(q, k, v, True)
    plain = flash_attention_bwd_ref(q, k, v, out, lse, g, True)[1:]
    three = emulated_dkv(q, k, v, out, lse, g, True)
    one = emulated_dkv(q, k, v, out, lse, g, True, passes=1)
    for x, x1, p in zip(three, one, plain):
        assert worst_ratio(x, p) <= 1
        assert worst_ratio(x1, p) > 10


def test_last_causal_key_needs_dp_summed_as_the_plain_version():
    """The written reason for the kernel's FFMA dPᵀ on the last causal
    diagonal tile: the last key sees one query, so its dk is the one term
    p (dp - delta) qs.  Where dp - delta cancels to a small part of dp (the
    last query's d_out made nearly orthogonal to v[T-1] - out[T-1]), dp
    from three TF32 passes misses a limit set by that row's own size by
    orders of magnitude, and the plain version's dp meets it."""
    b, t, h, d = 1, 128, 2, 64
    q, k, v, g = map(_t, _inputs(5, b, t, d))
    out, lse = flash_attention_ref(q, k, v, True)
    w = (v[0, -1] - out[0, -1]).double()                 # [H, D]
    last = g[0, -1].double()
    last = last - ((last * w).sum(-1, keepdim=True) / (w * w).sum(
        -1, keepdim=True) - 1e-6) * w
    g[0, -1] = last.float()
    plain = flash_attention_bwd_ref(q, k, v, out, lse, g, True)[1]
    dp = (g[0, -1] * v[0, -1]).sum(-1)
    delta = (g[0, -1] * out[0, -1]).sum(-1)
    assert float(((dp - delta).abs() / dp.abs()).max()) < 1e-3
    assert worst_ratio(emulated_dkv(q, k, v, out, lse, g, True)[0],
                       plain) <= 1
    three = emulated_dkv(q, k, v, out, lse, g, True, exact_last=False)[0]
    assert worst_ratio(three, plain) > 10
    assert worst_ratio(three[:, :-1], plain[:, :-1]) <= 1


@pytest.mark.parametrize("warps_a_group", [1, 2])
def test_diagonal_tile_skips_only_masked_n_tiles(warps_a_group):
    """On the diagonal tile a warp skips its n-tiles before the first one
    that holds a query at or after one of its keys: the first index
    ``clamp((r0 - qb) / 8, 0, NJ)`` the kernel computes (``r0`` its first
    key row, ``qb`` its first query), for either warp split.  Every n-tile
    before it is fully masked and every one from it on is not."""
    nj = 8 // warps_a_group
    for r0 in range(0, 64, 16):
        for qb in range(0, 64, 8 * nj):
            first = min(max((r0 - qb) // 8, 0), nj)
            for j in range(nj):
                queries = range(qb + 8 * j, qb + 8 * j + 8)
                seen = any(key <= query for key in range(r0, r0 + 16)
                           for query in queries)
                assert seen == (j >= first), (r0, qb, j)
