"""fp32 kernel 1's arithmetic, emulated on the CPU, against the plain
version and the reference.

On the card the fp32 flash forward (``kernels/csrc/flash_fwd.cu``,
``flash_fwd_tf32x3_kernel``) runs S = qs.kᵀ and P.v on the tensor cores as
three TF32 passes (``kernels/csrc/tf32x3.cuh``).  A CUDA kernel has no CPU
mode, so this file repeats its arithmetic in torch on the split and
three-pass product of ``test_torch_tf32x3.py`` (TF32 rounding on the fp32
view, al.bh + ah.bl + ah.bh over each 8-deep step into an fp32
accumulator): qs = q * scale in fp32; the two 32-key halves of every
64-key tile, each with its own running max, normalizer and accumulator
over the whole loop, merged at the end (m = max(m0, m1), c_i = e^(m_i - m),
acc = acc0 c0 + acc1 c1, l = l0 c0 + l1 c1, each as one fma); p as
2^fmaf(s, log2 e, -m log2 e) (``ex2.approx.ftz.f32`` on the card; or
``expf(s - m)``), masked p set to 0; each tile's P.v formed in a fresh
accumulator with the keys in the kernel's pair order (8j + 2t,
8j + 2t + 1; v's rows to match) and added as ``fmaf(acc, corr, tile)``.
Tiles above the diagonal, which the kernel skips, are run here fully
masked, which leaves m, l and acc exactly as they were.  The
normalizer's sums run in torch's order, not the kernel's per-thread one.

The emulation is held, on numpy inputs from a seed, to the plain version
(``flash_attention_ref``) at every shape and to the reference's Pallas
forward in interpret mode at 64 x 64 blocks where T is a multiple of 64,
at the card's fp32 limits: out ``2e-5 |ref| + 2e-5 rms(ref's row)``, lse
``2e-5``.  One TF32 pass is shown to break the out limit by more than 10x,
and a first q tile whose second key half sees no key to merge to exactly
the first half's result.  The emulation adds in fp32 rounded to nearest,
where the mma on the card rounds its sums otherwise, so the card's margins
are smaller; the card runs the kernel itself against the plain version
(``test_torch_cuda_flash_fwd_fp32.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_tf32x3 import KEY_ORDER, _t, product
from theanompi_tpu.ops.pallas_attention import _fwd_call as j_fwd_call

from theanompi_torch.ops.flash_attention import flash_attention_ref

#: the kernel's warps per 16-row group, each taking one half of every key
#: tile: 32 keys, four 8-key n-tiles
HALVES = 2
NEG_INF = -1e30
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
#: the card's fp32 limits for kernel 1 (chip_smoke.check_flash)
REL, ROW, LSE_TOL = 2e-5, 2e-5, 2e-5


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def fma(a, b, c):
    """``fmaf(a, b, c)``: a * b + c rounded once to fp32 (the product of
    two fp32 values is exact in double)."""
    return (a.double() * b.double() + c.double()).float()


def exp_sub(x, m, exp2):
    """e^(x - m) as the kernel forms a rescale or merge weight: exactly 1
    where x == m, 0 where x is -1e30 and m is not."""
    return torch.exp2((x - m) * LOG2E) if exp2 else torch.exp(x - m)


def exp_p(s, m, exp2):
    """p as the kernel forms it from a score and its row's running max
    (the card's 2^x may differ from torch's in the last bit)."""
    if exp2:
        return torch.exp2(fma(s, LOG2E, -(m * LOG2E)))
    return torch.exp(s - m)


def emulated_halves(q, k, v, causal, passes=3, exp2=True):
    """Each key half's (m, l, acc) over the whole loop, as the kernel's
    warps hold them before the merge: ``[B, H, T]``, ``[B, H, T]``,
    ``[B, H, T, D]``.  ``passes=1``: each product as one TF32 pass."""
    b, t, h, d = q.shape
    tp = -(-t // 64) * 64  # zero key rows past T, as the kernel's loads give
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    qs = (q * scale).permute(0, 2, 1, 3)
    kf, vf = (torch.nn.functional.pad(x.permute(0, 2, 1, 3),
                                      (0, 0, 0, tp - t)) for x in (k, v))
    width = 64 // HALVES
    order = torch.tensor([j0 + i for j0 in range(0, width, 8)
                          for i in KEY_ORDER])
    rows = torch.arange(t)[:, None]
    state = [(torch.full((b, h, t), NEG_INF), torch.zeros(b, h, t),
              torch.zeros(b, h, t, d)) for _ in range(HALVES)]
    for k0 in range(0, tp, 64):
        for half in range(HALVES):
            m, l, acc = state[half]
            keys = k0 + width * half + torch.arange(width)
            kt, vt = kf[:, :, keys], vf[:, :, keys]
            s = product(torch.zeros(b, h, t, width), qs,
                        kt.transpose(-1, -2), passes)
            keep = (keys[None, :] < t) & ((keys[None, :] <= rows)
                                          | (not causal))
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            corr = exp_sub(m, m_new, exp2)
            p = exp_p(s, m_new[..., None], exp2)
            p = torch.where(keep, p, torch.zeros_like(p))
            l = l * corr + p.sum(-1)
            tile = product(torch.zeros(b, h, t, d), p[..., order],
                           vt[:, :, order], passes)
            state[half] = (m_new, l, fma(acc, corr[..., None], tile))
    return state


def merge(state, exp2=True):
    """The kernel's epilogue: the key halves merged in a fixed order, ->
    (out ``[B, T, H, D]``, lse ``[B, H, T]``)."""
    (m0, l0, a0), (m1, l1, a1) = state
    m = torch.maximum(m0, m1)
    c0, c1 = exp_sub(m0, m, exp2), exp_sub(m1, m, exp2)
    l = fma(l1, c1, l0 * c0)
    acc = fma(a1, c1[..., None], a0 * c0[..., None])
    ls = l.clamp(min=1e-30)
    out = acc / ls[..., None]
    return out.permute(0, 2, 1, 3).contiguous(), m + torch.log(ls)


def emulated_fwd(q, k, v, causal, passes=3, exp2=True):
    """fp32 (out, lse) as kernel 1 computes them on the card (see the
    module doc)."""
    return merge(emulated_halves(q, k, v, causal, passes, exp2), exp2)


def out_ratio(out, ref):
    """max |out - ref| / (REL |ref| + ROW rms(ref's row))."""
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    return float(((out - ref).abs()
                  / (REL * ref.abs() + ROW * rms).clamp(min=1e-30)).max())


def _inputs(seed, b, t, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, 2, d).astype(np.float32) for _ in range(3)]


def _j_forward(q, k, v, causal):
    """The reference's forward at 64 x 64 blocks, interpret mode: (out
    ``[B, T, H, D]``, lse ``[B, H, T]`` from its padded tiles)."""
    jq, jk, jv = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v))
    out, lse = j_fwd_call(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                          interpret=True)
    b, h, t, _ = jq.shape
    return (_t(np.asarray(out)).permute(0, 2, 1, 3),
            _t(np.asarray(lse)[:, :, :, 0, :].reshape(b, h, t)))


@pytest.mark.parametrize("b,t,d,causal", [
    (1, 128, 32, True), (2, 256, 64, True), (1, 208, 64, True),
    (1, 128, 128, True), (2, 128, 64, False), (1, 256, 128, False),
    (1, 80, 32, False)])
def test_emulated_fwd_matches_plain_and_reference(b, t, d, causal):
    q, k, v = _inputs(t + d + causal, b, t, d)
    r_out, r_lse = flash_attention_ref(_t(q), _t(k), _t(v), causal)
    refs = [(r_out, r_lse)]
    if t % 64 == 0:
        refs.append(_j_forward(q, k, v, causal))
    # p as 2^x (shipped) and by expf: both within the limits
    for exp2 in (True, False):
        out, lse = emulated_fwd(_t(q), _t(k), _t(v), causal, exp2=exp2)
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
        for ref_out, ref_lse in refs:
            assert out_ratio(out, ref_out) <= 1
            assert float((lse - ref_lse).abs().max()) <= LSE_TOL


def test_one_tf32_pass_breaks_the_fp32_limit():
    """The written reason for three passes: at B=1 T=256 H=2 D=64 causal,
    out from one TF32 pass a product misses the fp32 limit by far, where
    three passes meet it."""
    q, k, v = map(_t, _inputs(11, 1, 256, 64))
    ref = flash_attention_ref(q, k, v, True)[0]
    assert out_ratio(emulated_fwd(q, k, v, True)[0], ref) <= 1
    assert out_ratio(emulated_fwd(q, k, v, True, passes=1)[0], ref) > 10


def test_empty_second_half_merges_to_the_first_half_exactly():
    """Causal, the first q tile: key half 1 (keys 32-63) lies above the
    diagonal for rows 0-31, so their half-1 warps see no key and keep
    m = -1e30, l = 0, acc = 0.  They merge with weight exactly 0: those
    rows' out and lse are bit-equal to half 0's alone, and finite."""
    q, k, v = map(_t, _inputs(5, 2, 128, 64))
    state = emulated_halves(q, k, v, True)
    (m0, l0, a0), (m1, l1, a1) = state
    assert bool((m1[..., :32] == NEG_INF).all())
    assert bool((l1[..., :32] == 0).all()) and bool((a1[..., :32, :] == 0)
                                                    .all())
    assert bool((m1[..., 32:] > NEG_INF).all())  # every later row sees one
    out, lse = merge(state)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    ls0 = l0[..., :32].clamp(min=1e-30)
    alone = (a0[..., :32, :] / ls0[..., None]).permute(0, 2, 1, 3)
    assert torch.equal(out[:, :32], alone)
    assert torch.equal(lse[..., :32], m0[..., :32] + torch.log(ls0))
