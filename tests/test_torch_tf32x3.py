"""fp32 kernel 2's arithmetic, emulated on the CPU, against the plain
version and the reference.

On the card fp32 dq (``kernels/csrc/flash_bwd.cu``,
``flash_bwd_dq_tf32x3_kernel``) runs each product on the tensor cores as
three TF32 passes (``kernels/csrc/tf32x3.cuh``).  A CUDA kernel has no CPU
mode, so this file repeats its arithmetic in torch, bit by bit where the
bits are defined: TF32 rounding on the fp32 view (add half an ulp, mask the
low 13 bits; the mma truncates what it is given), the hi/lo split, the three
products al.bh + ah.bl + ah.bh over each 8-deep step into an fp32
accumulator, the keys of dQ += dS.k taken in the kernel's order (8j + 2t,
8j + 2t + 1), the two 32-key halves of every tile summed apart and added
at the end, and dp of the first causal key tile in plain fp32.  The
emulation is held, on numpy inputs from a seed, to the plain version
(``flash_attention_bwd_ref``) and to ``jax.grad`` through the reference's
Pallas flash attention in interpret mode, at the card's fp32 limit
``1e-4 |ref| + 1e-4 rms(ref's row)``; one TF32 pass is shown to break it.
The card runs the kernel itself against the plain version
(``test_torch_cuda_flash_dq_fp32.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanompi_tpu.ops.pallas_attention import flash_attention as j_flash

from theanompi_torch.ops.flash_attention import (
    _delta,
    flash_attention_bwd_ref,
    flash_attention_ref,
)

#: the card's fp32 limit for kernel 2 (chip_smoke.BWD_TOL["float32"])
REL, ROW = 1e-4, 1e-4
#: the order of a key step's 8 keys in dQ += dS.k: A column t is key 2t,
#: column t + 4 key 2t + 1
KEY_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def tf32_round(x):
    """To TF32, nearest with ties away from zero (``split``'s hi)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """What the mma reads of an fp32 word: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_round(x)
    return hi, tf32_trunc(x - hi)


def product(c, a, b, passes=3):
    """``c + a @ b`` as the kernel forms it: 8-deep steps, each
    ``al.bh + ah.bl + ah.bh`` into the fp32 accumulator (``passes=1``:
    ``ah.bh`` alone, one TF32 pass)."""
    (ah, al), (bh, bl) = split(a), split(b)
    for k0 in range(0, a.shape[-1], 8):
        s = slice(k0, k0 + 8)
        if passes == 3:
            c = c + al[..., s] @ bh[..., s, :]
            c = c + ah[..., s] @ bl[..., s, :]
        c = c + ah[..., s] @ bh[..., s, :]
    return c


def emulated_dq(q, k, v, out, lse, d_out, causal, passes=3,
                exact_first=True):
    """fp32 dq as kernel 2 computes it on the card (see the module doc);
    ``exact_first=False`` takes the first causal tile's dp in three TF32
    passes too."""
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
    order = torch.tensor([k0 + i for k0 in range(0, 32, 8)
                          for i in KEY_ORDER])
    dq = torch.zeros(b, h, tp, d)
    for q0 in range(0, tp, 64):
        rows = slice(q0, q0 + 64)
        halves = [torch.zeros(b, h, 64, d), torch.zeros(b, h, 64, d)]
        for k0 in range(0, min(q0 + 64, tp) if causal else tp, 64):
            kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
            zero = torch.zeros(b, h, 64, 64)
            s = product(zero, qs[:, :, rows], kt.transpose(-1, -2), passes)
            if exact_first and causal and q0 == 0 and k0 == 0:
                dp = dof[:, :, rows] @ vt.transpose(-1, -2)  # plain fp32
            else:
                dp = product(zero, dof[:, :, rows], vt.transpose(-1, -2),
                             passes)
            p = torch.exp(s - lse_p[:, :, rows, None])
            qi = torch.arange(q0, q0 + 64)[:, None]
            ki = torch.arange(k0, k0 + 64)[None, :]
            keep = (qi < t) & (ki < t) & ((ki <= qi) | (not causal))
            p = torch.where(keep, p, torch.zeros_like(p))
            ds = p * (dp - delta[:, :, rows, None])
            for half in (0, 1):
                keys = order + 32 * half
                halves[half] = product(halves[half], ds[..., keys],
                                       kt[:, :, keys], passes)
        dq[:, :, rows] = (halves[0] + halves[1]) * scale
    return dq[:, :, :t].permute(0, 2, 1, 3).contiguous()


def worst_ratio(out, ref, floor=0.0):
    """max |out - ref| / (REL |ref| + ROW rms(ref's row) + floor)."""
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    limit = (REL * ref.abs() + ROW * rms + floor).clamp(min=1e-30)
    return float(((out - ref).abs() / limit).max())


def _inputs(seed, b, t, d):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, t, 2, d).astype(np.float32) for _ in range(4))
    return q, k, v, g


@pytest.mark.parametrize("b,t,d,causal", [
    (1, 128, 32, True), (2, 256, 64, True), (1, 208, 64, True),
    (1, 128, 128, True), (2, 128, 64, False), (1, 256, 128, False),
    (1, 192, 32, False)])
def test_emulated_dq_matches_plain_and_reference(b, t, d, causal):
    q, k, v, g = _inputs(t + d + causal, b, t, d)
    out, lse = flash_attention_ref(_t(q), _t(k), _t(v), causal)
    got = emulated_dq(_t(q), _t(k), _t(v), out, lse, _t(g), causal)
    plain = flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse, _t(g),
                                    causal)[0]
    assert worst_ratio(got, plain) <= 1

    def f(q):
        return jnp.sum(j_flash(q, *map(jnp.asarray, (k, v)), causal=causal,
                               interpret=True) * g)

    ref = _t(jax.grad(f)(jnp.asarray(q)))
    # the first causal query sees one key, so its exact gradient is 0 and
    # the reference returns its own rounding of dp - delta there, as the
    # plain version (which the emulation meets to the limit) returns its
    # own: an absolute floor at 1e-5 of the largest |dq| beside the limit,
    # as the card's autograd witness holds such rows
    assert worst_ratio(got, ref, 1e-5 * float(ref.abs().max())) <= 1


def test_one_tf32_pass_breaks_the_fp32_limit():
    """The written reason for three passes: at B=1 T=256 H=2 D=64 causal,
    dq from one TF32 pass a product misses the fp32 limit by far, where
    three passes meet it."""
    q, k, v, g = map(_t, _inputs(11, 1, 256, 64))
    out, lse = flash_attention_ref(q, k, v, True)
    plain = flash_attention_bwd_ref(q, k, v, out, lse, g, True)[0]
    assert worst_ratio(emulated_dq(q, k, v, out, lse, g, True), plain) <= 1
    one = emulated_dq(q, k, v, out, lse, g, True, passes=1)
    assert worst_ratio(one, plain) > 10


def test_first_causal_rows_need_dp_summed_as_the_plain_version():
    """The written reason for the kernel's FFMA dp on the first causal
    tile: the first query sees one key, its exact gradient is 0, and the
    plain version returns the rounding of dp - delta there (~1e-7 at B=2
    T=128 H=2 D=32).  dp from three TF32 passes rounds otherwise, so that
    row misses a limit set by its own size by orders of magnitude."""
    q, k, v, g = map(_t, _inputs(3, 2, 128, 32))
    out, lse = flash_attention_ref(q, k, v, True)
    plain = flash_attention_bwd_ref(q, k, v, out, lse, g, True)[0]
    assert float(plain[:, 0].abs().max()) < 1e-5 * float(plain.abs().max())
    assert worst_ratio(emulated_dq(q, k, v, out, lse, g, True), plain) <= 1
    three = emulated_dq(q, k, v, out, lse, g, True, exact_first=False)
    assert worst_ratio(three, plain) > 100
    assert worst_ratio(three[:, 1:], plain[:, 1:]) <= 1


def test_split_recovers_fp32_to_2_pow_minus_21():
    """hi has TF32's 13 zero low bits, hi + lo (as the mma reads lo) is
    within 2^-21 |x| of x, and a product of three passes within 2^-19 of
    a.b's size, where one pass is off by more than 2^-13."""
    rng = np.random.RandomState(0)
    x = _t((rng.randn(4096) * 10.0 ** rng.randint(-8, 8, 4096))
           .astype(np.float32))
    hi, lo = split(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((hi.double() + lo.double() - x.double()).abs()
                 <= 2.0 ** -21 * x.double().abs()).all())
    a, b = (_t(rng.randn(*s).astype(np.float32)) for s in ((16, 64), (64, 8)))
    exact = a.double() @ b.double()
    size = a.double().abs() @ b.double().abs()
    three = product(torch.zeros(16, 8), a, b).double()
    one = product(torch.zeros(16, 8), a, b, passes=1).double()
    assert float(((three - exact).abs() / size).max()) < 2.0 ** -19
    assert float(((one - exact).abs() / size).max()) > 2.0 ** -13
