"""The bf16 plain versions of kernels 1-3 against the reference's bf16
arithmetic.

In bf16 the port's flash kernels run on the tensor cores (bf16 operands,
fp32 accumulation), as the reference's Pallas bodies feed the MXU.  On the
card each kernel is held against its plain version (``chip_smoke.py``,
``test_torch_cuda*.py``); here, on the CPU, the plain versions are held in
bf16 against the JAX package's kernels in interpret mode at 64 x 64 blocks,
the port's key tile, on the same inputs from a seed.  At that block size
the reference's probabilities round against the same running max as the
port's, so the two differ only in the order of fp32 sums.

Tolerance, element by element: ``|port - ref| <= 2**-7 |ref| + 2**-5
rms(ref's row)`` (a row is one query's head), the smoke's bf16 limits.  The
outputs are bf16, so one ulp apart is 2**-7 relative at most; a
probability (or ds) that sits on a bf16 rounding edge may round either way
after fp32 sums in another order, moving its row by up to 2**-8 of that
key's weight — the row term.  lse: 4e-3 (such a flip moves the row's
normalizer by at most 2**-8).  dq also has an absolute floor at 1e-5 of its
largest element: a row whose true gradient is 0 (the first causal query's)
comes out at ~1e-8 from dp - delta, summed in another order than the
reference's, as in the fp32 autograd witness of ``test_torch_flash_bwd.py``.
dk and dv have no floor.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanompi_tpu.ops.pallas_attention import _fwd_call as j_fwd_call
from theanompi_tpu.ops.pallas_attention import flash_attention as j_flash

from theanompi_torch.ops.flash_attention import (
    flash_attention_bwd_ref,
    flash_attention_ref,
)

REL, ROW, LSE_TOL = 2 ** -7, 2 ** -5, 4e-3
CASES = [(1, 128, 2, 64, True), (2, 192, 1, 32, False)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, n, shape):
    """``n`` bf16 arrays from a seed, as (torch [B, T, H, D], jax
    [B, H, T, D]) pairs holding the same values."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
        j = jnp.asarray(t.float().numpy(), jnp.bfloat16).transpose(0, 2, 1, 3)
        out.append((t, j))
    return out


def _assert_within(port, ref, floor=0.0):
    p, r = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    rms = np.sqrt((r ** 2).mean(axis=-1, keepdims=True))
    assert np.all(np.abs(p - r) <= REL * np.abs(r) + ROW * rms + floor)


def _j_forward(jq, jk, jv, causal):
    """The reference's forward at 64 x 64 blocks: (out [B, H, T, D] bf16,
    lse [B, H, T] fp32 from its padded tiles)."""
    out, lse = j_fwd_call(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                          interpret=True)
    b, h, t, _ = jq.shape
    return out, np.asarray(lse)[:, :, :, 0, :].reshape(b, h, t)


@pytest.mark.parametrize("b,t,h,d,causal", CASES)
def test_flash_ref_bf16_matches_pallas_interpret_at_block_64(b, t, h, d,
                                                            causal):
    (tq, jq), (tk, jk), (tv, jv) = _inputs(t + d, 3, (b, t, h, d))
    out, lse = flash_attention_ref(tq, tk, tv, causal)
    j_out, j_lse = _j_forward(jq, jk, jv, causal)
    assert out.dtype == torch.bfloat16
    _assert_within(out.float().numpy(),
                   np.asarray(j_out.astype(jnp.float32)).transpose(0, 2, 1, 3))
    assert float(np.abs(lse.numpy() - j_lse).max()) <= LSE_TOL


@functools.lru_cache(maxsize=None)
def _bwd_pair(b, t, h, d, causal):
    """(the plain backward's (dq, dk, dv), ``jax.grad`` through the
    reference's interpreted Pallas backward, [B, T, H, D] fp32 numpy), both
    from the reference forward's out and lse, so only the backward's
    arithmetic is compared."""
    (tq, jq), (tk, jk), (tv, jv), (tg, jg) = _inputs(t * d + causal, 4,
                                                     (b, t, h, d))

    def f(q, k, v):
        o = j_flash(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                    v.transpose(0, 2, 1, 3), causal=causal, block_q=64,
                    block_k=64, interpret=True)
        return jnp.sum(o.astype(jnp.float32)
                       * jg.transpose(0, 2, 1, 3).astype(jnp.float32))

    j_grads = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    assert all(g.dtype == jnp.bfloat16 for g in j_grads)
    j_out, j_lse = _j_forward(jq, jk, jv, causal)
    out = torch.from_numpy(np.asarray(j_out.astype(jnp.float32))
                           .transpose(0, 2, 1, 3).copy()).bfloat16()
    port = flash_attention_bwd_ref(tq, tk, tv, out,
                                   torch.from_numpy(j_lse.copy()), tg, causal)
    assert all(g.dtype == torch.bfloat16 for g in port)
    return ([g.float().numpy() for g in port],
            [np.asarray(g.astype(jnp.float32)).transpose(0, 2, 1, 3)
             for g in j_grads])


@pytest.mark.parametrize("b,t,h,d,causal", CASES)
def test_flash_bwd_ref_bf16_dq_matches_jax_grad_at_block_64(b, t, h, d,
                                                           causal):
    """dq of the plain backward against ``jax.grad`` through the
    reference's interpreted Pallas backward."""
    port, ref = _bwd_pair(b, t, h, d, causal)
    _assert_within(port[0], ref[0], 1e-5 * float(np.abs(ref[0]).max()))


@pytest.mark.parametrize("grad", ["dk", "dv"])
@pytest.mark.parametrize("b,t,h,d,causal", CASES)
def test_flash_bwd_ref_bf16_dkv_matches_jax_grad_at_block_64(b, t, h, d,
                                                            causal, grad):
    """dk and dv of the plain backward against the same ``jax.grad``, with
    no floor: the witness that the rounding points kernel 3 follows (p
    rounded to bf16 before pᵀ·dO, ds before dsᵀ·qs) are the reference's."""
    port, ref = _bwd_pair(b, t, h, d, causal)
    i = {"dk": 1, "dv": 2}[grad]
    _assert_within(port[i], ref[i])
