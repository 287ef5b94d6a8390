"""The plain version of the port's flash attention backward (kernels 2
and 3) against the reference.

On the CPU the backward wrapper runs its plain PyTorch version; here it is
held against ``jax.grad`` through the JAX package's Pallas flash attention
in interpret mode (its custom VJP runs the interpreted backward kernels),
and ``FlashAttention`` under autograd against autograd of the port's own
blockwise path, on the same numpy inputs from a seed.  The forward,
paged-decode and int8 plain versions are in ``test_torch_kernels_ref.py``.

Tolerance: rtol 1e-5 / atol 1e-6 in fp32 unless a reason is written.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanompi_tpu.ops.pallas_attention import flash_attention as j_flash

from theanompi_torch.ops.attention import blockwise_attention
from theanompi_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [64, 128, 192])
@pytest.mark.parametrize("d", [32, 64])
def test_flash_bwd_ref_matches_jax_grad_of_pallas_interpret(causal, t, d):
    """(dq, dk, dv) of the plain version equal ``jax.grad`` through the
    reference's ``flash_attention`` (its custom VJP: the interpreted
    ``_bwd_dq_kernel``/``_bwd_dkv_kernel``)."""
    rng = np.random.RandomState(t + d + causal)
    q, k, v, g = (rng.randn(2, t, 2, d).astype(np.float32) for _ in range(4))

    def f(q, k, v):
        return jnp.sum(j_flash(q, k, v, causal=causal, interpret=True) * g)

    ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    out, lse = flash_attention_ref(_t(q), _t(k), _t(v), causal)
    got = flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse, _t(g),
                                  causal)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
    # the wrapper on a CPU tensor is the plain version
    for a, b in zip(flash_attention_bwd(_t(q), _t(k), _t(v), out, lse,
                                        _t(g), causal), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_matches_blockwise_autograd(causal):
    """``FlashAttention.apply`` under ``torch.autograd.grad`` against
    autograd of the blockwise path (the full fp32 softmax)."""
    rng = np.random.RandomState(7 + causal)
    q, k, v, g = (_t(rng.randn(2, 96, 2, 32).astype(np.float32))
                  for _ in range(4))
    a = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = FlashAttention.apply(*a, causal)
    assert not lse.requires_grad
    got = torch.autograd.grad((out * g).sum(), a)
    b = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad((blockwise_attention(*b, causal) * g).sum(), b)
    for x, r in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), r.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_flash_bwd_bf16_keeps_dtypes_and_tracks_fp32():
    rng = np.random.RandomState(3)
    q, k, v, g = (_t(rng.randn(1, 64, 2, 64).astype(np.float32))
                  for _ in range(4))
    out, lse = flash_attention_ref(q, k, v, True)
    ref = flash_attention_bwd_ref(q, k, v, out, lse, g, True)
    qb, kb, vb, gb = (x.bfloat16() for x in (q, k, v, g))
    ob, lb = flash_attention_ref(qb, kb, vb, True)
    got = flash_attention_bwd_ref(qb, kb, vb, ob, lb, gb, True)
    for a, r in zip(got, ref):
        assert a.dtype == torch.bfloat16
        # bf16 operands and roundings against the fp32 run: a few bf16
        # ulps of the gradient's scale
        np.testing.assert_allclose(a.float().numpy(), r.numpy(),
                                   atol=5e-2 * float(r.abs().max()))
