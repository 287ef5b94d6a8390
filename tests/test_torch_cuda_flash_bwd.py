"""The port's flash attention backward kernels against their plain
version, on the card.

Marked ``cuda``: every test here needs an NVIDIA Hopper card and skips
without one.  On the card (from the repository root; the JAX-side
conftest is not needed)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_flash_bwd.py

The training slice's own shapes are held in ``chip_smoke.py``; these cover
the backward kernels' other admitted shapes: head dims 32/64/128, causal
and non-causal, ragged T, B > 1, fp32 and bf16 (T below one 64-row tile
among them, for the bf16 tensor-core kernels); the edges of bf16 dk/dv's
streamed q ring (many wraps, a ragged last tile, T below one tile); two
bf16 backward calls giving bit-equal gradients (no atomics); autograd
through ``FlashAttention`` on the card; and the backward wrapper raising
where the kernels refuse the geometry, since on the card nothing falls
back to a plain version.  The forward, paged-decode and int8 kernels, and the bf16
flash wrappers' alignment check, are in ``test_torch_cuda.py``.
"""

import pytest
import torch

from theanompi_torch.ops.attention import blockwise_attention
from theanompi_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100, see module doc)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _close(out, ref, rel, row, floor=0.0):
    """|out - ref| <= rel * |ref| + row * rms(ref's row) + floor, element
    by element, a row being one vector of the last axis."""
    o, r = out.float(), ref.float()
    rms = r.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return bool(((o - r).abs() <= rel * r.abs() + row * rms + floor).all())


#: kernels 2 and 3 against their plain version.  fp32: the sums over up
#: to T terms run in another order, and dp - delta cancels, so an error is
#: held against its row's rms (1e-4) as well as the element (1e-4).  bf16:
#: ds and p round to bf16 inside the kernels, and one that sits on a
#: rounding edge may go either way (the forward's flash row term, 2**-5);
#: the outputs round once more (2**-7)
BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2 ** -7, 2 ** -5)}
#: bf16 dq only, beside BWD_TOL: an absolute floor at 1e-5 of the largest
#: |dq|.  Kernel 2's tensor-core products accumulate in fp32 but do not
#: round to nearest at every add as IEEE sums do, so in a row whose true
#: gradient is 0 (the first causal query) dp - delta leaves ~1e-7 |dp|
#: where the plain version's sums cancel exactly (chip_smoke.py's
#: DQ_BF16_FLOOR)
DQ_BF16_FLOOR = 1e-5


@pytest.mark.parametrize("dtype,b,t,h,d,causal", [
    (dtype, *shape) for dtype in (torch.float32, torch.bfloat16)
    for shape in [(2, 16, 2, 32, True), (1, 80, 3, 128, True),
                  (2, 208, 2, 64, False), (3, 192, 1, 64, True),
                  (1, 48, 2, 128, False), (2, 1040, 2, 32, False)]] + [
    # the edges of bf16 dk/dv's streamed q/dO ring (kernel 3)
    (torch.bfloat16, 2, 1024, 2, 64, True),   # key tile 0: 16 q tiles
    (torch.bfloat16, 1, 640, 2, 128, False),  # every key tile: 10 q tiles
    (torch.bfloat16, 2, 1040, 2, 32, True),   # ragged last key and q tiles
    (torch.bfloat16, 3, 16, 2, 64, False),    # T below one tile
    (torch.bfloat16, 2, 48, 1, 128, True)])
def test_flash_bwd_kernels_match_plain(dtype, b, t, h, d, causal):
    gen = torch.Generator(device="cuda").manual_seed(t * d + causal)
    q, k, v, g = (torch.randn(b, t, h, d, device="cuda", generator=gen)
                  .to(dtype) for _ in range(4))
    out, lse = flash_attention(q, k, v, causal)
    got = flash_attention_bwd(q, k, v, out, lse, g, causal)
    ref = flash_attention_bwd_ref(q, k, v, out, lse, g, causal)
    torch.cuda.synchronize()
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.shape == q.shape and a.dtype == dtype
        assert torch.isfinite(a.float()).all()
        floor = (DQ_BF16_FLOOR * float(r.float().abs().max())
                 if i == 0 and dtype == torch.bfloat16 else 0.0)
        assert _close(a, r, *BWD_TOL[dtype], floor)


def test_bf16_flash_bwd_is_deterministic():
    """No atomics: two bf16 backward calls on the same inputs give
    bit-equal dq, dk and dv."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, g = (torch.randn(2, 1040, 2, 64, device="cuda", generator=gen)
                  .to(torch.bfloat16) for _ in range(4))
    out, lse = flash_attention(q, k, v, True)
    first = flash_attention_bwd(q, k, v, out, lse, g, True)
    second = flash_attention_bwd(q, k, v, out, lse, g, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_autograd_on_the_card_matches_blockwise_autograd():
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, g = (torch.randn(2, 128, 2, 64, device="cuda", generator=gen)
                  for _ in range(4))
    a = [x.clone().requires_grad_() for x in (q, k, v)]
    out, _ = FlashAttention.apply(*a, True)
    got = torch.autograd.grad((out * g).sum(), a)
    b = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad((blockwise_attention(*b, True) * g).sum(), b)
    for x, r in zip(got, ref):
        # rows whose true gradient is 0 (the first causal query's dq) come
        # out at ~1e-8 from dp - delta: an absolute floor at 1e-5 of the
        # largest gradient, beside the elementwise 1e-4
        assert torch.allclose(x, r, rtol=1e-4, atol=1e-5 * float(
            r.abs().max()))


def test_flash_bwd_wrapper_raises_on_unsupported_shapes():
    for t, d in ((64, 48), (24, 64)):
        x = torch.zeros(1, t, 2, d, device="cuda")
        lse = torch.zeros(1, 2, t, device="cuda")
        with pytest.raises(ValueError, match="unsupported"):
            flash_attention_bwd(x, x, x, x, lse, x, True)
