"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test here needs an NVIDIA Hopper card and skips
without one.  On the card (from the repository root; the JAX-side
conftest is not needed)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The serving slice's own shapes are held in ``chip_smoke.py``; these
cover the kernels' other admitted shapes: head dims 32/128, non-causal and
ragged T for flash attention forward (in bf16 the tensor-core kernel at T
below one 64-row tile, a ragged last tile and several tiles), block sizes
8/32 for paged decode, narrow bands, many rows and the unsplit-K path for
the int8 matmul; and
the wrappers raising where a kernel refuses the geometry or, for the
bf16 flash kernels, an operand's alignment, and the engine's
``decode_kernel="auto"`` raising where a kernel refuses the geometry,
since on the card nothing falls back to a plain version.  The
flash attention backward kernels are in ``test_torch_cuda_flash_bwd.py``.
"""

import numpy as np
import pytest
import torch

from theanompi_torch.models.transformer_lm import TransformerLM

from theanompi_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_ref,
)
from theanompi_torch.ops.paged_attention import (
    paged_attend_decode,
    paged_attend_decode_ref,
)
from theanompi_torch.ops.quant import (
    QuantizedTensor,
    int8_matmul,
    int8_matmul_ref,
    quantize_chunked,
)
from theanompi_torch.serving import InferenceEngine

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100, see module doc)")
    torch.backends.cuda.matmul.allow_tf32 = False


#: element by element, |out - ref| <= rel * |ref| + row * rms(ref's row),
#: a row being one vector of the last axis.  fp32: the kernels' sums run
#: in another order.  bf16: an output may round one ulp (2**-7 relative)
#: apart; flash attention also rounds each probability to bf16, and one
#: that sits on a rounding edge may go either way, moving its row by up to
#: 2**-8 of that key's weight — the flash row term
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2 ** -7, 1e-4)}
FLASH_BF16_ROW = 2 ** -5


def _close(out, ref, rel, row):
    o, r = out.float(), ref.float()
    rms = r.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return bool(((o - r).abs() <= rel * r.abs() + row * rms).all())


#: kernel 1's shapes: in both dtypes, T below one 64-row tile (16, 48), a
#: ragged last tile (80) and several key tiles at head dim 32 (208); in
#: bf16 also three whole causal tiles (192) and a long ragged T at head dim
#: 128 (1040).  fp32 runs the three-pass TF32 kernel, whose longer shapes
#: are in ``test_torch_cuda_flash_fwd_fp32.py``.
FLASH_SHAPES = [(2, 16, 2, 32, True), (1, 48, 3, 128, True),
                (2, 80, 2, 64, False), (1, 208, 1, 32, False)]
FLASH_BF16_SHAPES = [(1, 192, 2, 64, True), (2, 1040, 1, 128, False)]


@pytest.mark.parametrize("dtype,b,t,h,d,causal", [
    (dtype, *shape)
    for dtype in (torch.float32, torch.bfloat16) for shape in FLASH_SHAPES
] + [(torch.bfloat16, *shape) for shape in FLASH_BF16_SHAPES])
def test_flash_kernel_matches_plain(dtype, b, t, h, d, causal):
    gen = torch.Generator(device="cuda").manual_seed(t * d)
    q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=gen)
               .to(dtype) for _ in range(3))
    out, lse = flash_attention(q, k, v, causal)
    r_out, r_lse = flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    rel, row = TOL[dtype]
    assert _close(out, r_out, rel,
                  FLASH_BF16_ROW if dtype == torch.bfloat16 else row)
    lse_tol = 2e-5 if dtype == torch.float32 else 4e-3
    assert float((lse - r_lse).abs().max()) <= lse_tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,d", [(8, 32), (32, 128), (16, 64)])
def test_paged_kernel_matches_plain(dtype, bs, d):
    gen = torch.Generator(device="cuda").manual_seed(bs + d)
    h, n_blocks, nb = 3, 40, 8
    positions = torch.tensor([0, bs * nb - 1, 3, bs + 1], dtype=torch.int32)
    tables = torch.zeros((4, nb), dtype=torch.int32)
    tables[1] = torch.arange(1, nb + 1)
    tables[2, 0] = 9
    tables[3, :2] = torch.tensor([1, 12])  # shares block 1 with slot 1
    kp, vp = (torch.randn(n_blocks, bs, h, d, device="cuda", generator=gen)
              .to(dtype) for _ in range(2))
    q = torch.randn(4, h, d, device="cuda", generator=gen).to(dtype)
    args = (kp, vp, tables.cuda(), bs, q, positions.cuda())
    out = paged_attend_decode(*args)
    ref = paged_attend_decode_ref(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _close(out, ref, *TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,din,dout,chunk", [
    (17, 64, 24, 48),       # row bands of 24 columns, three M tiles
    (3, 96, 64, 16),        # column bands of 16
    (8, 4096, 1024, 1024),  # split K
    (1, 64, 4096, 1024),    # many column blocks, no split
])
def test_int8_kernel_matches_plain(dtype, m, din, dout, chunk):
    gen = torch.Generator().manual_seed(m + din)
    w = torch.randn(din, dout, generator=gen).cuda()
    q, s = quantize_chunked(w, gen, chunk)
    qt = QuantizedTensor(q, s, (din, dout), torch.float32)
    x = torch.randn(2, m, din, generator=gen).cuda().to(dtype)
    out = int8_matmul(x, qt)
    ref = int8_matmul_ref(x, qt)
    torch.cuda.synchronize()
    assert out.shape == (2, m, dout) and out.dtype == dtype
    assert _close(out, ref, *TOL[dtype])


def test_cuda_wrappers_raise_on_unsupported_shapes():
    q = torch.zeros(1, 24, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="unsupported"):
        flash_attention(q, q, q, True)
    pool = torch.zeros(4, 4, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="unsupported"):
        paged_attend_decode(pool, pool,
                            torch.zeros((1, 2), dtype=torch.int32,
                                        device="cuda"), 4,
                            torch.zeros(1, 2, 64, device="cuda"),
                            torch.zeros(1, dtype=torch.int32, device="cuda"))


def test_bf16_flash_wrappers_raise_on_misaligned_operands():
    """The bf16 kernels 1-3 load and store through TMA, which wants 16-byte
    aligned operands (kernel 3 reads lse through TMA too): a view one
    element past an aligned base raises."""
    shape = (2, 64, 2, 64)
    base = torch.zeros(2 * 64 * 2 * 64 + 1, device="cuda",
                       dtype=torch.bfloat16)
    off = base[1:].view(shape)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    x = torch.zeros(shape, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(off, x, x, True)
    lse = torch.zeros(2, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd(x, x, x, x, lse, off, True)
    lse_off = torch.zeros(2 * 2 * 64 + 1, device="cuda")[1:].view(2, 2, 64)
    assert lse_off.is_contiguous() and lse_off.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd(x, x, x, x, lse_off, x, True)


@pytest.mark.parametrize("dim,heads,vocab,block_size,quant,stage", [
    (96, 2, 64, 16, False, "prefill"),  # head dim 48: kernel 1 refuses it
    (128, 2, 64, 4, False, "decode"),   # block size 4: kernel 4 refuses it
    (128, 2, 61, 16, True, "decode"),   # odd-vocab int8 head: kernel 5 too
])
def test_engine_auto_raises_where_a_kernel_refuses_the_geometry(
        dim, heads, vocab, block_size, quant, stage):
    """On the card ``auto`` means the kernels: a geometry a kernel does not
    take raises instead of serving on a plain version."""
    cfg = {"dim": dim, "heads": heads, "n_layers": 1, "seq_len": 64,
           "vocab": vocab, "precision": "fp32"}
    model = TransformerLM(cfg)
    params, _ = model.init_params(torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, params, block_size=block_size,
                             max_batch=2, quantize_int8=quant)
    assert engine.decode_impl == "kernel"
    prompt = list(range(1, 17))
    row = list(range(1, 1 + 16 // block_size))
    refused = "unsupported|does not tile"
    if stage == "prefill":
        with pytest.raises(ValueError, match=refused):
            engine.prefill(row, prompt)
        return
    engine.prefill(row, prompt)
    tables = np.zeros((2, engine.max_blocks_per_seq), np.int32)
    tables[0, :16 // block_size + 1] = np.arange(1, 16 // block_size + 2)
    with pytest.raises(ValueError, match=refused):
        engine.decode(tables, np.array([16, 0], np.int32),
                      np.array([5, 0], np.int32), np.zeros(2, np.float32),
                      np.array([0, 1], np.int32))
