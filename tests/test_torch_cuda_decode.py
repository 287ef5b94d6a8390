"""The decode step's kernels (4: paged decode, 5: int8 matmul) against
their plain versions, on the card.

Marked ``cuda``: every test here needs an NVIDIA Hopper card and skips
without one.  On the card (from the repository root)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_decode.py

Kernel 4 at long contexts (tables of 2048 tokens, slots at 2047, 255, 256
and 0, and one slot alone at 2047), block sizes 8, 16 and 32 and head
dims 32, 64 and 128; kernel 5 at the decode step's four weight shapes,
the narrow-band shapes, a split over the K rows of a cluster and a K run
of several chunks, at M = 1, 3 and 8.  Each in fp32 and bf16, each call
made twice and bit-equal, and each wrapper captured into a CUDA graph
(which fails on any host sync) and replayed to the eager result.  The
tolerances are ``test_torch_cuda.py``'s.
"""

import pytest
import torch

from theanompi_torch.ops.paged_attention import (
    paged_attend_decode,
    paged_attend_decode_ref,
    paged_split_tokens,
)
from theanompi_torch.ops.quant import (
    QuantizedTensor,
    int8_matmul,
    int8_matmul_ref,
    quantize_chunked,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100, see module doc)")
    torch.backends.cuda.matmul.allow_tf32 = False


#: |out - ref| <= rel * |ref| + row * rms(ref's row), as test_torch_cuda.py
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2 ** -7, 1e-4)}
DTYPES = (torch.float32, torch.bfloat16)


def _close(out, ref, rel, row):
    o, r = out.float(), ref.float()
    rms = r.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return bool(((o - r).abs() <= rel * r.abs() + row * rms).all())


def _paged_args(dtype, bs, d, positions, gen, h=4):
    """Each active slot on its own blocks of a table of 2048 tokens; a slot
    at 0 is inactive (all-null table)."""
    nb = 2048 // bs
    tables = torch.zeros((len(positions), nb), dtype=torch.int32)
    nxt = 1
    for i, p in enumerate(positions):
        if p:
            need = p // bs + 1
            tables[i, :need] = torch.arange(nxt, nxt + need)
            nxt += need
    kp, vp = (torch.randn(nxt, bs, h, d, device="cuda", generator=gen)
              .to(dtype) for _ in range(2))
    q = torch.randn(len(positions), h, d, device="cuda",
                    generator=gen).to(dtype)
    return (kp, vp, tables.cuda(), bs, q,
            torch.tensor(positions, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("bs,d", [(8, 32), (8, 64), (16, 64), (16, 128),
                                  (32, 64), (32, 128)])
def test_paged_long_contexts(bs, d):
    gen = torch.Generator(device="cuda").manual_seed(bs * d)
    for dtype in DTYPES:
        for positions in ([2047, 255, 256, 0], [2047]):
            args = _paged_args(dtype, bs, d, positions, gen)
            out = paged_attend_decode(*args)
            again = paged_attend_decode(*args)
            ref = paged_attend_decode_ref(*args)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all()
            assert torch.equal(out, again), (dtype, positions)
            assert _close(out, ref, *TOL[dtype]), (dtype, positions)


def test_paged_split_tokens():
    """The workspace's split size, from the kernel's geometry: sixteen
    rounds of 16-byte loads over four warps, whole pool blocks (the CPU
    twin in ``test_torch_decode_split.py`` assumes the same)."""
    for dtype, elt in ((torch.float32, 4), (torch.bfloat16, 2)):
        for d in (32, 64, 128):
            for bs in (8, 16, 32):
                tpw = 32 // (d * elt // 16)
                assert paged_split_tokens(dtype, d, bs) == max(
                    bs, 64 * tpw)


#: the decode step's weights (chunk 1024: row bands, then 1024-column
#: bands), the narrow-band shapes of test_torch_cuda.py, and a K run of
#: four 512-row chunks (16384 columns leave no K split across CTAs)
INT8_SHAPES = [
    (512, 512, 1024), (512, 2048, 1024), (2048, 512, 1024),
    (512, 32768, 1024), (64, 24, 48), (96, 64, 16), (4096, 1024, 1024),
    (64, 4096, 1024), (2048, 16384, 1024),
]


@pytest.mark.parametrize("din,dout,chunk", INT8_SHAPES)
def test_int8_kernel_at_decode_and_narrow_shapes(din, dout, chunk):
    gen = torch.Generator().manual_seed(din + dout)
    w = (torch.randn(din, dout, generator=gen) * 0.02).cuda()
    q, s = quantize_chunked(w, gen, chunk)
    qt = QuantizedTensor(q, s, (din, dout), torch.float32)
    for dtype in DTYPES:
        for m in (1, 3, 8):
            x = torch.randn(m, din, generator=gen).cuda().to(dtype)
            out = int8_matmul(x, qt)
            again = int8_matmul(x, qt)
            ref = int8_matmul_ref(x, qt)
            torch.cuda.synchronize()
            assert out.shape == (m, dout) and out.dtype == dtype
            assert torch.equal(out, again), (dtype, m)
            assert _close(out, ref, *TOL[dtype]), (dtype, m)


def _graph_replays_eager(fn):
    """Capture ``fn`` into a CUDA graph (after a warm-up call on a side
    stream, as capture wants) and replay it: -> (eager, replayed)."""
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    g.replay()
    torch.cuda.synchronize()
    return eager, out


def test_paged_captures_in_a_cuda_graph():
    gen = torch.Generator(device="cuda").manual_seed(7)
    args = _paged_args(torch.bfloat16, 16, 64, [2047, 5, 0, 300], gen)
    eager, replayed = _graph_replays_eager(lambda: paged_attend_decode(*args))
    assert torch.equal(eager, replayed)


def test_int8_captures_in_a_cuda_graph():
    gen = torch.Generator().manual_seed(8)
    w = (torch.randn(512, 2048, generator=gen) * 0.02).cuda()
    q, s = quantize_chunked(w, gen, 1024)
    qt = QuantizedTensor(q, s, (512, 2048), torch.float32)
    x = torch.randn(8, 512, generator=gen).cuda().to(torch.bfloat16)
    eager, replayed = _graph_replays_eager(lambda: int8_matmul(x, qt))
    assert torch.equal(eager, replayed)
