"""The plain versions of the port's five kernels against the reference.

Each kernel of the PyTorch/CUDA port (flash attention forward and its two
backward kernels, paged decode attention, int8 weight matmul) has a plain
PyTorch version beside it, which a CPU tensor runs and ``chip_smoke.py`` holds the CUDA kernel
against on the card.  Here, on the CPU, each plain version is held against
the JAX package's own functions — the Pallas kernels in interpret mode and
their pure-JAX fallbacks — on the same numpy inputs from a seed.  The two
backward kernels' plain version is held in ``test_torch_flash_bwd.py``.

Tolerance: rtol 1e-5 / atol 1e-6 in fp32 unless a reason is written.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanompi_tpu.ops import quant as jquant
from theanompi_tpu.ops.pallas_attention import flash_attention as j_flash
from theanompi_tpu.ops.pallas_attention import _fwd_call as j_fwd_call
from theanompi_tpu.ops.pallas_paged_attention import (
    paged_attend_decode as j_paged,
)
from theanompi_tpu.parallel.ring_attention import (
    blockwise_attention as j_blockwise,
)
from theanompi_tpu.serving.kv_cache import PagedKVCache as JCache

from theanompi_torch.convert import quantized_from_jax
from theanompi_torch.ops import quant as tquant
from theanompi_torch.ops.attention import blockwise_attention
from theanompi_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_ref,
    flash_attention_supported,
)
from theanompi_torch.ops.paged_attention import (
    paged_attend_decode,
    paged_attend_decode_ref,
    paged_decode_supported,
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


# -- kernel 1: flash attention forward ----------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t,h,d", [(2, 32, 2, 16), (1, 128, 2, 32)])
def test_flash_ref_matches_pallas_interpret_and_blockwise(causal, b, t, h, d):
    rng = np.random.RandomState(t + d + causal)
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))
    out, lse = flash_attention_ref(_t(q), _t(k), _t(v), causal)
    # the Pallas kernel in interpret mode, out AND its padded lse tiles
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, interpret=True))
    bq = min(512, t)
    j_out, j_lse = j_fwd_call(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        causal=causal, block_q=bq, block_k=min(1024, t), interpret=True)
    j_lse = np.asarray(j_lse)[:, :, :, 0, :].reshape(b, h, t)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), j_lse, rtol=RTOL, atol=ATOL)
    bw = np.asarray(j_blockwise(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(out.numpy(), bw, rtol=RTOL, atol=ATOL)
    # the port's own plain prefill path agrees too
    np.testing.assert_allclose(
        blockwise_attention(_t(q), _t(k), _t(v), causal).numpy(), bw,
        rtol=RTOL, atol=ATOL)


def test_flash_wrapper_on_cpu_is_the_plain_version_and_gate():
    rng = np.random.RandomState(1)
    q, k, v = (_t(rng.randn(1, 48, 2, 32).astype(np.float32))
               for _ in range(3))
    a = flash_attention(q, k, v, causal=True)
    b = flash_attention_ref(q, k, v, causal=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert flash_attention_supported(16, 64)
    assert flash_attention_supported(2048, 64)
    assert not flash_attention_supported(24, 64)   # not a 16-multiple
    assert not flash_attention_supported(128, 48)  # head dim
    # bf16 keeps the dtype and stays close to the fp32 result
    ob, lb = flash_attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 causal=True)
    assert ob.dtype == torch.bfloat16 and lb.dtype == torch.float32
    np.testing.assert_allclose(ob.float().numpy(), b[0].numpy(), atol=5e-2)


# -- kernels 2 and 3 (flash attention backward): test_torch_flash_bwd.py ------

# -- kernel 4: paged decode attention -----------------------------------------

#: null-block padding, a prefix-SHARED block, an inactive null slot,
#: ragged positions and completely full tables
TABLE_CASES = [
    ([[1, 2, 0, 0], [3, 4, 5, 0]], [5, 11]),
    ([[1, 2, 0, 0], [1, 3, 0, 0]], [7, 6]),
    ([[1, 0, 0, 0], [0, 0, 0, 0]], [2, 0]),
    ([[5, 4, 3, 2], [2, 3, 4, 5]], [15, 12]),
]


@pytest.mark.parametrize("tables,positions", TABLE_CASES)
@pytest.mark.parametrize("h,d", [(2, 16), (4, 8)])
def test_paged_ref_matches_pallas_interpret_and_fallback(tables, positions,
                                                         h, d):
    bs, nblocks = 4, 6
    rng = np.random.RandomState(h * 100 + d)
    kp = rng.randn(nblocks, bs, h, d).astype(np.float32)
    vp = rng.randn(nblocks, bs, h, d).astype(np.float32)
    q = rng.randn(len(tables), h, d).astype(np.float32)
    tbl = np.asarray(tables, np.int32)
    pos = np.asarray(positions, np.int32)
    got = paged_attend_decode_ref(_t(kp), _t(vp), _t(tbl), bs, _t(q),
                                  _t(pos)).numpy()
    assert np.isfinite(got).all()
    kern = np.asarray(j_paged(jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(tbl), bs, jnp.asarray(q),
                              jnp.asarray(pos), interpret=True))
    cache = JCache(jnp.asarray(kp)[None], jnp.asarray(vp)[None],
                   jnp.asarray(tbl), bs, decode_impl="fallback")
    fallback = np.asarray(cache.attend_decode(0, jnp.asarray(q),
                                              jnp.asarray(pos)))
    # a tolerance, not bit equality: the reference's own kernel and
    # fallback differ by ~1.8e-7 at H=4, Dh=8 (summation order)
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, fallback, rtol=RTOL, atol=ATOL)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(
        paged_attend_decode(_t(kp), _t(vp), _t(tbl), bs, _t(q), _t(pos)),
        torch.from_numpy(got))


def test_paged_gate():
    assert paged_decode_supported(8, 64, 16, torch.bfloat16)  # the slice
    assert paged_decode_supported(2, 32, 8)
    assert not paged_decode_supported(8, 48, 16)
    assert not paged_decode_supported(8, 64, 4)
    assert not paged_decode_supported(8, 64, 16, torch.float16)


# -- kernel 5: int8 weight matmul ---------------------------------------------

def _payload(seed, din, dout, chunk):
    """A reference int8 payload and its port twin (same bytes)."""
    key = jax.random.PRNGKey(seed)
    w = jax.random.normal(key, (din, dout), jnp.float32)
    q, s = jquant.quantize_chunked(w, jax.random.fold_in(key, 1), chunk)
    jqt = jquant.QuantizedTensor(q, s, (din, dout), jnp.dtype(jnp.float32))
    tqt = quantized_from_jax(np.asarray(q), np.asarray(s), (din, dout),
                             "float32")
    return jqt, tqt


@pytest.mark.parametrize("din,dout,chunk", [
    (32, 24, 24),    # row bands: one row per chunk
    (32, 24, 48),    # row bands: two rows per chunk
    (16, 48, 16),    # column bands: three chunks per row
    (64, 32, 32),
])
def test_int8_ref_matches_pallas_interpret(din, dout, chunk):
    jqt, tqt = _payload(din + dout, din, dout, chunk)
    assert tquant.int8_matmul_supported((din, dout), chunk)
    x = np.random.RandomState(2).randn(3, din).astype(np.float32)
    ref = np.asarray(jquant.int8_matmul(jnp.asarray(x), jqt,
                                        interpret=True))
    got = tquant.int8_matmul_ref(_t(x), tqt).numpy()
    # both compute (x * s) @ q in fp32; the sums run in another order
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=1e-5 * np.abs(ref).max())
    # the dequantized weight is the reference's, bit for bit
    np.testing.assert_array_equal(tqt.dequantize().numpy(),
                                  np.asarray(jqt.dequantize()))


def test_int8_ref_leading_dims_m_padding_and_bf16():
    jqt, tqt = _payload(5, 32, 24, 24)
    x = np.random.RandomState(6).randn(2, 5, 32).astype(np.float32)
    ref = np.asarray(jquant.int8_matmul(jnp.asarray(x), jqt,
                                        interpret=True))
    got = tquant.int8_matmul(_t(x), tqt).numpy()  # CPU -> plain version
    assert got.shape == (2, 5, 24)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=1e-5 * np.abs(ref).max())
    # bf16: operands round to bf16 like the Pallas body's bf16 branch
    ref_b = np.asarray(jquant.int8_matmul(jnp.asarray(x, jnp.bfloat16), jqt,
                                          interpret=True).astype(jnp.float32))
    got_b = tquant.int8_matmul_ref(_t(x).bfloat16(), tqt).float().numpy()
    np.testing.assert_allclose(got_b, ref_b, rtol=1e-2,
                               atol=1e-2 * np.abs(ref_b).max())


def test_int8_gate_and_matmul_any():
    assert not tquant.int8_matmul_supported((32, 61), 1024)  # odd vocab
    assert not tquant.int8_matmul_supported((32,), 32)
    assert not tquant.int8_matmul_supported((32, 6), 6)      # 4-col words
    assert tquant.int8_matmul_supported((512, 32768), 1024)
    assert tquant.int8_matmul_supported((2048, 512), 1024)
    jqt, tqt = _payload(9, 32, 61, 1024)
    x = np.random.RandomState(10).randn(3, 32).astype(np.float32)
    np.testing.assert_allclose(
        tquant.matmul_any(_t(x), tqt).numpy(),
        np.asarray(jquant.matmul_any(jnp.asarray(x), jqt)),
        rtol=RTOL, atol=1e-5)
    w = np.random.RandomState(13).randn(32, 8).astype(np.float32)
    assert torch.equal(tquant.matmul_any(_t(x), _t(w)), _t(x) @ _t(w))


def test_quantize_chunked_format():
    w = torch.from_numpy(
        np.random.RandomState(0).randn(40, 24).astype(np.float32))
    q, s = tquant.quantize_chunked(w, torch.Generator().manual_seed(0), 64)
    assert q.dtype == torch.int8 and q.shape == (15, 64)
    assert s.shape == (15,)
    deq = tquant.dequantize_chunked(q, s, (40, 24), torch.float32)
    assert (deq - w).abs().max() <= 1.01 * w.abs().max() / 127.0
    q2, _ = tquant.quantize_chunked(w, torch.Generator().manual_seed(0), 64)
    assert torch.equal(q, q2)
    # unbiased rounding: the mean error over many draws is ~0
    one, scale = tquant.quantize_chunk(w[0], torch.Generator().manual_seed(1))
    assert one.dtype == torch.int8 and float(scale) > 0
