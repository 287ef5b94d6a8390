"""fp32 flash attention forward (kernel 1's fp32 path) on the card: three
TF32 passes a product on the tensor cores.

Marked ``cuda``: every test here needs an NVIDIA Hopper card and skips
without one.  On the card (from the repository root; the JAX-side conftest
is not needed)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_flash_fwd_fp32.py

fp32 out and lse against the plain version at the ragged T=1040 and head
dims 32/64/128, causal and full, and at B=1 T=8192 causal (the longest
chains of sums), at the fp32 limits of every forward check (out
2e-5 |ref| + 2e-5 rms(row), lse 2e-5); two calls giving bit-equal out and
lse (no atomics, a fixed order of sums); the kernel's SASS holding TF32
``HMMA`` (``mma.sync``) instructions for each head dim; and the wrapper
refusing an fp32 operand that is not 16-byte aligned.  The arithmetic
itself is emulated on the CPU in ``test_torch_tf32x3_fwd.py``.
"""

import os
import re
import shutil
import subprocess

import pytest
import torch

from theanompi_torch import kernels as K
from theanompi_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_ref,
)

pytestmark = pytest.mark.cuda

#: out: |out - ref| <= REL |ref| + ROW rms(ref's row) (the sums run in
#: another order than the plain version's); lse: absolute
REL, ROW, LSE_TOL = 2e-5, 2e-5, 2e-5


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100, see module doc)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _case(seed, b, t, h, d):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, t, h, d, device="cuda", generator=gen)
            for _ in range(3)]


def _assert_matches_plain(q, k, v, causal):
    out, lse = flash_attention(q, k, v, causal)
    r_out, r_lse = flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert torch.isfinite(lse).all()
    rms = r_out.pow(2).mean(dim=-1, keepdim=True).sqrt()
    assert bool(((out - r_out).abs() <= REL * r_out.abs() + ROW * rms).all())
    assert float((lse - r_lse).abs().max()) <= LSE_TOL


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_fp32_fwd_matches_plain_at_ragged_t(d, causal):
    _assert_matches_plain(*_case(d + causal, 2, 1040, 2, d), causal)


@pytest.mark.parametrize("d", [64, 128])
def test_fp32_fwd_matches_plain_at_t8192(d):
    """The last q tile's rows sum 8192 keys: 128 tiles of P.v into one
    running accumulator, each tile's rounded to nearest as it is added."""
    _assert_matches_plain(*_case(d, 1, 8192, 2, d), True)


def test_fp32_fwd_is_deterministic():
    q, k, v = _case(11, 2, 1040, 2, 64)
    first = flash_attention(q, k, v, True)
    second = flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_fp32_fwd_sass_runs_tf32_mma():
    """Each ``flash_fwd_tf32x3_kernel<D>`` holds TF32 HMMA instructions:
    the fp32 products run on the tensor cores."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        pytest.skip("cuobjdump not found")
    K.build_all()
    sass = subprocess.run([tool, "-sass", K._lib_path("flash_fwd.cu")],
                          capture_output=True, text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
        elif fn and "flash_fwd_tf32x3_kernel" in fn:
            d = re.search(r"ILi(\d+)E", fn).group(1)
            counts[d] = counts.get(d, 0) + ("HMMA" in line and ".TF32" in line)
    assert sorted(counts) == ["128", "32", "64"]
    assert all(n > 0 for n in counts.values()), counts


def test_fp32_fwd_raises_on_misaligned_operands():
    """fp32 kernel 1 copies 16 bytes at a time: a view one element past an
    aligned base raises."""
    shape = (1, 64, 2, 64)
    off = torch.zeros(64 * 2 * 64 + 1, device="cuda")[1:].view(shape)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    x = torch.zeros(shape, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(x, off, x, True)
