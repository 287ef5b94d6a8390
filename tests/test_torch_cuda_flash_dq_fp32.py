"""fp32 flash attention dq (kernel 2's fp32 path) on the card: three TF32
passes a product on the tensor cores.

Marked ``cuda``: every test here needs an NVIDIA Hopper card and skips
without one.  On the card (from the repository root; the JAX-side conftest
is not needed)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_flash_dq_fp32.py

fp32 dq against the plain version at the ragged T=1040 and head dims
32/64/128, causal and full, at the fp32 limit of every backward check
(1e-4 |ref| + 1e-4 rms(row), no floor); two calls giving bit-equal dq (no
atomics, a fixed order of sums); the kernel's SASS holding TF32 ``HMMA``
(``mma.sync``) instructions for each head dim; and the wrapper refusing an
fp32 operand that is not 16-byte aligned.  The arithmetic itself is
emulated on the CPU in ``test_torch_tf32x3.py``; the other backward shapes
are in ``test_torch_cuda_flash_bwd.py``.
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
    flash_attention_bwd,
    flash_attention_bwd_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100, see module doc)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _case(seed, b, t, h, d, causal):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn(b, t, h, d, device="cuda", generator=gen)
                  for _ in range(4))
    out, lse = flash_attention(q, k, v, causal)
    return q, k, v, out, lse, g


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_fp32_dq_matches_plain_at_ragged_t(d, causal):
    q, k, v, out, lse, g = _case(d + causal, 2, 1040, 2, d, causal)
    dq = flash_attention_bwd(q, k, v, out, lse, g, causal)[0]
    ref = flash_attention_bwd_ref(q, k, v, out, lse, g, causal)[0]
    torch.cuda.synchronize()
    assert dq.dtype == torch.float32 and torch.isfinite(dq).all()
    # the sums run in another order, and dp - delta cancels, so an error is
    # held against its row's rms as well as the element (chip_smoke.py's
    # BWD_TOL["float32"])
    rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    assert bool(((dq - ref).abs() <= 1e-4 * ref.abs() + 1e-4 * rms).all())


def test_fp32_dq_is_deterministic():
    q, k, v, out, lse, g = _case(11, 2, 1040, 2, 64, True)
    first = flash_attention_bwd(q, k, v, out, lse, g, True)[0]
    second = flash_attention_bwd(q, k, v, out, lse, g, True)[0]
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fp32_dq_sass_runs_tf32_mma():
    """Each ``flash_bwd_dq_tf32x3_kernel<D>`` holds TF32 HMMA instructions:
    the fp32 products run on the tensor cores."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        pytest.skip("cuobjdump not found")
    K.build_all()
    sass = subprocess.run([tool, "-sass", K._lib_path("flash_bwd.cu")],
                          capture_output=True, text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
        elif fn and "flash_bwd_dq_tf32x3_kernel" in fn:
            d = re.search(r"ILi(\d+)E", fn).group(1)
            counts[d] = counts.get(d, 0) + ("HMMA" in line and ".TF32" in line)
    assert sorted(counts) == ["128", "32", "64"]
    assert all(n > 0 for n in counts.values()), counts


def test_fp32_bwd_raises_on_misaligned_operands():
    """fp32 kernel 2 copies 16 bytes at a time: a view one element past an
    aligned base raises."""
    shape = (1, 64, 2, 64)
    off = torch.zeros(64 * 2 * 64 + 1, device="cuda")[1:].view(shape)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    x = torch.zeros(shape, device="cuda")
    lse = torch.zeros(1, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd(x, off, x, x, lse, x, True)
