"""fp32 flash attention dk and dv (kernel 3's fp32 path) on the card: three
TF32 passes a product on the tensor cores.

Marked ``cuda``: every test here needs an NVIDIA Hopper card and skips
without one.  On the card (from the repository root; the JAX-side conftest
is not needed)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_flash_dkv_fp32.py

fp32 dk and dv against the plain version at the ragged T=1040 and head
dims 32/64/128, causal and full, at the fp32 limit of every backward check
(1e-4 |ref| + 1e-4 rms(row), no floor); two calls giving bit-equal dk and
dv (no atomics, a fixed order of sums); the last causal key's dk where its
dp - delta cancels (made so); the kernel's SASS holding TF32
``HMMA`` (``mma.sync``) instructions for each head dim; and the wrapper
refusing an fp32 lse that is not 16-byte aligned (kernel 3 copies its
lse 16 bytes at a time).  The arithmetic itself is emulated on the CPU in
``test_torch_tf32x3_dkv.py``; the other backward shapes are in
``test_torch_cuda_flash_bwd.py``.
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
def test_fp32_dkv_matches_plain_at_ragged_t(d, causal):
    q, k, v, out, lse, g = _case(d + causal, 2, 1040, 2, d, causal)
    got = flash_attention_bwd(q, k, v, out, lse, g, causal)[1:]
    ref = flash_attention_bwd_ref(q, k, v, out, lse, g, causal)[1:]
    torch.cuda.synchronize()
    for x, r in zip(got, ref):
        assert x.dtype == torch.float32 and torch.isfinite(x).all()
        # the sums run in another order, and dp - delta cancels, so an
        # error is held against its row's rms as well as the element
        # (chip_smoke.py's BWD_TOL["float32"])
        rms = r.pow(2).mean(dim=-1, keepdim=True).sqrt()
        assert bool(((x - r).abs() <= 1e-4 * r.abs() + 1e-4 * rms).all())


def test_fp32_dk_of_the_last_causal_key_where_dp_cancels():
    """The last causal key's dk is the one term p (dp - delta) qs: with the
    last query's d_out made nearly orthogonal to v[T-1] - out[T-1], dp -
    delta cancels to ~1e-4 of dp, and dk there still meets the fp32 limit
    (the kernel sums that tile's dp as the plain version does)."""
    q, k, v, out, lse, g = _case(5, 2, 1040, 2, 64, True)
    w = (v[:, -1] - out[:, -1]).double()
    last = g[:, -1].double()
    g[:, -1] = (last - ((last * w).sum(-1, keepdim=True) / (w * w).sum(
        -1, keepdim=True) - 1e-6) * w).float()
    dk = flash_attention_bwd(q, k, v, out, lse, g, True)[1]
    ref = flash_attention_bwd_ref(q, k, v, out, lse, g, True)[1]
    torch.cuda.synchronize()
    rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    assert bool(((dk - ref).abs() <= 1e-4 * ref.abs() + 1e-4 * rms).all())


def test_fp32_dkv_is_deterministic():
    q, k, v, out, lse, g = _case(11, 2, 1040, 2, 64, True)
    first = flash_attention_bwd(q, k, v, out, lse, g, True)[1:]
    second = flash_attention_bwd(q, k, v, out, lse, g, True)[1:]
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_fp32_dkv_sass_runs_tf32_mma():
    """Each ``flash_bwd_dkv_tf32x3_kernel<D>`` holds TF32 HMMA
    instructions: the fp32 products run on the tensor cores."""
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
        elif fn and "flash_bwd_dkv_tf32x3_kernel" in fn:
            d = re.search(r"ILi(\d+)E", fn).group(1)
            counts[d] = counts.get(d, 0) + ("HMMA" in line and ".TF32" in line)
    assert sorted(counts) == ["128", "32", "64"]
    assert all(n > 0 for n in counts.values()), counts


def test_fp32_bwd_raises_on_misaligned_lse():
    """fp32 kernel 3 copies lse 16 bytes at a time: an lse view one element
    past an aligned base raises."""
    x = torch.zeros(1, 64, 2, 64, device="cuda")
    off = torch.zeros(2 * 64 + 1, device="cuda")[1:].view(1, 2, 64)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd(x, x, x, x, off, x, True)
