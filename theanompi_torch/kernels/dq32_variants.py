"""Time the fp32 ``flash_bwd_dq`` kernel (kernel 2's three-pass TF32 path)
against variants of its own design, on the card::

    python -m theanompi_torch.kernels.dq32_variants

Each variant is the shipped ``csrc/flash_bwd.cu`` (with ``csrc/tf32x3.cuh``)
with one design choice undone by a text substitution, built with ``nvcc``
beside the kernels' libraries (``_build/dq32_variants/``, every build at
once; the machinery is ``dkv_variants``'s):

- ``shipped``: eight warps, two to a 16-row group, each taking 32 keys of
  every tile; hi and lo split by integer add and mask;
- ``one_warp_a_row_group``: four warps, each taking all 64 keys of a tile
  for its 16 rows (half the warps in the same shared memory);
- ``cvt_split``: hi and lo by ``cvt.rna.tf32.f32``, as PTX spells TF32
  rounding;
- ``tf32_first_tile``: the first causal tile's dp in three TF32 passes
  like every other tile's, not in FFMA.

Prints each variant's ``ptxas`` registers and spills per head dim, then,
per shape, each variant's device time (CUDA graph of 10 calls,
``chip_smoke.time_ms``, three readings), its worst error/limit against the
plain version at the fp32 limit (1e-4 |ref| + 1e-4 rms(row), as in
``chip_smoke.py``) and whether its dq is bit-equal to the shipped kernel's.
"""

from __future__ import annotations

import ctypes
import os
import sys

from theanompi_torch.kernels import BUILD_DIR
from theanompi_torch.kernels.dkv_variants import build_variants

VARIANTS = {
    "shipped": [],
    "one_warp_a_row_group": [
        ("static constexpr int THREADS = 256;",
         "static constexpr int THREADS = 128;"),
        ("static constexpr int NJ = 4;", "static constexpr int NJ = 8;")],
    "cvt_split": [
        ("""  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));""",
         """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));""")],
    "tf32_first_tile": [
        ("const bool exact = causal && q0 == 0 && kt == 0;",
         "const bool exact = false;")],
}
#: (B, T, H, D, causal): the training shape first
SHAPES = [(16, 2048, 8, 64, True), (1, 2048, 8, 64, True),
          (16, 2048, 8, 32, True), (16, 2048, 8, 128, True),
          (2, 1040, 8, 64, False)]


def main() -> int:
    import torch

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, here)
    from chip_smoke import BWD_TOL, time_ms, within
    from theanompi_torch.ops.flash_attention import (
        _delta,
        flash_attention,
        flash_attention_bwd_ref,
    )

    if not torch.cuda.is_available():
        print("dq32_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants(VARIANTS, "dq_tf32x3",
                          os.path.join(BUILD_DIR, "dq32_variants"))
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(lib).flash_bwd_dq
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(4)
    for b, t, h, d, causal in SHAPES:
        q, k, v, g = (torch.randn(b, t, h, d, device="cuda", generator=gen)
                      for _ in range(4))
        out, lse = flash_attention(q, k, v, causal)
        delta = _delta(out, g)
        ref = flash_attention_bwd_ref(q, k, v, out, lse, g, causal)[0]
        first = None
        for name, fn in fns.items():
            dq = torch.empty_like(q)

            def call():
                rc = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr(), b, t, h, d, int(causal),
                        float(d ** -0.5),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            ratio = within(dq, ref, *BWD_TOL["float32"])[1]
            if first is None:
                first = dq.clone()
            same = torch.equal(dq, first)
            ms = [time_ms(call, 10, graph=True) for _ in range(3)]
            print(f"dq fp32 B={b} T={t} H={h} D={d} "
                  f"{'causal' if causal else 'full'} {name}: ms "
                  + " ".join(f"{m:.4f}" for m in ms)
                  + f" error/limit {ratio:.3g} bit-equal to shipped: {same}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
