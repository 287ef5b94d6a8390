"""Time the fp32 ``flash_fwd`` kernel (kernel 1's three-pass TF32 path)
against variants of its own design, on the card::

    python -m theanompi_torch.kernels.fwd32_variants

Each variant is the shipped ``csrc/flash_fwd.cu`` (with ``csrc/tf32x3.cuh``)
with one design choice undone by a text substitution, built with ``nvcc``
beside the kernels' libraries (``_build/fwd32_variants/``, every build at
once; the machinery is ``dkv_variants``'s):

- ``shipped``: eight warps, two to a 16-row group, each taking 32 keys of
  every tile with its own running max, normalizer and accumulator, merged
  at the end; each tile's P.v summed from zero and added to the
  accumulator in fp32; qs split into hi and lo once, into two shared tiles
  (six tiles a CTA); p by the hardware's ``ex2.approx.ftz.f32``;
- ``one_warp_a_row_group``: four warps, each taking all 64 keys of a tile
  for its 16 rows (half the warps in the same shared memory, no merge);
- ``chained_acc``: P.v accumulated by the mma straight into the running
  accumulator (rescaled first), a chain of 3 x T/8 adds at the last rows;
- ``split_per_load``: each warp splits every q fragment it loads (five
  tiles a CTA);
- ``exp2f``: p by ``exp2f``, which takes care of results below 2^-126
  (a few instructions more per p);
- ``expf``: p = e^(s - m) by ``expf``, as the plain version forms it.

Prints each variant's ``ptxas`` registers and spills per head dim, then,
per shape, SDPA's fp32 forward time (the library yardstick) and each
variant's worst out error/limit and lse error against the plain version at
the fp32 limits (out 2e-5 |ref| + 2e-5 rms(row), lse 2e-5, as in
``chip_smoke.py``), whether its out and lse are bit-equal to the shipped
kernel's, and its device time (CUDA graph of 10 calls,
``chip_smoke.time_ms``): three readings with the variants in order, then
three in reverse order, so that no variant always runs first; the median
of the six, then each.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import sys

from theanompi_torch.kernels import BUILD_DIR
from theanompi_torch.kernels.dkv_variants import build_variants

SOURCE = "flash_fwd.cu"
VARIANTS = {
    "shipped": [],
    "one_warp_a_row_group": [("static constexpr int WARPS_A_GROUP = 2;",
                              "static constexpr int WARPS_A_GROUP = 1;")],
    "chained_acc": [("static constexpr bool FRESH_TILE = true;",
                     "static constexpr bool FRESH_TILE = false;")],
    "split_per_load": [("static constexpr bool Q_SPLIT_ONCE = true;",
                        "static constexpr bool Q_SPLIT_ONCE = false;")],
    "exp2f": [("ex2_ftz(fmaf(s[j][e], hopper::LOG2E, -ms[hh]))",
               "exp2f(fmaf(s[j][e], hopper::LOG2E, -ms[hh]))")],
    "expf": [("static constexpr bool EXP2 = true;",
              "static constexpr bool EXP2 = false;")],
}
#: (B, T, H, D, causal): the training shape first; T=8192 for the error's
#: growth with the length of the sums over keys
SHAPES = [(16, 2048, 8, 64, True), (1, 2048, 8, 64, True),
          (16, 2048, 8, 32, True), (16, 2048, 8, 128, True),
          (1, 8192, 8, 64, True), (1, 8192, 8, 128, True)]
#: the fp32 limits of kernel 1 (chip_smoke.check_flash)
REL, ROW, LSE_TOL = 2e-5, 2e-5, 2e-5


def main() -> int:
    import torch
    import torch.nn.functional as F

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, here)
    from chip_smoke import time_ms, within
    from theanompi_torch.ops.flash_attention import flash_attention_ref

    if not torch.cuda.is_available():
        print("fwd32_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants(VARIANTS, "fwd_tf32x3",
                          os.path.join(BUILD_DIR, "fwd32_variants"), SOURCE)
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(lib).flash_fwd
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(4)
    for b, t, h, d, causal in SHAPES:
        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=gen)
                   for _ in range(3))
        r_out, r_lse = flash_attention_ref(q, k, v, causal)
        shape = (f"fwd fp32 B={b} T={t} H={h} D={d} "
                 f"{'causal' if causal else 'full'}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = [time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 10, graph=True) for _ in range(3)]
        print(f"{shape} sdpa: ms " + " ".join(f"{m:.4f}" for m in sdpa),
              flush=True)
        calls, notes, first = {}, {}, None
        for name, fn in fns.items():
            out = torch.empty_like(q)
            lse = torch.empty(b, h, t, device="cuda")

            def call(fn=fn, out=out, lse=lse, name=name):
                rc = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), b, t, h, d,
                        int(causal), float(d ** -0.5),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            ratio = within(out, r_out, REL, ROW)[1]
            lse_err = float((lse - r_lse).abs().max())
            if first is None:
                first = (out.clone(), lse.clone())
            same = torch.equal(out, first[0]) and torch.equal(lse, first[1])
            calls[name] = call
            notes[name] = (f"out error/limit {ratio:.3g} |lse-ref| "
                           f"{lse_err:.3g} (limit {LSE_TOL:g}) bit-equal to "
                           f"shipped: {same}")
        ms = {name: [] for name in calls}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                ms[name] += [time_ms(calls[name], 10, graph=True)
                             for _ in range(3)]
        for name in calls:
            print(f"{shape} {name}: ms {statistics.median(ms[name]):.4f} ("
                  + " ".join(f"{m:.4f}" for m in ms[name])
                  + f") {notes[name]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
