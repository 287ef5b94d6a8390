"""Time the fp32 ``flash_bwd_dkv`` kernel (kernel 3's three-pass TF32 path)
against variants of its own design, on the card::

    python -m theanompi_torch.kernels.dkv32_variants

Each variant is the shipped ``csrc/flash_bwd.cu`` (with ``csrc/tf32x3.cuh``)
with one design choice undone by a text substitution, built with ``nvcc``
beside the kernels' libraries (``_build/dkv32_variants/``, every build at
once; the machinery is ``dkv_variants``'s):

- ``shipped``: eight warps, two to a 16-key row group, each taking 32
  queries of every q tile, two CTAs an SM asked of ptxas below D=128;
- ``four_warps``: four warps, each taking all 64 queries of a tile for its
  16 keys (half the warps in the same shared memory, no final sum);
- ``eight_warps_1cta``: the shipped split with one CTA an SM asked of
  ptxas at every head dim (up to 255 registers a thread);
- ``tf32_last_tile``: the last causal diagonal tile's dPᵀ in three TF32
  passes like every other tile's, not in FFMA;
- ``rn_accumulate``: each 8-deep step of dV and dK formed from zero and
  added to the accumulator in fp32 (rounded to nearest), where the shipped
  kernel lets the mma add into it (each mma rounds its sum toward zero).

Prints each variant's ``ptxas`` registers and spills per head dim, then,
per shape, each variant's device time (CUDA graph of 10 calls,
``chip_smoke.time_ms``, three readings), the worst error/limit of its dk
and of its dv against the plain version at the fp32 limit (1e-4 |ref| +
1e-4 rms(row), as in ``chip_smoke.py``) with the key where it lies, and
whether its dk and dv are bit-equal to the shipped kernel's.
"""

from __future__ import annotations

import ctypes
import os
import sys

from theanompi_torch.kernels import BUILD_DIR
from theanompi_torch.kernels.dkv_variants import build_variants

VARIANTS = {
    "shipped": [],
    "four_warps": [("static constexpr int WARPS_A_GROUP = 2;",
                    "static constexpr int WARPS_A_GROUP = 1;")],
    "eight_warps_1cta": [
        ("static constexpr int MIN_BLOCKS = D < 128 ? 2 : 1;",
         "static constexpr int MIN_BLOCKS = 1;")],
    "tf32_last_tile": [("const bool exact = diag && k0 + 64 >= T_len;",
                        "const bool exact = false;")],
    "rn_accumulate": [
        ("        mma3(dva[n], ph, pl, bh, bl);",
         "        { float t[4] = {};\n          mma3(t, ph, pl, bh, bl);\n"
         "          for (int e = 0; e < 4; ++e) dva[n][e] += t[e]; }"),
        ("        mma3(dka[n], dh, dlo, bh, bl);",
         "        { float t[4] = {};\n          mma3(t, dh, dlo, bh, bl);\n"
         "          for (int e = 0; e < 4; ++e) dka[n][e] += t[e]; }")],
}
#: (B, T, H, D, causal): the training shape first; T=8192 for the error's
#: growth with the length of the sums over queries
SHAPES = [(16, 2048, 8, 64, True), (1, 2048, 8, 64, True),
          (16, 2048, 8, 32, True), (16, 2048, 8, 128, True),
          (2, 1040, 8, 64, False), (1, 8192, 8, 64, True),
          (1, 8192, 8, 128, True)]


def _worst(x, ref, rel, row):
    """The largest error/limit of ``x`` against ``ref`` (``[B, T, H, D]``),
    as ``chip_smoke.within`` holds it, and the key (position in T) where it
    lies."""
    rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    ratio = (x - ref).abs() / (rel * ref.abs() + row * rms).clamp(min=1e-30)
    i = int(ratio.argmax())
    _, t, h, d = ref.shape
    return float(ratio.flatten()[i]), i // (h * d) % t


def main() -> int:
    import torch

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, here)
    from chip_smoke import BWD_TOL, time_ms
    from theanompi_torch.ops.flash_attention import (
        _delta,
        flash_attention,
        flash_attention_bwd_ref,
    )

    if not torch.cuda.is_available():
        print("dkv32_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants(VARIANTS, "dkv_tf32x3",
                          os.path.join(BUILD_DIR, "dkv32_variants"))
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(lib).flash_bwd_dkv
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(4)
    for b, t, h, d, causal in SHAPES:
        q, k, v, g = (torch.randn(b, t, h, d, device="cuda", generator=gen)
                      for _ in range(4))
        out, lse = flash_attention(q, k, v, causal)
        delta = _delta(out, g)
        ref = flash_attention_bwd_ref(q, k, v, out, lse, g, causal)[1:]
        first = None
        for name, fn in fns.items():
            dk, dv = torch.empty_like(q), torch.empty_like(q)

            def call():
                rc = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), b, t, h, d,
                        int(causal), float(d ** -0.5),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            worst = [_worst(x, r, *BWD_TOL["float32"])
                     for x, r in zip((dk, dv), ref)]
            if first is None:
                first = (dk.clone(), dv.clone())
            same = torch.equal(dk, first[0]) and torch.equal(dv, first[1])
            ms = [time_ms(call, 10, graph=True) for _ in range(3)]
            print(f"dkv fp32 B={b} T={t} H={h} D={d} "
                  f"{'causal' if causal else 'full'} {name}: ms "
                  + " ".join(f"{m:.4f}" for m in ms)
                  + "".join(f" {n} error/limit {w:.3g} (key {key})"
                            for n, (w, key) in zip(("dk", "dv"), worst))
                  + f" bit-equal to shipped: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
