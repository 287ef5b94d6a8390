"""Time the decode step's kernels (5: int8 matmul, 4: paged decode)
against variants of their own design, on the card::

    python -m theanompi_torch.kernels.decode_variants

Each variant is the shipped ``csrc/int8_matmul.cu`` or
``csrc/paged_decode.cu`` with one design choice undone by a text
substitution, built with ``nvcc`` beside the kernels' libraries
(``_build/decode_variants/``, every build at once):

- int8 ``shipped``: bf16 on the tensor cores (``mma.m16n8k16`` from the
  fragment-ordered payload), fp32 on the CUDA cores in 128-thread CTAs
  (two or more an SM); K split over a thread block cluster where the
  column tiles leave the card mostly empty;
- int8 ``cta256``: 256-thread CUDA-core CTAs (one an SM at M=8);
- int8 ``no_cluster``: no K split across CTAs;
- int8 ``no_tc``: bf16 on the CUDA cores too;
- paged ``shipped``: sixteen rounds of K and V loads a split (256 tokens
  in bf16 at head dim 64);
- paged ``rounds4`` / ``rounds8``: four or eight rounds (a quarter or half
  the split, four or two times the CTAs).

Prints each variant's ``ptxas`` registers and spills, then, per shape of
``chip_smoke.py``'s decode rows, each variant's device time (CUDA graph of
20 calls, ``chip_smoke.time_ms``): three readings with the variants in
order, then three in reverse order; the median of the six, then each.
Beside it the worst error/limit against the plain version (the smoke's
limits) and whether the output is bit-equal to the shipped kernel's.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import sys

from theanompi_torch.kernels import BUILD_DIR
from theanompi_torch.kernels.dkv_variants import build_variants

INT8_VARIANTS = {
    "shipped": [],
    "cta256": [("constexpr int THREADS = 128;",
                "constexpr int THREADS = 256;")],
    "no_cluster": [("constexpr int MAX_SPLITS = 8;",
                    "constexpr int MAX_SPLITS = 1;")],
    "no_tc": [("constexpr bool TC = true;", "constexpr bool TC = false;")],
}
PAGED_VARIANTS = {
    "shipped": [],
    "rounds4": [("constexpr int ROUNDS = 16;", "constexpr int ROUNDS = 4;")],
    "rounds8": [("constexpr int ROUNDS = 16;", "constexpr int ROUNDS = 8;")],
}
#: the decode step's weights at M = 8, 3, 2 and 1
INT8_SHAPES = [(m, din, dout) for m in (8, 3, 2, 1)
               for din, dout in ((512, 512), (512, 2048), (2048, 512),
                                 (512, 32768))]


def _fn(lib, symbol, sig):
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes = [{"p": ctypes.c_void_p, "i": ctypes.c_int,
                    "f": ctypes.c_float}[c] for c in sig]
    fn.restype = ctypes.c_int
    return fn


def _race(torch, calls, time_ms):
    """{name: the six readings}, three with ``calls`` in order then three
    in reverse order."""
    ms = {name: [] for name in calls}
    for order in (list(calls), list(reversed(calls))):
        for _ in range(3):
            for name in order:
                ms[name].append(time_ms(calls[name], 20, graph=True))
    return ms


def _report(label, ms, errs, same):
    for name, readings in ms.items():
        print(f"{label} {name}: median ms {statistics.median(readings):.4f}"
              f" (" + " ".join(f"{m:.4f}" for m in readings) + f") "
              f"err/limit {errs[name]:.3g} bit-equal to shipped: "
              f"{same[name]}", flush=True)


def main() -> int:
    import torch

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, here)
    from chip_smoke import PAGED_POSITIONS, paged_case, time_ms, within
    from theanompi_torch.ops.paged_attention import paged_attend_decode_ref
    from theanompi_torch.ops.quant import (
        QuantizedTensor,
        int8_matmul_ref,
        quantize_chunked,
    )

    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device", file=sys.stderr)
        return 2
    out_dir = os.path.join(BUILD_DIR, "decode_variants")
    int8_libs = build_variants(INT8_VARIANTS, "int8_mm",
                               os.path.join(out_dir, "int8"),
                               "int8_matmul.cu")
    paged_libs = build_variants(PAGED_VARIANTS, "paged_split",
                                os.path.join(out_dir, "paged"),
                                "paged_decode.cu")
    tols = {torch.bfloat16: (2 ** -7, 1e-4), torch.float32: (1e-5, 1e-5)}

    gen = torch.Generator().manual_seed(3)
    int8_fns = {n: _fn(lib, "int8_matmul", "ipppppiiiip")
                for n, lib in int8_libs.items()}
    for dtype in (torch.bfloat16, torch.float32):
        for m, din, dout in INT8_SHAPES:
            w = (torch.randn(din, dout, generator=gen) * 0.02).cuda()
            q, s = quantize_chunked(w, gen, 1024)
            qt = QuantizedTensor(q, s, (din, dout), torch.float32)
            q2d, scales, bands = qt.layout()
            packed = qt.tc_packed() if dtype == torch.bfloat16 else None
            x = torch.randn(m, din, generator=gen).cuda().to(dtype)
            ref = int8_matmul_ref(x, qt)
            calls, outs, errs, same = {}, {}, {}, {}
            for name, fn in int8_fns.items():
                out = torch.empty((m, dout), dtype=dtype, device="cuda")

                def call(fn=fn, out=out, name=name):
                    rc = fn(0 if dtype == torch.float32 else 1,
                            x.data_ptr(), q2d.data_ptr(),
                            0 if packed is None else packed.data_ptr(),
                            scales.data_ptr(), out.data_ptr(), m, din, dout,
                            dout // bands,
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                calls[name], outs[name] = call, out.clone()
                errs[name] = within(out, ref, *tols[dtype])[1]
                same[name] = torch.equal(out, outs["shipped"])
            _report(f"int8 {str(dtype)[6:]} M={m} [{din},{dout}]",
                    _race(torch, calls, time_ms), errs, same)

    gen = torch.Generator(device="cuda").manual_seed(2)
    paged_fns = {n: (_fn(lib, "paged_decode", "ipppppppiiiiifp"),
                     _fn(lib, "paged_decode_split_tokens", "iii"))
                 for n, lib in paged_libs.items()}
    for dtype in (torch.bfloat16, torch.float32):
        for case, positions in PAGED_POSITIONS.items():
            kp, vp, tables, bs, qq, pos = paged_case(torch, dtype, gen,
                                                     positions)
            b, h, d = qq.shape
            nb = tables.shape[1]
            ref = paged_attend_decode_ref(kp, vp, tables, bs, qq, pos)
            calls, outs, errs, same = {}, {}, {}, {}
            for name, (fn, tokens) in paged_fns.items():
                dt = 0 if dtype == torch.float32 else 1
                splits = -(-nb * bs // tokens(dt, d, bs))
                ws = torch.empty(b * h * splits * (d + 2), device="cuda")
                out = torch.empty_like(qq)

                def call(fn=fn, out=out, ws=ws, name=name, dt=dt):
                    rc = fn(dt, kp.data_ptr(), vp.data_ptr(),
                            tables.data_ptr(), pos.data_ptr(), qq.data_ptr(),
                            out.data_ptr(), ws.data_ptr(), b, h, d, bs, nb,
                            float(d ** -0.5),
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                calls[name], outs[name] = call, out.clone()
                errs[name] = within(out, ref, *tols[dtype])[1]
                same[name] = torch.equal(out, outs["shipped"])
            _report(f"paged {str(dtype)[6:]} {case}",
                    _race(torch, calls, time_ms), errs, same)
    return 0


if __name__ == "__main__":
    sys.exit(main())
