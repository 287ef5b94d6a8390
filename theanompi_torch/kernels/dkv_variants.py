"""Time the bf16 ``flash_bwd_dkv`` kernel (kernel 3) against variants of
its own design, on the card::

    python -m theanompi_torch.kernels.dkv_variants

Each variant is the shipped ``csrc/flash_bwd.cu`` with one design choice
undone by a text substitution, built with ``nvcc`` beside the kernels'
libraries (``_build/dkv_variants/``, every build at once):

- ``shipped``: no producer warp (thread 0 of the warpgroup issues the TMA
  loads), a two-stage ring, the scale folded into fp32 where the rounded
  scale is a power of two (D=64);
- ``no_fold``: every q tile scaled in place in shared memory;
- ``stages3``: a three-stage ring;
- ``producer_warp``: a fifth warp issues the loads (the forward's and dq's
  layout), two CTAs an SM asked of ptxas;
- ``producer_warp_1cta``: the same, one CTA an SM asked.

Prints each variant's ``ptxas`` registers and spills per head dim (and its
wgmma serialization notes), then, per shape, each variant's device time
(CUDA graph of 10 calls, ``chip_smoke.time_ms``, three readings) and
whether its dk and dv are bit-equal to the shipped kernel's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

from theanompi_torch.kernels import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc

_REFILL = """    // thread 0: the slot stage it - 1 frees takes stage it + STAGES - 1
    const int ahead = it + P::STAGES - 1;
    if (tid == 0 && it > 0 && ahead < n_qt)
      pipe.load_stage(ahead, rows, vecs, h, b, qt0 * 64);
"""
_START = """  if (tid == 0) {
    pipe.load_fixed({&km, &vm}, k0, h, b);
    for (int i = 0; i < min(P::STAGES, n_qt); ++i)
      pipe.load_stage(i, rows, vecs, h, b, qt0 * 64);
  }
"""
_PRODUCER = """  if (tid / 32 == P::PRODUCER) {
    if (lane == 0)
      pipe.produce({&km, &vm}, k0, rows, vecs, h, b, qt0 * 64, n_qt);
    return;
  }
"""


def _producer(ctas):
    return [(_START, _PRODUCER), (_REFILL, ""),
            ("constexpr int DKV_THREADS = 128;",
             "constexpr int DKV_THREADS = 160;"),
            ("__launch_bounds__(DKV_THREADS, 2)",
             f"__launch_bounds__(DKV_THREADS, {ctas})")]


VARIANTS = {
    "shipped": [],
    "no_fold": [("const bool fold = (__float_as_uint(qscale) & 0x7FFFFFu) "
                 "== 0;", "const bool fold = false;")],
    "stages3": [("static constexpr int STAGES = 2;",
                 "static constexpr int STAGES = 3;")],
    "producer_warp": _producer(2),
    "producer_warp_1cta": _producer(1),
}
#: (B, T, H, D, causal): the training shape first
SHAPES = [(16, 2048, 8, 64, True), (1, 2048, 8, 64, True),
          (16, 2048, 8, 32, True), (16, 2048, 8, 128, True)]


def variant_sources(name, subs, source="flash_bwd.cu"):
    """``source`` (a ``csrc/*.cu`` file) and the ``csrc/*.cuh`` headers
    with each (old, new) substitution of ``subs`` made; -> {file name:
    text}.  Raises SystemExit unless each old text is found exactly once
    in them all."""
    names = [source] + sorted(f for f in os.listdir(CSRC)
                              if f.endswith(".cuh"))
    files = {f: open(os.path.join(CSRC, f)).read() for f in names}
    for old, new in subs:
        hits = [f for f in files for _ in range(files[f].count(old))]
        if len(hits) != 1:
            raise SystemExit(f"{name}: {old[:50]!r} found {len(hits)} "
                             f"times, not once")
        files[hits[0]] = files[hits[0]].replace(old, new)
    return files


def build_variants(variants, tag, out_dir, source="flash_bwd.cu"):
    """Write and compile every variant of ``source`` (see
    ``variant_sources``) at once; -> {name: library path}, printing the
    ptxas registers and spills (and wgmma serialization notes) of each
    function whose name holds ``tag``."""
    procs = {}
    for name, subs in variants.items():
        files = variant_sources(name, subs, source)
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for f, text in files.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        lib = os.path.join(d, f"lib{os.path.splitext(source)[0]}.so")
        procs[name] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", lib, os.path.join(d, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Function properties" in line and tag in line:
                # a flash kernel's head dim, else the mangled template
                # arguments after the tag
                args = ("D=" + line.split("ILi")[1].split("E")[0]
                        if "ILi" in line else
                        line.split(tag, 1)[1].split("EEEv")[0])
                print(f"ptxas {name} {args}: "
                      f"{lines[i + 2].split(':')[-1]}; "
                      f"{lines[i + 1].strip()}", flush=True)
        for line in lines:
            if "serialized" in line and tag in line:
                d = line.split("ILi")[1].split("E")[0]
                print(f"ptxas {name} D={d}: wgmma serialized "
                      f"({line.split(':')[2].split('for the')[0].strip()})",
                      flush=True)
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, here)
    from chip_smoke import time_ms
    from theanompi_torch.ops.flash_attention import _delta, flash_attention

    if not torch.cuda.is_available():
        print("dkv_variants: no CUDA device", file=sys.stderr)
        return 2
    fns = {}
    for name, lib in build_variants(
            VARIANTS, "dkv_wgmma",
            os.path.join(BUILD_DIR, "dkv_variants")).items():
        fn = ctypes.CDLL(lib).flash_bwd_dkv
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(4)
    for b, t, h, d, causal in SHAPES:
        q, k, v, g = (torch.randn(b, t, h, d, device="cuda", generator=gen)
                      .bfloat16() for _ in range(4))
        out, lse = flash_attention(q, k, v, causal)
        delta = _delta(out, g)
        first = None
        for name, fn in fns.items():
            dk, dv = torch.empty_like(q), torch.empty_like(q)

            def call():
                rc = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), b, t, h, d,
                        int(causal), float(d ** -0.5),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            if first is None:
                first = (dk.clone(), dv.clone())
            same = torch.equal(dk, first[0]) and torch.equal(dv, first[1])
            ms = [time_ms(call, 10, graph=True) for _ in range(3)]
            print(f"dkv B={b} T={t} H={h} D={d} "
                  f"{'causal' if causal else 'full'} {name}: ms "
                  + " ".join(f"{m:.4f}" for m in ms)
                  + f" bit-equal to shipped: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
