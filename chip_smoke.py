#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``theanompi_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. **Device and build** — the card's name, power limit (``nvidia-smi``),
   compute capability (must be 9.0), torch and CUDA versions; the three
   CUDA kernels build from ``theanompi_torch/kernels/csrc`` with ``nvcc``.
2. **Each kernel against its plain version on the card**, at the serving
   slice's shapes, with the tolerance stated per kernel; one line per
   kernel and shape with ``kernel_ms`` (device time, from a CUDA graph of
   the calls), ``call_ms`` (the same call eagerly, the wrapper's host cost
   included), ``ref_ms`` (the plain version) and ``library_ms`` (one
   PyTorch call computing the same function, timed here only: SDPA for
   flash attention, dequantize + matmul for the int8 matmul, none for
   paged decode).
3. **The serving path at full width**, through the CLI's ``serve`` (what
   ``python -m theanompi_torch.serving`` runs) — ``TransformerLM`` dim
   512, 8 heads, 8 layers, seq_len 2048, vocab 32768, max_batch 8,
   block_size 16, seeded random weights — serves 16 greedy requests
   (prompts of 100-800 tokens, so prefill buckets 128-1024 all run, 32 new
   tokens each) in bf16 and fp32, each with int8 weights off and on.
   Every request must end ``done``; each kernel on the path must have
   launched (counts are zeroed right before the run and read right
   after); the first-token logits must agree with the plain path
   (``attn_impl="blockwise"``, ``decode_kernel="off"``, same weights) and
   the plain path, re-scoring the kernel path's own streams
   teacher-forced, must pick the same greedy token at >= 99 % (fp32) /
   >= 95 % (bf16) of positions.

Output: the ``nvidia-smi`` line, one line per check, the serve reports,
then ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
fp32 products run without TF32 throughout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SERVE_CFG = {"dim": 512, "heads": 8, "n_layers": 8, "seq_len": 2048,
             "vocab": 32768, "dropout": 0.0}
#: 16 greedy requests in two 8-turn sessions: prompts of 100, 200, ...,
#: 800 tokens, so the prefill buckets 128, 256, 512 and 1024 all run
SERVE_ARGS = ["--requests", "16", "--prompt-len", "100", "--turns", "8",
              "--max-new-tokens", "32", "--max-batch", "8",
              "--block-size", "16", "--seed", "0"]
AGREE_MIN = {"float32": 0.99, "bfloat16": 0.95}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters=20, graph=False):
    """Mean time of one call of ``fn``: CUDA events around ``iters``
    back-to-back calls, after two warm-up calls.  Eagerly, a call's host
    cost (the wrapper's checks, allocation and launch) is part of the time
    wherever it exceeds the device's.  ``graph=True`` captures the calls
    into a CUDA graph and times its replay: the device time of the
    launches alone."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(iters):
                fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, flops, dtype):
    """Least time on the card: max(bytes / memory rate, flops / peak of
    the operand type); -> (ms, "bytes" | "operations")."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def within(out, ref, rel, row):
    """Hold ``out`` to ``ref`` element by element: ``|out - ref| <= rel *
    |ref| + row * rms(ref's row)``, a row being one vector of the last
    axis (one query's head, one output row).  -> (max |out - ref|, the
    largest ratio of an error to its limit; <= 1 passes)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    rms = r.pow(2).mean(dim=-1, keepdim=True).sqrt()
    limit = (rel * r.abs() + row * rms).clamp(min=1e-30)
    return float(err.max()), float((err / limit).max())


def _dname(dtype):
    return str(dtype).replace("torch.", "")


# -- phase 2: kernels against their plain versions ------------------------------

def check_flash(torch):
    import torch.nn.functional as F

    from theanompi_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(b, t) for b in (1, 8)
             for t in (16, 128, 256, 512, 1024, 2048)]
    # out, element by element (see within): fp32 sums run in another order
    # than the plain version's (rel = row = 2e-5); a bf16 output may round
    # one ulp apart (rel 2**-7), and a probability on a bf16 rounding edge
    # may round either way, moving its row by up to 2**-8 of that key's
    # weight (row 2**-5).  lse: fp32 2e-5, bf16 4e-3 (such a flip moves the
    # row normalizer by <= 2**-8)
    for dtype, (rel, row, lse_tol) in (
            (torch.bfloat16, (2 ** -7, 2 ** -5, 4e-3)),
            (torch.float32, (2e-5, 2e-5, 2e-5))):
        for b, t in cases:
            h, d = 8, 64
            q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
            out, lse = flash_attention(q, k, v, causal=True)
            r_out, r_lse = flash_attention_ref(q, k, v, causal=True)
            torch.cuda.synchronize()
            err, ratio = within(out, r_out, rel, row)
            lse_err = float((lse - r_lse).abs().max())
            check(torch.isfinite(out.float()).all().item(),
                  f"flash {dtype} B={b} T={t}: non-finite output")
            check(ratio <= 1 and lse_err <= lse_tol,
                  f"flash {dtype} B={b} T={t}: |out-ref|={err:.3g}, "
                  f"worst error/limit {ratio:.3g} (limit {rel:.3g}|ref| + "
                  f"{row:.3g} rms(row)), |lse-ref|={lse_err:.3g} "
                  f"(tol {lse_tol})")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            def kernel():
                return flash_attention(q, k, v, causal=True)

            ms, call_ms = time_ms(kernel, graph=True), time_ms(kernel)
            ref_ms = time_ms(lambda: flash_attention_ref(q, k, v, True), 5)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), graph=True)
            elt = q.element_size()
            n_bytes = 4 * b * t * h * d * elt + b * h * t * 4
            flops = 4 * b * h * d * t * (t + 1) // 2
            bms, by = bound_ms(n_bytes, flops, _dname(dtype))
            rows.append(dict(dtype=_dname(dtype), shape=f"B={b} T={t} H={h} "
                             f"D={d} causal", max_abs_err=max(err, lse_err),
                             ratio=ratio,
                             tol=f"{rel:.3g}|ref|+{row:.3g}rms+lse{lse_tol}",
                             ms=ms, call_ms=call_ms,
                             plain_ms=ref_ms,
                             library_ms=lib_ms, bound_ms=bms, bound_by=by))
    return rows


def paged_case(torch, dtype, gen):
    """B=8, H=8, Dh=64, bs=16, 1025 blocks: ragged positions (0 = an
    inactive slot on the null block, up to 2047), null tails, and two
    slots sharing their leading blocks."""
    b, h, d, bs, n_blocks, nb = 8, 8, 64, 16, 1025, 128
    positions = [0, 2047, 5, 100, 511, 1000, 1500, 37]
    tables = torch.zeros((b, nb), dtype=torch.int32)
    nxt = 1
    for s, p in enumerate(positions):
        if s == 0:
            continue  # inactive: all-null table
        need = p // bs + 1
        tables[s, :need] = torch.arange(nxt, nxt + need, dtype=torch.int32)
        nxt += need
    tables[3, :2] = tables[4, :2]  # a shared prefix of two blocks
    kp = torch.randn(n_blocks, bs, h, d, device="cuda", generator=gen)
    vp = torch.randn(n_blocks, bs, h, d, device="cuda", generator=gen)
    q = torch.randn(b, h, d, device="cuda", generator=gen)
    return (kp.to(dtype), vp.to(dtype), tables.cuda(), bs, q.to(dtype),
            torch.tensor(positions, dtype=torch.int32, device="cuda"))


def check_paged(torch):
    from theanompi_torch.ops.paged_attention import (
        paged_attend_decode,
        paged_attend_decode_ref,
    )

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    # element by element (see within): fp32 sums in another order (rel =
    # row = 1e-5); bf16 outputs rounded once from nearly equal fp32 values
    # (one ulp, at most 2**-7 relative; row 1e-4 for fp32 order effects)
    for dtype, rel, row in ((torch.bfloat16, 2 ** -7, 1e-4),
                            (torch.float32, 1e-5, 1e-5)):
        args = paged_case(torch, dtype, gen)
        out = paged_attend_decode(*args)
        ref = paged_attend_decode_ref(*args)
        torch.cuda.synchronize()
        err, ratio = within(out, ref, rel, row)
        check(torch.isfinite(out.float()).all().item(),
              f"paged {dtype}: non-finite output (inactive slot?)")
        check(ratio <= 1, f"paged {dtype}: |out-ref|={err:.3g}, worst "
              f"error/limit {ratio:.3g} (limit {rel:.3g}|ref| + {row:.3g} "
              f"rms(row))")
        ms = time_ms(lambda: paged_attend_decode(*args), 50, graph=True)
        call_ms = time_ms(lambda: paged_attend_decode(*args), 50)
        ref_ms = time_ms(lambda: paged_attend_decode_ref(*args), 5)
        kp, _, tables, bs, q, positions = args
        b, h, d = q.shape
        ctx = int((positions.long() + 1).sum())
        used = int((positions.long() // bs + 1).sum())
        n_bytes = (2 * ctx * h * d * kp.element_size()
                   + 2 * q.numel() * q.element_size() + 4 * used + 4 * b)
        bms, by = bound_ms(n_bytes, 4 * ctx * h * d, _dname(dtype))
        rows.append(dict(dtype=_dname(dtype), shape=f"B={b} H={h} Dh={d} "
                         f"bs={bs} blocks=1025 positions="
                         f"{positions.tolist()}", max_abs_err=err,
                         ratio=ratio, tol=f"{rel:.3g}|ref|+{row:.3g}rms",
                         ms=ms, call_ms=call_ms, plain_ms=ref_ms,
                         library_ms=None,
                         bound_ms=bms, bound_by=by))
    return rows


def check_int8(torch):
    from theanompi_torch.ops.quant import (
        QuantizedTensor,
        int8_matmul,
        int8_matmul_ref,
        quantize_chunked,
    )

    rows = []
    gen = torch.Generator().manual_seed(3)
    shapes = [(512, 512), (512, 2048), (2048, 512), (512, 32768)]
    for din, dout in shapes:
        w = (torch.randn(din, dout, generator=gen) * 0.02).cuda()
        q, s = quantize_chunked(w, gen, 1024)
        qt = QuantizedTensor(q, s, (din, dout), torch.float32)
        # element by element (see within): fp32 sums over K in another
        # order (rel = row = 1e-5); a bf16 output may round one ulp apart
        # (2**-7 relative; row 1e-4 for the fp32 order effects)
        for dtype, rel, row in ((torch.bfloat16, 2 ** -7, 1e-4),
                                (torch.float32, 1e-5, 1e-5)):
            for m in (1, 8):
                x = torch.randn(m, din, generator=gen).cuda().to(dtype)
                out = int8_matmul(x, qt)
                ref = int8_matmul_ref(x, qt)
                torch.cuda.synchronize()
                err, ratio = within(out, ref, rel, row)
                check(ratio <= 1,
                      f"int8 {dtype} M={m} [{din},{dout}]: |out-ref|="
                      f"{err:.3g}, worst error/limit {ratio:.3g} (limit "
                      f"{rel:.3g}|ref| + {row:.3g} rms(row))")
                ms = time_ms(lambda: int8_matmul(x, qt), 50, graph=True)
                call_ms = time_ms(lambda: int8_matmul(x, qt), 50)
                ref_ms = time_ms(lambda: int8_matmul_ref(x, qt), 50)
                lib_ms = time_ms(lambda: torch.matmul(
                    x, qt.dequantize().to(dtype)), 50, graph=True)
                bands = qt.layout()[2]
                elt = x.element_size()
                n_bytes = (m * din * elt + din * dout + 4 * bands * din
                           + m * dout * elt)
                bms, by = bound_ms(n_bytes, 2 * m * din * dout,
                                   _dname(dtype))
                rows.append(dict(dtype=_dname(dtype),
                                 shape=f"M={m} [{din},{dout}] chunk=1024",
                                 max_abs_err=err, ratio=ratio,
                                 tol=f"{rel:.3g}|ref|+{row:.3g}rms", ms=ms,
                                 call_ms=call_ms, plain_ms=ref_ms,
                                 library_ms=lib_ms,
                                 bound_ms=bms, bound_by=by))
    return rows


def print_rows(name, rows):
    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        print(f"check {name} {r['dtype']} {r['shape']}: "
              f"kernel_ms={r['ms']:.4f} call_ms={r['call_ms']:.4f} "
              f"ref_ms={r['plain_ms']:.4f} "
              f"library_ms={lib} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}) max_abs_err={r['max_abs_err']:.3g} "
              f"err/limit={r['ratio']:.3g} limit={r['tol']}", flush=True)


# -- phase 3: the serving path --------------------------------------------------

def teacher_forced(engine, done, n_new):
    """The plain engine re-scores the kernel path's streams: prompt
    prefill, then decode steps fed the kernel path's own tokens, all
    requests of a group in the fixed batch.  -> (agreeing positions,
    positions)."""
    import numpy as np

    from theanompi_torch.serving import BlockPool, blocks_for

    bsz, bs = engine.max_batch, engine.block_size
    agree = total = 0
    for g0 in range(0, len(done), bsz):
        group = done[g0:g0 + bsz]
        pool = BlockPool(engine.num_blocks)
        tables = np.zeros((bsz, engine.max_blocks_per_seq), np.int32)
        lengths = np.zeros(bsz, np.int32)
        tokens = np.zeros(bsz, np.int32)
        rids = np.zeros(bsz, np.int32)
        for slot, req in enumerate(group):
            row = pool.alloc(blocks_for(len(req.prompt) + n_new, bs))
            tok, _ = engine.prefill(row[:blocks_for(len(req.prompt), bs)],
                                    req.prompt, 0.0, req.rid)
            total += 1
            agree += int(tok == req.generated[0])
            tables[slot, :len(row)] = row
            lengths[slot] = len(req.prompt)
            tokens[slot] = req.generated[0]
            rids[slot] = req.rid
        for step in range(1, n_new):
            nxt, logits = engine.decode(tables, lengths, tokens,
                                        np.zeros(bsz, np.float32), rids)
            check(bool(logits.isfinite().all()), "plain decode: non-finite "
                  "logits")
            for slot, req in enumerate(group):
                total += 1
                agree += int(nxt[slot] == req.generated[step])
                tokens[slot] = req.generated[step]
                lengths[slot] += 1
    return agree, total


def first_token_logits(kernel_engine, plain_engine, reqs):
    """Max |kernel - plain| over the first-token logits of every prompt,
    and max |plain|."""
    from theanompi_torch.serving import BlockPool, blocks_for

    err = scale = 0.0
    for req in reqs:
        row = BlockPool(kernel_engine.num_blocks).alloc(
            blocks_for(len(req.prompt), kernel_engine.block_size))
        _, k_last = kernel_engine.prefill(row, req.prompt, 0.0, req.rid)
        _, p_last = plain_engine.prefill(row, req.prompt, 0.0, req.rid)
        check(bool(k_last.isfinite().all()), "prefill: non-finite logits")
        err = max(err, float((k_last - p_last).abs().max()))
        scale = max(scale, float(p_last.abs().max()))
    return err, scale


def _same_weights(a, b):
    """Both engines hold the same (possibly int8) weights."""
    import torch

    from theanompi_torch.ops.quant import QuantizedTensor
    from theanompi_torch.tree import tree_leaves_with_path

    for (_, x), (_, y) in zip(tree_leaves_with_path(a),
                              tree_leaves_with_path(b)):
        if isinstance(x, QuantizedTensor):
            x, y = x.q, y.q
        if not torch.equal(x, y):
            return False
    return True


def serve_run(torch, precision, quant, smi, kernels):
    """One full-width run of the CLI's ``serve`` (the ``python -m
    theanompi_torch.serving`` entry point), with every kernel's launch
    count zeroed just before it and read just after; then the parity of
    the same weights against the plain path.  -> (launches, report)."""
    from theanompi_torch.models.transformer_lm import TransformerLM
    from theanompi_torch.serving import InferenceEngine
    from theanompi_torch.serving.cli import build_parser, serve

    tag = f"{precision}{'+int8' if quant else ''}"
    cfg = {**SERVE_CFG, "precision": precision}
    argv = [a for k, v in cfg.items() for a in ("--set", f"{k}={v!r}")]
    argv += SERVE_ARGS + (["--quantize-int8"] if quant else [])
    args = build_parser().parse_args(argv)
    done = {}
    for k in kernels:
        k.launches = 0
    report = serve(args, on_terminal=lambda r: done.__setitem__(r.rid, r))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    check(report["decode_kernel"] == "kernel", f"{tag}: decode kernel not "
          f"taken ({report['decode_kernel']})")
    check(len(done) == args.requests
          and all(r.state == "done" for r in done.values()),
          f"{tag}: not every request done: {report['terminal_states']}")
    need = ["flash_fwd", "paged_decode"] + (["int8_matmul"] if quant else [])
    for name in need:
        check(launches[name] > 0, f"{tag}: {name} never launched on the "
              f"serving path ({launches})")
    print(f"serve[{tag}] {smi}: tokens/s={report['value']} "
          f"ttft_ms={report['ttft_ms']} "
          f"decode_step_ms={report['decode_step_ms']} "
          f"launches={launches} "
          f"generated_tokens={report['generated_tokens']}", flush=True)
    print(f"serve_report[{tag}] {json.dumps(report)}", flush=True)

    # the CLI's weights again (its seeded init), through the kernel path
    # and through the plain one
    params = TransformerLM(cfg).init_params(
        torch.Generator().manual_seed(args.seed))
    geometry = dict(block_size=args.block_size, max_batch=args.max_batch,
                    quantize_int8=quant, seed=args.seed)
    kernel = InferenceEngine(TransformerLM(cfg), params, **geometry)
    plain = InferenceEngine(TransformerLM({**cfg, "attn_impl": "blockwise"}),
                            params, decode_kernel="off", **geometry)
    check(plain.decode_impl == "fallback", "plain engine took a kernel")
    check(_same_weights(kernel.params, plain.params),
          f"{tag}: the plain engine's weights differ")
    reqs = [done[i] for i in sorted(done)]
    err, scale = first_token_logits(kernel, plain, reqs)
    agree, total = teacher_forced(plain, reqs, args.max_new_tokens)
    rate = agree / total
    rel = 0.05 if precision == "bf16" else 1e-3
    tol = rel * scale
    print(f"parity[{tag}]: first-token logits max|kernel-plain|={err:.4g} "
          f"(tol {tol:.4g} = {rel:g} x max|plain| {scale:.4g}); "
          f"teacher-forced greedy agreement {agree}/{total} = {rate:.4f}",
          flush=True)
    check(err <= tol, f"{tag}: first-token logits differ by {err:.4g}")
    dname = "bfloat16" if precision == "bf16" else "float32"
    check(rate >= AGREE_MIN[dname], f"{tag}: greedy agreement {rate:.4f} "
          f"< {AGREE_MIN[dname]}")
    return launches, report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "theanompi_torch")):
        print("chip_smoke: run from a checkout (theanompi_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from theanompi_torch import kernels as K
    from theanompi_torch.ops import flash_attention as _f  # noqa: F401
    from theanompi_torch.ops import paged_attention as _p  # noqa: F401
    from theanompi_torch.ops import quant as _q  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1 -----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    print(f"device: {name} | power limit: {smi.split(',')[-1].strip()} | "
          f"capability {cap} | torch {torch.__version__} | cuda "
          f"{torch.version.cuda}", flush=True)
    check(cap == (9, 0), f"capability {cap} is not Hopper (9, 0)")
    t0 = time.perf_counter()
    K.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(K.KERNELS)} kernels", flush=True)
    for f in sorted(os.listdir(K.BUILD_DIR)):
        if f.endswith(".ptxas.txt"):
            with open(os.path.join(K.BUILD_DIR, f)) as fh:
                for line in fh:
                    if "registers" in line or "spill" in line:
                        print(f"ptxas {f}: {line.strip()}")

    # -- phase 2 -----------------------------------------------------------
    checks = {"flash_fwd": check_flash(torch),
              "paged_decode": check_paged(torch),
              "int8_matmul": check_int8(torch)}
    for k, rows in checks.items():
        print_rows(k, rows)

    # -- phase 3 -----------------------------------------------------------
    runs = {}
    for precision in ("bf16", "fp32"):
        for quant in (False, True):
            runs[(precision, quant)] = serve_run(torch, precision, quant,
                                                 smi, K.KERNELS)
    # each kernel's launches from the run of the path that takes it
    main_launches = {"flash_fwd": runs[("bf16", False)][0]["flash_fwd"],
                     "paged_decode": runs[("bf16", False)][0]["paged_decode"],
                     "int8_matmul": runs[("bf16", True)][0]["int8_matmul"]}
    served = runs[("bf16", False)][1]["generated_tokens"]
    print(f"launches per served token (bf16, {served} tokens): "
          + ", ".join(f"{k}={v / served:.3f}"
                      for k, v in main_launches.items()), flush=True)

    # one representative main-path shape per kernel for the summary line
    rep = {"flash_fwd": ("bfloat16", "B=1 T=1024"),
           "paged_decode": ("bfloat16", "B=8"),
           "int8_matmul": ("bfloat16", "M=8 [512,32768]")}
    summary = []
    for k in K.KERNELS:
        dt, key = rep[k.name]
        row = next(r for r in checks[k.name]
                   if r["dtype"] == dt and r["shape"].startswith(key))
        summary.append({
            "name": k.name, "route": "cuda",
            "source": f"theanompi_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces, "launches": main_launches[k.name],
            "shape": f"{dt} {row['shape']}",
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "call_ms": row["call_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
