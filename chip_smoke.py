#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``theanompi_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. **Device and build** — the card's name, power limit (``nvidia-smi``),
   compute capability (must be 9.0), torch and CUDA versions; the five
   CUDA kernels (four sources) build from ``theanompi_torch/kernels/csrc``
   with ``nvcc``, one process per source, all at once; ``ptxas``'s
   registers, spills and wgmma notes per kernel, and the number of
   ``HGMMA`` (wgmma) instructions in each library's SASS and in each
   function of it (``cuobjdump -sass``), which must not be 0 in any flash
   kernel's bf16 function; and the number of TF32 ``HMMA`` (``mma.sync``)
   instructions in each fp32 flash kernel's function, forward, dq and
   dk/dv (three TF32 passes a product on the tensor cores), which must not
   be 0 either, nor the ``HMMA`` count of the int8 matmul's bf16
   tensor-core kernel.
2. **Each kernel against its plain version on the card**, at the serving
   and training slices' shapes, with the tolerance stated per kernel; one
   line per kernel and shape with ``kernel_ms`` (device time, from a CUDA
   graph of the calls), the achieved TFLOP/s and share of the bound,
   ``call_ms`` (the same call eagerly, the wrapper's host cost included),
   ``ref_ms`` (the plain version) and ``library_ms`` (one PyTorch call
   computing the same function, timed here only: SDPA and its backward for
   flash attention, dequantize + matmul for the int8 matmul, none for
   paged decode).  Paged decode (kernel 4) runs the ragged decode batch,
   one slot at position 2047 and eight at 2047; it and the int8 matmul
   (kernel 5, the decode step's four weight shapes at M = 1 and 8) check
   that two calls are bit-equal and print their times before the decode
   step's redesign (``earlier``), and the two kernels' device time in one
   decode step of the served model is printed per dtype.  The
   training-shape rows of kernels 1-3 also print
   their times before the bf16 tensor-core redesign (``earlier``), for
   reference, and fp32 kernels 1-3 the time of the CUDA-core kernel their
   three-pass TF32 design replaced.  The flash forward (kernel 1) prints
   its worst error/limit per dtype, holds fp32 at B=1 T=8192 too, and
   checks that two fp32 calls at the training shape give bit-equal out
   and lse.  The flash backward (kernels 2 and 3) prints its worst
   error/limit per kernel and dtype, and checks that two fp32 calls give
   bit-equal dq, dk and dv; it has a second witness in fp32:
   ``FlashAttention``'s grads against autograd of the blockwise path.
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
4. **The training path at full width**, through ``BSP(...).init(...)``
   and ``.wait()`` (what ``python -m theanompi_torch.launcher`` runs) —
   the same model at batch 16, dropout 0, the synthetic PTB stream,
   1 epoch of 8 steps and 2 validation batches — in bf16 and fp32.  Each
   step's loss must be finite, and the first batch's loss after the last
   step below its loss at step 1; flash forward
   must have launched ``8 layers x (8 steps + 2 validation batches)``
   times and each backward kernel ``8 x 8`` (counts zeroed right before
   the run and read right after).  Then one step at batch 2 through the
   kernels and through the plain path (``attn_impl="blockwise"``, same
   weights, same batch): loss, global grad norm and the params' update
   must agree within the stated tolerance.  One further step of each run
   is traced with ``torch.profiler``: device busy time against the step's
   wall time, and the kernels that take most of it.
5. **The conv-net path at full width**, through ``BSP(...).init(...)``
   and ``.wait()`` with ``modelfile="theanompi_torch.models.resnet50"`` —
   ``bench.py:102-107``'s ResNet-50 (224², 1000 classes, stages (3, 4, 6,
   3), the conv7 stem, lr 0.1, Nesterov momentum, weight decay) at batch
   256 on the synthetic ImageNet shards, 8 steps and 1 validation batch,
   in bf16 and fp32 (fp32 at batch 128 if 256 does not fit).  Each step's
   loss must be finite, the first batch's loss (batch statistics) after
   the last step below its loss at step 1, every BN's running mean off
   zero, and none of the five kernels launched.  The batches come inline
   (``prefetch=0``; phase 7 runs the other feeds).  Printed: step ms p50
   (the recorder's ``calc``, which ends in a sync), images/s, the host
   data plane's ``wait`` p50 beside it, the analytic-FLOPs utilization
   estimate, peak memory, and one more step traced by ``torch.profiler``
   (busy against wall, the kernel groups, the BN forwards' and the
   optimizer's device time).  Then one fp32 step at batch 8 on the card
   and on the CPU from the fp32 run's weights, state and momentum: loss,
   global grad norm, new BN state and updated params must agree within
   the stated tolerance.

6. **Multi-rank BSP**, through ``BSP(...).init(devices=N)`` on every rank
   of a process group started by ``theanompi_torch.dist.spawn`` (the
   ranks run ``theanompi_torch.parallel.rank_jobs``).  With two or more
   cards, min(count, 4) ranks under NCCL, one card each, and every
   exchange strategy; with one card, two ranks share it over gloo, which
   carries the all-reduce strategies (``psum``, ``psum_bf16``,
   ``psum_bucket``, ``psum_bf16_bucket``), ``fused_pmean`` and sync-BN but
   no send/recv of CUDA tensors, so the ring strategies are not run (the
   phase says so); gloo carries ``zero1``'s ``reduce_scatter_tensor`` and
   ``all_gather_into_tensor`` of CUDA tensors, and a collective that
   fails fails the phase.  It prints the backend and the rank-to-card
   map.  The exchange of per-rank ragged trees under
   each strategy against the ranks' mean (bit-equal on every rank); then
   the transformer at phase 4's config, global batch 16 as N x 16/N, 4
   steps, and ResNet-50 at phase 5's config with sync-BN, global batch
   256 as N x 256/N (shards of 128, so a rank builds only the shards it
   trains on), 3 steps, each in bf16 and fp32 under ``psum_bucket``, held
   against one process at the same global batch from the same init and
   batches: the step-1 loss, the global norm of the exchanged grads, the
   params' update after step 1 and (ResNet-50) the BN running state after
   it, within the stated limits.  Then the exchange's other paths: the
   transformer in bf16 and fp32 under ``psum_bucket`` with
   ``exch_overlap``, ``zero1`` and ``zero1`` with ``exch_overlap``, and
   ResNet-50 in bf16 under ``zero1`` with ``exch_overlap`` (sync-BN's
   backward all-reduces interleaving with the hook-issued buckets).  An
   overlapped transformer run's params must be bit-equal after every step
   (a 64-bit checksum of their bits) to the same strategy's fused run on
   the same ranks, and every bucket's collective issued from backward,
   counted by name: under ``psum_bucket`` one all-reduce a bucket, under
   ``zero1`` one reduce-scatter and one all-gather a bucket and the one
   all-reduce of clipping's norm where ``grad_clip`` is set;
   ``zero1`` is held against the one-process run within the limits above
   (ResNet-50 only so: cuDNN's backward is not bit-reproducible).  On
   every run: the ranks' losses equal and finite, their params bit-equal
   after every step, each rank's batches placed on its own card (by the
   trainer's prefetcher), each flash kernel launched ``8 x 4`` times on every
   rank by the transformer (counts zeroed just before the steps and read
   just after) and none by ResNet-50, and under ``zero1`` each rank's
   optimizer state 1/N of ``psum_bucket``'s bytes (both printed).
   Printed: each run's step p50, the exchange's wire bytes a rank a step
   and its collectives a step; on one card the step time is taken on a
   card shared by two ranks with the all-reduce staged through the host,
   not a speed figure.

7. **The data plane.** The native crop (``theanompi_torch.native``,
   built from ``augment.c`` with ``cc``) must load.  ResNet-50 at phase
   5's config in bf16 (batch 256, 8 steps) through ``BSP(...).init`` and
   ``.wait()`` three times: rule key ``prefetch=0`` with
   ``loader_workers=0`` (inline), ``prefetch=2`` with
   ``loader_workers=0`` (the prefetch thread makes the shards), and
   ``prefetch=2`` with ``loader_workers=W``, W = min(8, cpu_count - 2)
   spawned loader processes; each prints step p50 (``calc``), ``wait``
   p50 and the run's pace, images/s over the steps' wall time with the
   waits, beside ``os.cpu_count()``, and its losses must be finite and
   equal across the three.  The pooled, prefetched stream's first 3
   batches, copied back from the card, must be bit-equal to the inline
   stream's; one step on a pooled, prefetched batch is traced with
   ``torch.profiler``, and the trace must show the image batch's
   host-to-device copy from pinned memory on a stream other than the one
   the step's kernels run on.  Then the transformer of phase 4 in bf16 on
   ``dataset="stream"`` (two synthetic sources of 2**22 tokens), 4 steps
   and no validation batch, at ``prefetch=2`` and at ``prefetch=0``: the
   params' 64-bit checksums, the losses and the stream's cursors must be
   equal, and each flash kernel launched ``8 x 4`` times in each run.

8. **Checkpoints and resume** through the launcher (``--ckpt``): the
   transformer and ResNet-50 under ``zero1`` on two ranks, each saved,
   resumed and held bit-equal to an uninterrupted run.

9. **The rest of the model zoo** at the reference's ``default_config``
   widths, bf16, each through ``BSP(...).init`` and ``.wait()`` (the
   launcher's ``run_rank``): AlexNet (224², 1000 classes, LRN) at batch
   128, VGG-16 (``fc_width`` 4096) at 64, GoogLeNet (``aux=True``, LRN) at
   32, the PTB LSTM (650 x 2 layers, seq 35, the synthetic stream at
   PTB's vocabulary 10000) at 32, DCGAN and WGAN (32², ``gen_base`` 128,
   ``disc_base`` 64, z 100; WGAN ``n_critic`` 5) at 64; 6 steps and one
   validation batch each (cut: steps).  Each step's loss and the
   validation metrics must be finite and none of the five kernels
   launched.  Printed: step ms p50 (``calc``), images or tokens/s, the
   data plane's ``wait`` p50, peak memory.  Then one fp32 step at a small
   batch on the card and on the CPU (and in float64 on the CPU), from
   freshly seeded weights and from the bf16 run's master weights, state
   and optimizer state, dropout 0 on both (the GAN's two steps under its
   own optimizer, with the same ``z``): loss, grad norm (the GAN's
   generator loss), new state, update and the activations' inputs within
   the stated tolerances, the CPU's runs on the card's branch at every
   ReLU and max-pool, and the kinks where that is not float64's counted.
   First, the LSTM layer at the model's width: ATen's LSTM (cuDNN's in
   fp32) against the plain loop, forward and grads, both timed.

10. **Serving what the launcher trained** — phase 8's transformer (phase
   4's at full width, bf16, 3 steps an epoch) trained 2 epochs through
   ``python -m theanompi_torch.launcher --checkpoint-dir``; its epoch 0,
   published alone into a second directory, served through the CLI's
   ``serve`` with ``--checkpoint-dir`` at phase 3's traffic in bf16 and
   with ``--quantize-int8``: the served epoch must be 0, every request
   ``done``, flash forward, paged decode and (int8) the int8 matmul
   launched, and the restored weights held against the plain engine with
   phase 3's limits.  Two replicas as processes of their own, at once:
   one serves a ``--queue-file`` to its drain sentinel, each rid in its
   ``REQUESTS.jsonl`` exactly once; the other takes SIGTERM while serving
   and must exit 0 within ``--drain-s``.  In process, on the kernel path:
   a ``RolloutManager`` (full verify) adopts epoch 1 in the middle of
   phase 3's traffic (8 sequences preempted and replayed), 8 further
   requests run at the new weights and are held against the plain path;
   a copy of epoch 1 with a leaf's byte flipped, published as epoch 2, is
   refused while epoch 1 keeps serving; an injected critical verdict
   rolls back to epoch 0's tree bit for bit, and the card's allocated
   bytes return to what they were before the swap.  Printed: each run's
   tokens/s, TTFT and decode-step p50, the adopting poll's and the
   rollback's host ms.

11. **The async rules** — through ``EASGD``, ``GOSGD`` and ``LocalSGD``
   ``(...).init(devices=N)`` on every rank of phase 6's layout (two or more
   cards: up to 4 NCCL ranks; one card: 2 ranks sharing it over gloo)
   (``rank_jobs.async_run``): the transformer at phase 4's config in bf16
   (global batch 16 as N x 16/N) under EASGD τ 2 and under GOSGD at
   ``p_push`` 1, and ResNet-50 at phase 5's config in bf16 (global batch
   256, each worker its own BN state) under EASGD τ 2, 4 steps and one
   validation batch each.  On every run: the ranks' losses finite; the
   workers' params different after every local step (before its
   exchange); the center bit-equal on every rank after every step
   (EASGD), the weights summing to 1 within 1e-6 (GOSGD); kernels 1-3
   launched ``8 x 4`` times on every rank by the transformer, none by
   ResNet-50.  Each run is held against a one-process emulation of the
   rule on the card (the N workers in turn from the same init and
   batches, the exchange in plain tensor ops): the params' update after
   the first exchange, the center's update (or the weights) after the last
   step and the validation cost on ``eval_args`` within phase 4's bf16
   limits.  Printed: step ms p50, the exchange's (``comm``) ms p50,
   tokens or images/s per worker, peak GiB per rank, the backend and the
   gossip transport (``all_gather`` for gloo ranks on CUDA tensors, else
   ``p2p``).  Then LocalSGD τ 1 against BSP ``psum`` on the same ranks
   (the transformer in fp32, plain SGD, 3 steps): the workers' mean loss
   and the params' update within phase 6's fp32 limits; and ResNet-50
   ``remat="save_convs"`` against ``"none"`` in bf16 at batch 256 in this
   process (cuDNN deterministic): the losses, the first step's grads, the
   update and the BN state after 2 steps within phase 5's limits, and the
   peak memory of both.

``python3 chip_smoke.py --decode`` runs phase 1 and kernels 4 and 5 of
phase 2 only, and prints no result line; ``--conv`` runs phases 1 and 5
only, ``--bsp`` phases 1 and 6 only, ``--data`` phases 1 and 7 only,
``--ckpt`` phases 1 and 8 only, ``--zoo`` phases 1 and 9 only,
``--serve-ckpt`` phases 1 and 10 only and ``--async`` phases 1 and 11
only, none of them printing a result line.

Output: the ``nvidia-smi`` line, one line per check, the serve reports,
the training lines, the conv-net lines, the multi-rank lines, the data
plane's lines, then ``{"kernels": [...]}`` (each kernel's
``launches_by_path``: the serving runs, the one-process training run,
the stream-fed training run at ``prefetch=2`` (``train_stream_bf16``)
and the multi-rank bf16 transformer runs summed over their ranks,
``train_bsp2_bf16`` under ``psum_bucket`` and its ``_overlap``,
``_zero1`` and ``_zero1_overlap`` twins, the resumed run
(``train_resume_bf16``), the zoo's runs summed (``train_zoo_bf16``) and
phase 10's serving runs from the checkpoint (``serve_ckpt_bf16``,
``serve_ckpt_int8``) and the rollout's drive (``serve_rollout_bf16``),
and phase 11's transformer runs summed over their ranks
(``train_easgd2_bf16``, ``train_gosgd2_bf16``))
and, last, ``{"ok": true,
"device": {...}}``.  fp32 products run without TF32 throughout.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: an fp32-accurate product runs on the tensor cores as three TF32 passes
#: (495 TFLOP/s dense), so the least time for the flash kernels' fp32 work
#: is taken at 495 / 3; their rows also print the CUDA-core bound (67
#: TFLOP/s) that stood before, for comparison
PEAK_FLOPS_FP32_TC = 495e12 / 3

SERVE_CFG = {"dim": 512, "heads": 8, "n_layers": 8, "seq_len": 2048,
             "vocab": 32768, "dropout": 0.0}
#: 16 greedy requests in two 8-turn sessions: prompts of 100, 200, ...,
#: 800 tokens, so the prefill buckets 128, 256, 512 and 1024 all run
SERVE_ARGS = ["--requests", "16", "--prompt-len", "100", "--turns", "8",
              "--max-new-tokens", "32", "--max-batch", "8",
              "--block-size", "16", "--seed", "0"]
AGREE_MIN = {"float32": 0.99, "bfloat16": 0.95}
#: kernels 1-3 at the training shape as CUDA-core kernels, before their
#: tensor-core redesign (PERF.md's kernel table, NVIDIA H100 80GB HBM3 at
#: 700 W, the last run of each before it; in fp32 the CUDA-core kernels
#: that the three-pass TF32 ones replaced): printed beside today's times,
#: checked against nothing
EARLIER_TRAIN_MS = {("flash_fwd", "bfloat16"): 3.3461,
                    ("flash_fwd", "float32"): 3.3415,
                    ("flash_bwd_dq", "bfloat16"): 4.7159,
                    ("flash_bwd_dq", "float32"): 4.5764,
                    ("flash_bwd_dkv", "bfloat16"): 5.7558,
                    ("flash_bwd_dkv", "float32"): 5.6411}


#: kernels 4 and 5 at every smoke shape before their redesign for the
#: decode step (the earlier kernels under this script's ``--decode``,
#: NVIDIA H100 80GB HBM3 at 700 W; PERF.md's kernel table): printed beside
#: today's times, checked against nothing.  Keyed by (kernel, dtype, the
#: row's case).
EARLIER_DECODE_MS = {
    ("paged_decode", "bfloat16", "ragged"): 0.1412,
    ("paged_decode", "float32", "ragged"): 0.1174,
    ("paged_decode", "bfloat16", "B=1 T=2048"): 0.1415,
    ("paged_decode", "float32", "B=1 T=2048"): 0.1172,
    ("paged_decode", "bfloat16", "B=8 T=2048"): 0.1664,
    ("paged_decode", "float32", "B=8 T=2048"): 0.2309,
    ("int8_matmul", "bfloat16", "M=1 [512,512]"): 0.0144,
    ("int8_matmul", "bfloat16", "M=8 [512,512]"): 0.0148,
    ("int8_matmul", "float32", "M=1 [512,512]"): 0.0123,
    ("int8_matmul", "float32", "M=8 [512,512]"): 0.0128,
    ("int8_matmul", "bfloat16", "M=1 [512,2048]"): 0.0147,
    ("int8_matmul", "bfloat16", "M=8 [512,2048]"): 0.0153,
    ("int8_matmul", "float32", "M=1 [512,2048]"): 0.0124,
    ("int8_matmul", "float32", "M=8 [512,2048]"): 0.0130,
    ("int8_matmul", "bfloat16", "M=1 [2048,512]"): 0.0151,
    ("int8_matmul", "bfloat16", "M=8 [2048,512]"): 0.0153,
    ("int8_matmul", "float32", "M=1 [2048,512]"): 0.0128,
    ("int8_matmul", "float32", "M=8 [2048,512]"): 0.0131,
    ("int8_matmul", "bfloat16", "M=1 [512,32768]"): 0.0472,
    ("int8_matmul", "bfloat16", "M=8 [512,32768]"): 0.0484,
    ("int8_matmul", "float32", "M=1 [512,32768]"): 0.0399,
    ("int8_matmul", "float32", "M=8 [512,32768]"): 0.0407,
}
#: kernel 5's launches in one decode step of the served model, by weight
#: shape: q, k, v and o of 8 layers, the MLP's two matmuls, the head
DECODE_INT8_CALLS = {(512, 512): 32, (512, 2048): 8, (2048, 512): 8,
                     (512, 32768): 1}


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


def bound_ms(n_bytes, flops, dtype, peak=None):
    """Least time on the card: max(bytes / memory rate, flops / peak of
    the operand type, or ``peak``); -> (ms, "bytes" | "operations")."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = flops / (peak or PEAK_FLOPS[dtype])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bound(n_bytes, flops, dtype):
    """A flash kernel's bound: fp32 work at the three-pass TF32 rate.
    -> (ms, "bytes" | "operations", the CUDA-core bound in ms for fp32,
    else None)."""
    if dtype != "float32":
        return (*bound_ms(n_bytes, flops, dtype), None)
    return (*bound_ms(n_bytes, flops, dtype, PEAK_FLOPS_FP32_TC),
            bound_ms(n_bytes, flops, dtype)[0])


def within(out, ref, rel, row, floor=0.0):
    """Hold ``out`` to ``ref`` element by element: ``|out - ref| <= rel *
    |ref| + row * rms(ref's row) + floor``, a row being one vector of the
    last axis (one query's head, one output row).  -> (max |out - ref|,
    the largest ratio of an error to its limit; <= 1 passes)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    rms = r.pow(2).mean(dim=-1, keepdim=True).sqrt()
    limit = (rel * r.abs() + row * rms + floor).clamp(min=1e-30)
    return float(err.max()), float((err / limit).max())


def _dname(dtype):
    return str(dtype).replace("torch.", "")


def sass_mma(tool, lib):
    """{function: (its HGMMA (wgmma) instructions, its TF32 HMMA (mma.sync
    with TF32 operands) instructions, all its HMMA instructions)} over the
    ``Function : ...`` sections of a library's SASS (``cuobjdump
    -sass``)."""
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = [0, 0, 0]
        elif fn is not None:
            counts[fn][0] += line.count("HGMMA")
            counts[fn][1] += "HMMA" in line and ".TF32" in line
            counts[fn][2] += "HMMA" in line
    return counts


def check_hgmma(K):
    """The number of HGMMA (wgmma) instructions in each flash kernel's bf16
    function (``<name>_wgmma_kernel<D>``, one per head dim), and of TF32
    HMMA instructions in its fp32 function (``<name>_tf32x3_kernel<D>``:
    ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``); fails if one has
    none (where ``cuobjdump`` exists)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("sass: cuobjdump not found, HGMMA not counted", flush=True)
        return
    libs = {}
    for k in K.KERNELS:
        lib = K._lib_path(k.source)
        if lib not in libs:
            libs[lib] = sass_mma(tool, lib)
            print(f"sass {os.path.basename(lib)}: "
                  f"{sum(n[0] for n in libs[lib].values())} HGMMA, "
                  f"{sum(n[1] for n in libs[lib].values())} TF32 HMMA "
                  f"instructions", flush=True)
        if k.name == "int8_matmul":
            # kernel 5's bf16 path runs mma.sync on bf16 operands
            tc = {fn: n[2] for fn, n in libs[lib].items()
                  if "int8_mm_tc_kernel" in fn}
            print(f"sass int8_mm_tc_kernel: {sum(tc.values())} HMMA "
                  f"instructions", flush=True)
            check(len(tc) == 1 and all(n > 0 for n in tc.values()),
                  f"int8_matmul: its tensor-core kernel has no HMMA "
                  f"instruction in its SASS ({tc})")
        if not k.source.startswith("flash_"):
            continue
        for suffix, col, what, dt in (
                ("_wgmma_kernel", 0, "HGMMA", "bf16"),
                ("_tf32x3_kernel", 1, "TF32 HMMA", "fp32")):
            fns = {fn: n[col] for fn, n in libs[lib].items()
                   if f"{k.name}{suffix}" in fn}
            for fn, n in sorted(fns.items()):
                d = re.search(r"ILi(\d+)E", fn)
                print(f"sass {k.name}{suffix}<{d.group(1) if d else '?'}>: "
                      f"{n} {what} instructions", flush=True)
            check(len(fns) == 3 and all(n > 0 for n in fns.values()),
                  f"{k.name}: a {dt} kernel has no {what} instruction in "
                  f"its SASS ({fns})")


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
    train = (TRAIN_ATTN["b"], TRAIN_ATTN["t"])
    cases.append(train)
    # fp32 also at T=8192: the longest chains of sums (out is summed over
    # 128 key tiles into one accumulator at the last rows)
    long_fp32 = (1, 8192)
    worst = {}  # dtype -> (the largest error/limit, the largest |lse-ref|)
    # out, element by element (see within): fp32 sums run in another order
    # than the plain version's (rel = row = 2e-5); a bf16 output may round
    # one ulp apart (rel 2**-7), and a probability on a bf16 rounding edge
    # may round either way, moving its row by up to 2**-8 of that key's
    # weight (row 2**-5).  lse: fp32 2e-5, bf16 4e-3 (such a flip moves the
    # row normalizer by <= 2**-8)
    for dtype, (rel, row, lse_tol) in (
            (torch.bfloat16, (2 ** -7, 2 ** -5, 4e-3)),
            (torch.float32, (2e-5, 2e-5, 2e-5))):
        fp32 = dtype == torch.float32
        for b, t in cases + ([long_fp32] if fp32 else []):
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
            dn = _dname(dtype)
            worst[dn] = tuple(max(x, y) for x, y in zip(
                worst.get(dn, (0.0, 0.0)), (ratio, lse_err)))
            if fp32 and (b, t) == train:
                # one CTA owns its rows of out, the key halves merged in a
                # fixed order
                again = flash_attention(q, k, v, causal=True)
                torch.cuda.synchronize()
                check(torch.equal(again[0], out)
                      and torch.equal(again[1], lse),
                      f"flash fp32 B={b} T={t}: two calls give different out "
                      f"or lse")
                print(f"check flash_fwd float32 B={b} T={t} H={h} D={d} "
                      f"causal: two calls give bit-equal out and lse",
                      flush=True)
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
            bms, by, bcc = flash_bound(n_bytes, flops, dn)
            shape = f"B={b} T={t} H={h} D={d} causal"
            rows.append(dict(dtype=dn, shape=shape,
                             max_abs_err=max(err, lse_err), ratio=ratio,
                             tol=f"{rel:.3g}|ref|+{row:.3g}rms+lse{lse_tol}",
                             ms=ms, call_ms=call_ms,
                             plain_ms=ref_ms, flops=flops,
                             library_ms=lib_ms, bound_ms=bms, bound_by=by,
                             bound_cuda_cores_ms=bcc))
    print(f"flash fwd: worst error/limit bf16 {worst['bfloat16'][0]:.3g} "
          f"(limit 2**-7|ref| + 2**-5 rms), |lse-ref| "
          f"{worst['bfloat16'][1]:.3g} (tol 4e-3); fp32 "
          f"{worst['float32'][0]:.3g} (limit 2e-5|ref| + 2e-5 rms), "
          f"|lse-ref| {worst['float32'][1]:.3g} (tol 2e-5)", flush=True)
    return rows


#: kernel 4's cases at the serving geometry (H=8, Dh=64, bs=16, 1025
#: blocks, tables of 128): the ragged decode batch (0 = an inactive slot
#: on the null block, up to 2047, two slots sharing their leading blocks;
#: first, the summary's row), one slot at 2047, and every slot at 2047
PAGED_POSITIONS = {"ragged": [0, 2047, 5, 100, 511, 1000, 1500, 37],
                   "B=1 T=2048": [2047],
                   "B=8 T=2048": [2047] * 8}


def paged_case(torch, dtype, gen, positions):
    """B=len(positions), H=8, Dh=64, bs=16, 1025 blocks: each active slot
    on its own blocks with a null tail (position 0 = an inactive slot on
    the null block); in the ragged case slots 3 and 4 share their leading
    two blocks."""
    b, h, d, bs, n_blocks, nb = len(positions), 8, 64, 16, 1025, 128
    tables = torch.zeros((b, nb), dtype=torch.int32)
    nxt = 1
    for s, p in enumerate(positions):
        if p == 0:
            continue  # inactive: all-null table
        need = p // bs + 1
        tables[s, :need] = torch.arange(nxt, nxt + need, dtype=torch.int32)
        nxt += need
    if positions == PAGED_POSITIONS["ragged"]:
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
    tols = ((torch.bfloat16, 2 ** -7, 1e-4), (torch.float32, 1e-5, 1e-5))
    for (case, pos_list), (dtype, rel, row) in itertools.product(
            PAGED_POSITIONS.items(), tols):
        args = paged_case(torch, dtype, gen, pos_list)
        out = paged_attend_decode(*args)
        again = paged_attend_decode(*args)
        ref = paged_attend_decode_ref(*args)
        torch.cuda.synchronize()
        err, ratio = within(out, ref, rel, row)
        check(torch.isfinite(out.float()).all().item(),
              f"paged {dtype} {case}: non-finite output (inactive slot?)")
        check(ratio <= 1, f"paged {dtype} {case}: |out-ref|={err:.3g}, "
              f"worst error/limit {ratio:.3g} (limit {rel:.3g}|ref| + "
              f"{row:.3g} rms(row))")
        check(torch.equal(out, again),
              f"paged {dtype} {case}: two calls differ")
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
        shown = ("ragged " + str(pos_list) if case == "ragged"
                 else f"positions={pos_list[0]}")
        rows.append(dict(dtype=_dname(dtype), shape=f"B={b} H={h} Dh={d} "
                         f"bs={bs} blocks=1025 {shown}", max_abs_err=err,
                         ratio=ratio, tol=f"{rel:.3g}|ref|+{row:.3g}rms",
                         ms=ms, call_ms=call_ms, plain_ms=ref_ms,
                         library_ms=None, flops=4 * ctx * h * d,
                         bound_ms=bms, bound_by=by, case=case))
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
                again = int8_matmul(x, qt)
                ref = int8_matmul_ref(x, qt)
                torch.cuda.synchronize()
                err, ratio = within(out, ref, rel, row)
                check(ratio <= 1,
                      f"int8 {dtype} M={m} [{din},{dout}]: |out-ref|="
                      f"{err:.3g}, worst error/limit {ratio:.3g} (limit "
                      f"{rel:.3g}|ref| + {row:.3g} rms(row))")
                check(torch.equal(out, again),
                      f"int8 {dtype} M={m} [{din},{dout}]: two calls differ")
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
                                 library_ms=lib_ms, flops=2 * m * din * dout,
                                 bound_ms=bms, bound_by=by,
                                 case=f"M={m} [{din},{dout}]"))
    return rows


#: kernels 2 and 3 against their plain version, element by element (see
#: within).  fp32: the sums over up to T terms run in another order and
#: dp - delta cancels, so errors are held against the row's rms as well
#: (rel = row = 1e-4).  bf16: ds and p round to bf16 inside the kernels and
#: one on a rounding edge may go either way (the flash forward's row term,
#: 2**-5); the outputs round once more (2**-7)
BWD_TOL = {"bfloat16": (2 ** -7, 2 ** -5), "float32": (1e-4, 1e-4)}
#: bf16 dq only, beside BWD_TOL: an absolute floor at 1e-5 of the largest
#: |dq|.  Kernel 2's tensor-core products accumulate in fp32 but do not
#: round to nearest at every add as IEEE sums do, so in a row whose true
#: gradient is 0 (the first causal query: one visible key) dp - delta
#: leaves ~1e-7 |dp| where the plain version's two IEEE sums cancel
#: exactly, and the row term scales with that row's own size, 0
DQ_BF16_FLOOR = 1e-5
#: the training shape of kernels 2 and 3 (bf16, causal, head dim 64)
TRAIN_ATTN = dict(b=16, t=2048, h=8, d=64)


def _bwd_launchers(torch, q, k, v, out, lse, g, causal):
    """Each backward kernel alone, called the way its wrapper calls it
    (for timing; these calls bump no launch count).  The closures hold
    every buffer whose pointer they pass."""
    from theanompi_torch.kernels import stream_ptr
    from theanompi_torch.ops.flash_attention import (
        FLASH_BWD_DKV,
        FLASH_BWD_DQ,
        _delta,
    )

    b, t, h, d = q.shape
    ins = (q, k, v, g, lse, _delta(out, g))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dt = 0 if q.dtype == torch.float32 else 1
    tail = (b, t, h, d, int(causal), float(d ** -0.5))

    def dq_call():
        FLASH_BWD_DQ.call("flash_bwd_dq", "ipppppppiiiiifp", dt,
                          *(x.data_ptr() for x in ins), dq.data_ptr(),
                          *tail, stream_ptr(q))

    def dkv_call():
        FLASH_BWD_DKV.call("flash_bwd_dkv", "ippppppppiiiiifp", dt,
                           *(x.data_ptr() for x in ins), dk.data_ptr(),
                           dv.data_ptr(), *tail, stream_ptr(q))

    return dq_call, dkv_call


def check_flash_bwd(torch):
    """Kernels 2 and 3 against their plain version at every listed shape;
    times (each kernel alone, the wrapper, the plain version, the SDPA
    backward) at the causal head-dim-64 shapes and the training shape.
    -> (rows for flash_bwd_dq, rows for flash_bwd_dkv)."""
    import torch.nn.functional as F

    from theanompi_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_ref,
    )

    dq_rows, dkv_rows = [], []
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [(dtype, causal, b, d, t)
             for dtype in (torch.bfloat16, torch.float32)
             for causal in (True, False) for b in (1, 2)
             for d in (32, 64, 128) for t in (128, 1040, 1024, 2048)]
    cases += [(dtype, True, TRAIN_ATTN["b"], TRAIN_ATTN["d"], TRAIN_ATTN["t"])
              for dtype in (torch.bfloat16, torch.float32)]
    worst = {}  # (dtype, "dq" | "dk/dv") -> the largest error/limit
    for dtype, causal, b, d, t in cases:
        h = 8
        dn = _dname(dtype)
        q, k, v, g = (torch.randn(b, t, h, d, device="cuda", generator=gen)
                      .to(dtype) for _ in range(4))
        out, lse = flash_attention(q, k, v, causal)
        got = flash_attention_bwd(q, k, v, out, lse, g, causal)
        ref = flash_attention_bwd_ref(q, k, v, out, lse, g, causal)
        torch.cuda.synchronize()
        rel, row = BWD_TOL[dn]
        errs = []
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            check(torch.isfinite(a.float()).all().item(),
                  f"flash bwd {dn} B={b} T={t} D={d} causal={causal}: "
                  f"non-finite {name}")
            floor = (DQ_BF16_FLOOR * float(r.float().abs().max())
                     if name == "dq" and dn == "bfloat16" else 0.0)
            err, ratio = within(a, r, rel, row, floor)
            check(ratio <= 1, f"flash bwd {dn} B={b} T={t} D={d} "
                  f"causal={causal}: {name} |out-ref|={err:.3g}, worst "
                  f"error/limit {ratio:.3g} (limit {rel:.3g}|ref| + "
                  f"{row:.3g} rms(row) + {floor:.3g})")
            errs.append((err, ratio))
            key = (dn, "dq" if name == "dq" else "dk/dv")
            worst[key] = max(worst.get(key, 0.0), ratio)
        shape = (f"B={b} T={t} H={h} D={d} "
                 f"{'causal' if causal else 'full'}")
        if dn == "float32" and b == TRAIN_ATTN["b"]:
            # one CTA owns its rows of dq (of dk and dv), summed in a fixed
            # order
            again = flash_attention_bwd(q, k, v, out, lse, g, causal)
            torch.cuda.synchronize()
            for name, x, y in zip(("dq", "dk", "dv"), again, got):
                check(torch.equal(x, y), f"flash bwd fp32 {shape}: two "
                      f"calls give different {name}")
            print(f"check flash_bwd_dq and flash_bwd_dkv float32 {shape}: "
                  f"two calls give bit-equal dq, dk and dv", flush=True)
        if not (causal and d == 64 and t in (128, 1024, 2048)):
            continue
        dq_call, dkv_call = _bwd_launchers(torch, q, k, v, out, lse, g,
                                           causal)
        dq_ms = time_ms(dq_call, 10, graph=True)
        dkv_ms = time_ms(dkv_call, 10, graph=True)
        call_ms = time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, g,
                                                      causal), 10)
        ref_ms = time_ms(lambda: flash_attention_bwd_ref(
            q, k, v, out, lse, g, causal), 3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal)
        gt = g.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), gt, retain_graph=True), 10)
        elt = q.element_size()
        n = b * t * h * d
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        rows_bytes = 2 * b * h * t * 4           # lse, delta
        for kernel_rows, ms, n_out, n_mm, mine, tol in (
                (dq_rows, dq_ms, 1, 3, errs[:1],
                 f"{rel:.3g}|ref|+{row:.3g}rms" + (
                     f"+{DQ_BF16_FLOOR:g}max" if dn == "bfloat16" else "")),
                (dkv_rows, dkv_ms, 2, 4, errs[1:],
                 f"{rel:.3g}|ref|+{row:.3g}rms")):
            err, ratio = max(e[0] for e in mine), max(e[1] for e in mine)
            bms, by, bcc = flash_bound((4 + n_out) * n * elt + rows_bytes,
                                       2 * n_mm * d * pairs, dn)
            kernel_rows.append(dict(
                dtype=dn, shape=shape, max_abs_err=err, ratio=ratio,
                tol=tol, ms=ms, call_ms=call_ms,
                plain_ms=ref_ms, library_ms=lib_ms, bound_ms=bms,
                flops=2 * n_mm * d * pairs, bound_by=by,
                bound_cuda_cores_ms=bcc))
    print(f"flash bwd: worst error/limit bf16 dq {worst['bfloat16', 'dq']:.3g}"
          f", dk/dv {worst['bfloat16', 'dk/dv']:.3g} "
          f"(limit {BWD_TOL['bfloat16'][0]:.3g}|ref| + "
          f"{BWD_TOL['bfloat16'][1]:.3g} rms, dq + {DQ_BF16_FLOOR:g} "
          f"max|dq|); fp32 dq {worst['float32', 'dq']:.3g}, dk/dv "
          f"{worst['float32', 'dk/dv']:.3g} "
          f"(limit {BWD_TOL['float32'][0]:.3g}|ref| + "
          f"{BWD_TOL['float32'][1]:.3g} rms); call_ms and ref_ms cover "
          f"both kernels, library_ms is SDPA's backward", flush=True)
    return dq_rows, dkv_rows


def check_flash_autograd(torch):
    """The second witness, fp32: ``FlashAttention``'s grads against
    autograd of the blockwise path (a different algorithm: the full fp32
    softmax).  Held at rtol 1e-4 with an absolute floor at 1e-5 of the
    largest gradient (rows whose true gradient is 0 come out at ~1e-8
    from dp - delta)."""
    from theanompi_torch.ops.attention import blockwise_attention
    from theanompi_torch.ops.flash_attention import FlashAttention

    gen = torch.Generator(device="cuda").manual_seed(6)
    for causal in (True, False):
        q, k, v, g = (torch.randn(2, 1024, 8, 64, device="cuda",
                                  generator=gen) for _ in range(4))
        a = [x.clone().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(
            (FlashAttention.apply(*a, causal)[0] * g).sum(), a)
        b = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = torch.autograd.grad(
            (blockwise_attention(*b, causal) * g).sum(), b)
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            floor = 1e-5 * float(r.abs().max())
            err = float((x - r).abs().max())
            ok = bool(torch.allclose(x, r, rtol=1e-4, atol=floor))
            print(f"check flash autograd fp32 B=2 T=1024 H=8 D=64 "
                  f"causal={causal} {name}: max|flash-blockwise|={err:.3g} "
                  f"(rtol 1e-4, atol {floor:.3g})", flush=True)
            check(ok, f"FlashAttention {name} differs from blockwise "
                  f"autograd by {err:.3g}")


def print_rows(name, rows):
    t_shape = (f"B={TRAIN_ATTN['b']} T={TRAIN_ATTN['t']} "
               f"H={TRAIN_ATTN['h']} D={TRAIN_ATTN['d']} causal")
    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        before = (EARLIER_TRAIN_MS.get((name, r["dtype"]))
                  if r["shape"].startswith(t_shape) else
                  EARLIER_DECODE_MS.get((name, r["dtype"], r.get("case"))))
        before = f" (earlier: {before} ms)" if before else ""
        # fp32 flash rows: the CUDA-core bound beside the three-pass TF32 one
        cc = ("" if r.get("bound_cuda_cores_ms") is None else
              f" bound_cuda_cores_ms={r['bound_cuda_cores_ms']:.5f}")
        print(f"check {name} {r['dtype']} {r['shape']}: "
              f"kernel_ms={r['ms']:.4f}{before} "
              f"TFLOP/s={r['flops'] / r['ms'] / 1e9:.2f} "
              f"bound_share={r['bound_ms'] / r['ms']:.4f} "
              f"call_ms={r['call_ms']:.4f} "
              f"ref_ms={r['plain_ms']:.4f} "
              f"library_ms={lib} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}){cc} max_abs_err={r['max_abs_err']:.3g} "
              f"err/limit={r['ratio']:.3g} limit={r['tol']}", flush=True)


def decode_step_ms(checks):
    """Device ms of kernels 4 and 5 in one decode step of the served model
    (8 layers, M=8 rows), per dtype, from the phase-2 rows: paged decode
    at the ragged batch once per layer, the int8 matmul at each weight
    shape as often as the step calls it."""
    out = {}
    for dt in ("bfloat16", "float32"):
        paged = next(r["ms"] for r in checks["paged_decode"]
                     if r["dtype"] == dt and r["case"] == "ragged")
        int8 = sum(n * next(r["ms"] for r in checks["int8_matmul"]
                            if r["dtype"] == dt
                            and r["case"] == f"M=8 [{din},{dout}]")
                   for (din, dout), n in DECODE_INT8_CALLS.items())
        out[dt] = (8 * paged, int8)
        print(f"decode step {dt}: paged decode 8 x {paged:.4f} = "
              f"{8 * paged:.4f} ms, int8 matmul (49 calls, M=8) "
              f"{int8:.4f} ms, together {8 * paged + int8:.4f} ms of "
              f"device time", flush=True)
    return out


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


def serve_run(torch, precision, quant, smi, kernels, ckpt=None):
    """One full-width run of the CLI's ``serve`` (the ``python -m
    theanompi_torch.serving`` entry point), with every kernel's launch
    count zeroed just before it and read just after; then the parity of
    the same weights against the plain path.  ``ckpt``: serve the
    checkpoint directory of phase 10 (``--checkpoint-dir``, its model
    config) instead of the seeded random init.  -> (launches, report)."""
    from theanompi_torch.models.transformer_lm import TransformerLM
    from theanompi_torch.serving import InferenceEngine
    from theanompi_torch.serving.cli import build_parser, serve
    from theanompi_torch.utils.checkpoint import load_for_inference

    tag = f"{'ckpt ' if ckpt else ''}{precision}{'+int8' if quant else ''}"
    cfg = (dict(CKPT_TRAIN_CFG) if ckpt
           else {**SERVE_CFG, "precision": precision})
    check(cfg["precision"] == precision, f"{tag}: the config is "
          f"{cfg['precision']}")
    argv = [a for k, v in cfg.items() for a in ("--set", f"{k}={v!r}")]
    argv += SERVE_ARGS + (["--quantize-int8"] if quant else [])
    argv += ["--checkpoint-dir", ckpt] if ckpt else []
    args = build_parser().parse_args(argv)
    done = {}
    for k in kernels:
        k.launches = 0
    report = serve(args, on_terminal=lambda r: done.__setitem__(r.rid, r))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    check(report["decode_kernel"] == "kernel", f"{tag}: decode kernel not "
          f"taken ({report['decode_kernel']})")
    if ckpt:
        check(report["checkpoint_epoch"] == 0, f"{tag}: served epoch "
              f"{report['checkpoint_epoch']}, expected 0")
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

    # the CLI's weights again (its seeded init, or the checkpoint restored
    # into it), through the kernel path and through the plain one
    params, _ = TransformerLM(cfg).init_params(
        torch.Generator().manual_seed(args.seed))
    if ckpt:
        params = load_for_inference(ckpt, {"params": params},
                                    model=TransformerLM(cfg))[2]["params"]
    geometry = dict(block_size=args.block_size, max_batch=args.max_batch,
                    quantize_int8=quant, seed=args.seed)
    kernel = InferenceEngine(TransformerLM(cfg), params, **geometry)
    plain = InferenceEngine(TransformerLM({**cfg, "attn_impl": "blockwise"}),
                            params, decode_kernel="off", **geometry)
    check(plain.decode_impl == "fallback", "plain engine took a kernel")
    check(_same_weights(kernel.params, plain.params),
          f"{tag}: the plain engine's weights differ")
    serve_parity(tag, precision, kernel, plain,
                 [done[i] for i in sorted(done)], args.max_new_tokens)
    return launches, report


def serve_parity(tag, precision, kernel, plain, reqs, n_new):
    """The kernel engine's first-token logits against the plain engine's
    on the same weights (within ``rel`` x max|plain|), and the plain
    engine's teacher-forced greedy agreement with the kernel path's
    streams ``reqs`` (>= ``AGREE_MIN``)."""
    err, scale = first_token_logits(kernel, plain, reqs)
    agree, total = teacher_forced(plain, reqs, n_new)
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


# -- phase 4: the training path ------------------------------------------------

#: ``bench.py:108-134``'s transformer: full width, batch 16, dropout 0, the
#: synthetic PTB stream (procedural-sparse bigram at V > 4096) with
#: n_train = 8 and n_val = 2 batches.  The loss is held on the first batch
#: itself, before step 1 and after step 8, since a loss of another batch
#: differs by more than 8 steps move it at initialization.  lr 0.05 (the
#: default config's is 1e-3; momentum 0.9 and the 1.0 global-norm clip
#: are the default's) gives that check a margin: the first-order fall of
#: the loss grows with lr
TRAIN_CFG = {"dim": 512, "heads": 8, "n_layers": 8, "seq_len": 2048,
             "vocab": 32768, "dropout": 0.0, "batch_size": 16,
             "n_train": 128, "n_val": 32, "n_epochs": 1, "lr": 0.05}
TRAIN_STEPS = TRAIN_CFG["n_train"] // TRAIN_CFG["batch_size"]
VAL_BATCHES = TRAIN_CFG["n_val"] // TRAIN_CFG["batch_size"]
#: the plain-path comparison (kernel path vs attn_impl="blockwise"): the
#: blockwise path keeps [B, H, T, T] fp32 scores for autograd in every
#: layer, so it runs at batch 2
PARITY_BATCH = 2
#: (loss, grad norm, update) relative tolerances of the kernel path against
#: the plain path.  fp32: the two differ only in the order of fp32 sums
#: (and the embedding backward's atomics).  bf16: the kernels round each
#: probability to bf16 where the blockwise path keeps an fp32 softmax, so
#: attention outputs differ by ~2**-8 relative and the differences grow
#: through 8 layers and the backward
PARITY_TOL = {"fp32": (1e-5, 1e-4, 1e-4), "bf16": (1e-2, 5e-2, 1e-1)}


def train_flops(cfg):
    """``bench.py:212-221``'s strict analytic model FLOPs of one training
    step (3x the forward, no rematerialization counted)."""
    t, d, heads, layers = (cfg["seq_len"], cfg["dim"], cfg["heads"],
                           cfg["n_layers"])
    bs, v = cfg["batch_size"], cfg["vocab"]
    n_tok = bs * t
    trunk = 6.0 * n_tok * layers * 12 * d * d
    attn = 3.0 * layers * 0.5 * 4.0 * bs * heads * t * t * (d // heads)
    head = 6.0 * n_tok * d * v
    return trunk + attn + head


def train_run(torch, precision, smi, kernels):
    """One full-width training run through ``BSP(...).init`` and
    ``.wait()``, with every kernel's launch count zeroed just before it
    and read just after.  -> (launches, per-step losses, step_ms p50)."""
    import statistics

    from theanompi_torch import BSP

    from theanompi_torch.utils.helper_funcs import to_device

    cfg = {**TRAIN_CFG, "precision": precision}
    rule = BSP({"print_freq": 1, "seed": 0}).init(
        devices=1, modelfile="theanompi_torch.models.transformer_lm",
        modelclass="TransformerLM", model_config=cfg)
    tr = rule.trainer
    check(tr.model.fused_loss_enabled(), "fused loss is off")
    for k in kernels:
        k.launches = 0
    rec = rule.wait()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    losses = rec.train_history["cost"]
    first = next(iter(tr.model.data.train_batches(tr.global_batch, 0,
                                                  seed=tr.seed)))
    with torch.no_grad():
        after, _ = tr.model.loss_fn(tr.params, tr.state,
                                    to_device(first, tr.device), None,
                                    train=False)
    after = float(after)
    steps_s = [w + c for w, c in zip(rec.time_history["wait"],
                                     rec.time_history["calc"])]
    p50 = statistics.median(steps_s)
    tokens = cfg["batch_size"] * cfg["seq_len"]
    util = train_flops(cfg) / p50 / PEAK_FLOPS["bfloat16"]
    print(f"train[{precision}] {smi}: losses={losses} "
          f"step_ms={[round(x * 1e3, 3) for x in steps_s]} "
          f"step_ms_p50={p50 * 1e3:.3f} tokens/s={tokens / p50:.1f} "
          f"analytic-FLOPs utilization (estimate, vs 989 TFLOP/s bf16)="
          f"{util:.4f} val={ {k: v[-1] for k, v in rec.val_history.items()} } "
          f"first-batch loss before step 1 {losses[0]:.7g}, after step "
          f"{len(losses)} {after:.7g} launches={launches}", flush=True)
    want = {"flash_fwd": 8 * (TRAIN_STEPS + VAL_BATCHES),
            "flash_bwd_dq": 8 * TRAIN_STEPS, "flash_bwd_dkv": 8 * TRAIN_STEPS}
    for name, n in want.items():
        check(launches[name] == n, f"train[{precision}]: {name} launched "
              f"{launches[name]} times, expected {n}")
    check(len(losses) == TRAIN_STEPS and all(
        x == x and abs(x) != float("inf") for x in losses),
        f"train[{precision}]: losses {losses}")
    check(after == after and after < losses[0], f"train[{precision}]: the "
          f"first batch's loss did not fall ({losses[0]} -> {after})")
    train_profile(torch, tr, first, cfg["lr"], precision)
    return launches, losses, p50


def train_profile(torch, tr, batch, lr, precision):
    """One more step of the trained model under ``torch.profiler``: the
    device's busy time against the step's wall time (host clock, ending in
    a sync), and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr.train_iter(batch, lr)                      # warm, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_iter(batch, lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an operator's own event also carries the device time
    # of the kernels it launched, which would count them twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print(f"profile[{precision}]: the profiler saw no device time "
              f"(device busy share not measured)", flush=True)
        return
    groups = {}
    for e in events:
        n = e.key
        g = ("flash_fwd" if "flash_fwd_" in n else
             "flash_bwd_dq" if "flash_bwd_dq_" in n else
             "flash_bwd_dkv" if "flash_bwd_dkv_" in n else
             "gemm" if any(w in n.lower() for w in ("gemm", "xmma",
                                                      "cutlass")) else
             # cuBLAS's Hopper GEMM kernels
             "gemm_nvjet" if n.startswith("nvjet") else
             "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    print(f"profile[{precision}] one step: wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms (idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}); by group (ms): "
          + ", ".join(f"{k}={v:.3f}" for k, v in sorted(
              groups.items(), key=lambda kv: -kv[1])), flush=True)
    for e in top:
        print(f"profile[{precision}]   {e.self_device_time_total / 1e3:9.3f}"
              f" ms x{e.count:<4d} {e.key[:110]}", flush=True)


def train_parity(torch, precision):
    """One step at batch 2 through the kernel path and through the plain
    path, same weights, same batch: loss, global grad norm and the
    params' update."""
    from theanompi_torch import BSP
    from theanompi_torch.ops.opt import global_sq_norm
    from theanompi_torch.parallel.trainer import loss_and_grads
    from theanompi_torch.tree import tree_leaves_with_path
    from theanompi_torch.utils.helper_funcs import to_device

    cfg = {**TRAIN_CFG, "precision": precision, "batch_size": PARITY_BATCH,
           "n_train": 4 * PARITY_BATCH, "n_val": PARITY_BATCH}
    out = {}
    for impl in ("pallas", "blockwise"):
        rule = BSP({"seed": 0, "verbose": False}).init(
            devices=1, model_config={**cfg, "attn_impl": impl})
        tr = rule.trainer
        batch = next(iter(tr.model.data.train_batches(PARITY_BATCH, 0)))
        _, metrics, grads = loss_and_grads(tr.model, tr.params, tr.state,
                                           to_device(batch, tr.device), None)
        before = tr.params
        tr.train_iter(batch, cfg["lr"])
        upd = [(a - b).flatten() for (_, a), (_, b) in zip(
            tree_leaves_with_path(tr.params), tree_leaves_with_path(before))]
        out[impl] = (float(metrics["cost"]),
                     float(torch.sqrt(global_sq_norm(grads))),
                     torch.cat(upd), before)
        del rule, tr, grads
        torch.cuda.empty_cache()
    (lk, gk, uk, pk), (lp, gp, up, pp) = out["pallas"], out["blockwise"]
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves_with_path(pk), tree_leaves_with_path(pp)))
    check(same, f"parity[{precision}]: the two paths start from different "
          f"weights")
    t_loss, t_norm, t_upd = PARITY_TOL[precision]
    d_loss = abs(lk - lp) / abs(lp)
    d_norm = abs(gk - gp) / gp
    d_upd = float((uk - up).norm() / up.norm())
    print(f"train parity[{precision}] batch {PARITY_BATCH}: loss kernel "
          f"{lk:.7g} plain {lp:.7g} (rel {d_loss:.3g}, tol {t_loss:g}); "
          f"grad norm kernel {gk:.7g} plain {gp:.7g} (rel {d_norm:.3g}, tol "
          f"{t_norm:g}); update |kernel-plain|/|plain| {d_upd:.3g} (tol "
          f"{t_upd:g})", flush=True)
    check(d_loss <= t_loss and d_norm <= t_norm and d_upd <= t_upd,
          f"train parity[{precision}]: kernel path differs from the plain "
          f"path")


# -- phase 5: the conv-net path ----------------------------------------------

#: ``bench.py:102-107``'s ResNet-50 (its TPU branch): batch 256, shard_size
#: 256, image 224, 1000 classes, stages (3, 4, 6, 3), stem conv7, the
#: model's default lr 0.1, Nesterov momentum 0.9, weight decay 1e-4;
#: 8 training steps (n_train 2048) and 1 validation batch (n_val 256)
CONV_CFG = {"batch_size": 256, "shard_size": 256, "image_size": 224,
            "n_classes": 1000, "stage_blocks": (3, 4, 6, 3),
            "stem": "conv7", "n_train": 2048, "n_val": 256, "n_epochs": 1}
CONV_STEPS = CONV_CFG["n_train"] // CONV_CFG["batch_size"]
#: ``bench.py:82``'s analytic forward + backward FLOPs of one image
CONV_FLOPS_PER_IMAGE = 3 * 4.1e9
#: the card-against-CPU step: fp32 (TF32 off) at batch 8, from the fp32
#: run's trained weights (every block's last BN scale off zero, so every
#: conv gets a gradient), its BN state and momentum.  (loss, global grad
#: norm, new BN state, updated params) relative tolerances.  The update's
#: is 5e-3, set from a measurement: at these weights the backward through
#: 53 BN layers at batch 8 is ill-conditioned in fp32, card and CPU 1.33e-3
#: and 1.19e-3 apart in two runs, the card's update 5.2e-4 and the CPU's
#: 1.2e-3 from the same step in float64 on the CPU (NVIDIA H100 80GB HBM3,
#: 700 W), so neither is at fault.  The step is also held to the float64
#: one: the card's fp32 update no farther from it than twice the CPU's
#: fp32 update, plus 1e-4
CONV_PARITY_BATCH = 8
CONV_PARITY_TOL = (1e-5, 1e-4, 1e-4, 5e-3)


def _kernel_group(name):
    """A device kernel's group in the conv-net profile, from its name."""
    low = name.lower()
    if "tonhwc" in low or "tonchw" in low or "transpose" in low:
        return "layout"
    if any(w in low for w in ("conv", "fprop", "dgrad", "wgrad", "implicit",
                              "cudnn", "nhwc", "nchw")):
        return "convolution"
    if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm"
    if "reduce" in low or "norm" in low:
        return "reduction"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def conv_run(torch, precision, smi, batch, kernels):
    """ResNet-50 through ``BSP(...).init`` and ``.wait()``, the five
    kernels' counts zeroed just before and read just after (the path
    launches none of them).  -> the trainer."""
    import statistics

    from theanompi_torch import BSP
    from theanompi_torch.tree import tree_leaves_with_path
    from theanompi_torch.utils.helper_funcs import to_device

    cfg = {**CONV_CFG, "precision": precision, "batch_size": batch,
           "shard_size": batch, "n_train": CONV_STEPS * batch,
           "n_val": batch}
    # inline feed, as phase 5 ran before the prefetcher: its step time
    # stays comparable (a prefetch thread making the shards in this
    # process slows the host's dispatch); phase 7 measures the feeds
    rule = BSP({"print_freq": 1, "seed": 0, "verbose": False,
                "prefetch": 0}).init(
        devices=1, modelfile="theanompi_torch.models.resnet50",
        modelclass="ResNet50", model_config=cfg)
    tr = rule.trainer
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rec = rule.wait()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = rec.train_history["cost"]
    first = next(iter(tr.model.data.train_batches(batch, 0, seed=tr.seed)))
    with torch.no_grad():
        # batch statistics, as the step-1 loss was taken (the running
        # statistics are 8 steps into their 0.9 average)
        after, _ = tr.model.loss_fn(tr.params, tr.state,
                                    to_device(first, tr.device), None,
                                    train=True)
    after = float(after)
    means = [x for p, x in tree_leaves_with_path(tr.state)
             if p[-1] == "mean"]
    moved = sum(bool((m != 0).any()) for m in means)
    calc, wait = rec.time_history["calc"], rec.time_history["wait"]
    p50, wait50 = statistics.median(calc), statistics.median(wait)
    util = CONV_FLOPS_PER_IMAGE * batch / p50 / PEAK_FLOPS["bfloat16"]
    print(f"conv[{precision}] {smi}: ResNet-50 batch {batch} losses="
          f"{losses} step_ms={[round(x * 1e3, 3) for x in calc]} "
          f"step_ms_p50={p50 * 1e3:.3f} images/s={batch / p50:.1f} "
          f"wait_ms_p50={wait50 * 1e3:.3f} (the host data plane, outside "
          f"the step) analytic-FLOPs utilization (estimate, 3 x 4.1e9 "
          f"FLOPs an image vs 989 TFLOP/s bf16)={util:.4f} "
          f"val={ {k: v[-1] for k, v in rec.val_history.items()} } "
          f"first-batch loss (batch statistics) before step 1 "
          f"{losses[0]:.7g}, after step {len(losses)} {after:.7g}; BN "
          f"running means moved off zero: {moved}/{len(means)}; peak "
          f"memory {peak_gb:.2f} GiB; launches of the five kernels "
          f"{launches}", flush=True)
    check(len(losses) == CONV_STEPS and all(
        x == x and abs(x) != float("inf") for x in losses),
        f"conv[{precision}]: losses {losses}")
    check(after == after and after < losses[0], f"conv[{precision}]: the "
          f"first batch's loss did not fall ({losses[0]} -> {after})")
    check(moved == len(means) == 53, f"conv[{precision}]: {moved} of "
          f"{len(means)} BN running means moved off zero")
    check(not any(launches.values()), f"conv[{precision}]: the conv-net "
          f"path launched {launches}")
    conv_profile(torch, tr, first, tr.model.adjust_hyperp(0), precision)
    return tr


def conv_profile(torch, tr, batch, lr, precision):
    """One more step under ``torch.profiler``: device busy against wall
    time, the kernel groups, and the device time of two named ranges, the
    BN forwards and the optimizer update (the BN backward's kernels fall
    in the groups)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from theanompi_torch.ops.layers import BatchNorm
    from theanompi_torch.parallel.trainer import make_train_step

    class Traced:
        """The trainer's optimizer, its update inside a named range."""

        def __init__(self, opt):
            self.opt = opt

        def update(self, *args):
            with record_function("optimizer"):
                return self.opt.update(*args)

    bn_apply = BatchNorm.apply_stateful

    def traced_bn(self, *args, **kwargs):
        with record_function("bn_forward"):
            return bn_apply(self, *args, **kwargs)

    tr.train_iter(batch, lr)                      # warm, outside the window
    torch.cuda.synchronize()
    tr._step_fn = make_train_step(tr.model, Traced(tr.optimizer),
                                  tr.exchanger, tr.seed, tr.device)
    BatchNorm.apply_stateful = traced_bn
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train_iter(batch, lr)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        BatchNorm.apply_stateful = bn_apply
        tr.compile_iter_fns()
    ranges = ("optimizer", "bn_forward")
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0 and e.key not in ranges
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        print(f"profile conv[{precision}]: the profiler saw no device time "
              f"(device busy share not measured)", flush=True)
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    groups = {}
    for e in events:
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    in_range = {e.key: e.device_time_total / 1e3 for e in averages
                if e.key in ranges and e.device_type == DeviceType.CPU}
    print(f"profile conv[{precision}] one step: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms (idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}); by group (ms): "
          + ", ".join(f"{k}={v:.3f}" for k, v in sorted(
              groups.items(), key=lambda kv: -kv[1]))
          + "; in ranges (ms): " + ", ".join(
              f"{k}={in_range.get(k, 0.0):.3f}" for k in ranges),
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile conv[{precision}]   "
              f"{e.self_device_time_total / 1e3:9.3f} ms x{e.count:<4d} "
              f"[{_kernel_group(e.key)}] {e.key[:100]}", flush=True)


def conv_parity(torch, trained):
    """One fp32 step at batch 8 on the card and on the CPU, from the same
    weights, state, momentum and batch: loss, global grad norm, the new
    BN state and the updated params; and the same step in float64 on the
    CPU, which both fp32 steps are held to."""
    from theanompi_torch.models.resnet50 import ResNet50
    from theanompi_torch.ops.opt import SGD, global_sq_norm
    from theanompi_torch.parallel.mesh import Precision
    from theanompi_torch.parallel.trainer import loss_and_grads
    from theanompi_torch.tree import tree_leaves_with_path, tree_map
    from theanompi_torch.utils.helper_funcs import to_device

    b = CONV_PARITY_BATCH
    cfg = {**CONV_CFG, "precision": "fp32", "batch_size": b,
           "shard_size": b, "n_train": b, "n_val": b}
    model = ResNet50(cfg)
    batch = next(iter(model.data.train_batches(b, 0)))
    lr = model.adjust_hyperp(0)

    def flat(tree):
        return torch.cat([x.double().flatten().cpu()
                          for _, x in tree_leaves_with_path(tree)]
                         or [torch.zeros(0, dtype=torch.float64)])

    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                       ("cpu", torch.float64)):
        model.precision = Precision(dtype)

        def put(tree):
            return tree_map(lambda x: x.to(dev, dtype), tree)

        params = put(trained.params)
        new_state, metrics, grads = loss_and_grads(
            model, params, put(trained.state), to_device(batch, dev), None)
        with torch.no_grad():
            new_params, _ = trained.optimizer.update(
                grads, put(trained.opt_state), params, lr)
        out[dev, dtype] = (float(metrics["cost"]),
                           float(torch.sqrt(global_sq_norm(grads))),
                           flat(new_state), flat(new_params) - flat(params))
    (lc, gc, sc, uc), (lh, gh, sh, uh), (_, _, _, u64) = out.values()
    d = (abs(lc - lh) / abs(lh), abs(gc - gh) / gh,
         float((sc - sh).norm() / sh.norm()),
         float((uc - uh).norm() / uh.norm()))
    exact_c = float((uc - u64).norm() / u64.norm())
    exact_h = float((uh - u64).norm() / u64.norm())
    print(f"conv parity[fp32] batch {b}, card against CPU: loss {lc:.7g} / "
          f"{lh:.7g} (rel {d[0]:.3g}, tol {CONV_PARITY_TOL[0]:g}); grad norm "
          f"{gc:.7g} / {gh:.7g} (rel {d[1]:.3g}, tol {CONV_PARITY_TOL[1]:g}); "
          f"BN state |card-cpu|/|cpu| {d[2]:.3g} (tol "
          f"{CONV_PARITY_TOL[2]:g}); update {d[3]:.3g} (tol "
          f"{CONV_PARITY_TOL[3]:g}); update against the float64 CPU step: "
          f"card {exact_c:.3g}, CPU fp32 {exact_h:.3g}", flush=True)
    check(all(x <= t for x, t in zip(d, CONV_PARITY_TOL)),
          "conv parity[fp32]: the card's step differs from the CPU's")
    check(exact_c <= 2 * exact_h + 1e-4, "conv parity[fp32]: the card's "
          "step is farther from the float64 step than the CPU's fp32 one")


def conv_phase(torch, smi, kernels):
    """Phase 5: ResNet-50 in bf16 and fp32 at batch 256 (fp32 at 128 if
    256 does not fit in the card's memory), then the card-against-CPU
    step."""
    import gc

    conv_run(torch, "bf16", smi, CONV_CFG["batch_size"], kernels)
    batch = CONV_CFG["batch_size"]
    try:
        trained = conv_run(torch, "fp32", smi, batch, kernels)
    except torch.cuda.OutOfMemoryError:
        trained = None
    if trained is None:  # outside the handler: its frames hold the memory
        gc.collect()
        torch.cuda.empty_cache()
        print(f"conv[fp32]: batch {batch} does not fit in the card's "
              f"memory, cut to {batch // 2}", flush=True)
        trained = conv_run(torch, "fp32", smi, batch // 2, kernels)
    conv_parity(torch, trained)


# -- phase 6: multi-rank BSP ---------------------------------------------------

#: strategies that gloo carries on CUDA tensors (all-reduce; it has no
#: send/recv of CUDA tensors, which the ring strategies need)
GLOO_CUDA_STRATEGIES = ("psum", "psum_bf16", "psum_bucket",
                        "psum_bf16_bucket")
#: the card's exchange check: per-rank trees of ragged leaves (one of the
#: LM head's shape), 1 MiB buckets
BSP_EXCH_SHAPES = {"head/w": (512, 2048), "head/b": (2048,),
                   "qkv/w": (1000, 37), "ln/scale": (13,)}
BSP_EXCH_TOL = {"fp32": 1e-6, "bf16": 1e-2, "int8": 5e-2}
BSP_STEPS = 4
#: the transformer at phase 4's config, global batch 16
BSP_TRAIN_CFG = {**TRAIN_CFG, "n_train": BSP_STEPS * TRAIN_CFG["batch_size"],
                 "n_val": TRAIN_CFG["batch_size"]}
#: ResNet-50 at phase 5's config, global batch 256, in shards of 128 so a
#: rank of two builds only its own shard a step
BSP_CONV_STEPS = 3
BSP_CONV_CFG = {**CONV_CFG, "shard_size": 128,
                "n_train": BSP_CONV_STEPS * CONV_CFG["batch_size"],
                "n_val": CONV_CFG["batch_size"]}
#: (loss, global grad norm, the params' update[, BN running state])
#: relative limits of the multi-rank step 1 against the one-process step 1
#: at the same global batch, same init and batch.  fp32: the two differ in
#: the grouping of fp32 sums (per-rank partial sums, then the all-reduce),
#: and, for ResNet-50, in cuDNN's choice of algorithm at batch 128 against
#: 256.  bf16: phase 4's limits of the kernel path against the plain path:
#: a product's bf16 rounding depends on the GEMM's shape (batch 8 against
#: 16, 128 against 256), and the differences grow through the layers
BSP_TOL = {("transformer", "fp32"): (1e-5, 1e-4, 1e-4),
           ("transformer", "bf16"): (1e-2, 5e-2, 1e-1),
           ("resnet50", "fp32"): (1e-5, 1e-4, 1e-3, 1e-4),
           ("resnet50", "bf16"): (1e-2, 5e-2, 1e-1, 5e-2)}


def bsp_layout(torch):
    """-> (ranks, backend, device, strategies, why): two or more cards
    take min(count, 4) ranks under NCCL, one card each, and every
    strategy; one card takes two ranks sharing it over gloo (NCCL refuses
    two ranks on one card), and the strategies gloo carries on CUDA."""
    from theanompi_torch.parallel.exchanger import (
        BUCKETED_STRATEGIES,
        LEAFWISE_STRATEGIES,
    )

    count = torch.cuda.device_count()
    if count >= 2:
        return (min(count, 4), "nccl", "cuda",
                tuple(s for s in LEAFWISE_STRATEGIES + BUCKETED_STRATEGIES
                      if s != "zero1"), None)
    return (2, "gloo", "cuda:0", GLOO_CUDA_STRATEGIES,
            "the ring strategies (ring, ring_bf16, ring_bucket, "
            "ring_bf16_bucket, ring_int8) were not run on the card: with "
            "one card the two ranks share it over gloo (NCCL refuses two "
            "ranks on one card), and gloo has no send/recv of CUDA tensors; "
            "tests/test_torch_exchanger.py holds them at 4 gloo ranks on "
            "the CPU")


def _saved_vector(torch, saved, key):
    """``saved[key]``'s leaves as one float64 vector; ``"update"`` is
    ``params1 - params0``."""
    from theanompi_torch.tree import tree_leaves_with_path

    def cat(tree):
        return torch.cat([x.double().flatten()
                          for _, x in tree_leaves_with_path(tree)])

    if key == "update":
        return cat(saved["params1"]) - cat(saved["params0"])
    return cat(saved[key])


def bsp_exchange_check(tmp, vals, strategies, result):
    """The exchange jobs' outputs (written by every rank) against the
    ranks' mean of ``vals`` (``[n, ...]`` a leaf), per strategy, and every
    rank's result equal; ``none`` (no exchange) against each rank's own
    input."""
    import numpy as np

    n = len(next(iter(vals.values())))
    worst = {}
    for s in strategies:
        tol = BSP_EXCH_TOL["int8" if "int8" in s else
                           "bf16" if "bf16" in s else "fp32"]
        outs = [np.load(os.path.join(tmp, f"{s}-r{r}.npz"))
                for r in range(n)]
        err = 0.0
        for k, v in vals.items():
            for r in range(n):
                got = outs[r][k]
                want = v[r] if s == "none" else v.mean(0)
                check(s == "none" or np.array_equal(got, outs[0][k]),
                      f"bsp exchange {s}: rank {r} differs from rank 0 on "
                      f"{k}")
                err = max(err, float(np.max(np.abs(got - want) / (
                    tol + tol * np.abs(want)))))
        worst[s] = round(err, 4)
        check(err <= 1.0, f"bsp exchange {s}: error/limit {err:.3g}")
    print(f"bsp exchange on the card, {n} ranks, {sum(v[0].size for v in vals.values())}"
          f" floats a rank, all-reduces issued {result}: worst "
          f"|err| / (tol (1 + |mean|)) per strategy {worst} (limits fp32 "
          f"1e-6, bf16 1e-2, int8 5e-2; each rank's result bit-equal)",
          flush=True)


def bucket_collectives_ok(res, strategy) -> bool:
    """Whether an overlapped run's first step issued every bucket's
    collective from backward: its exchange's collectives by name, one
    all-reduce a bucket under ``psum_bucket``; under ``zero1`` one
    reduce-scatter and one all-gather a bucket, and the one all-reduce
    of clipping's norm where ``grad_clip`` is set."""
    c, k = res["collectives"], res["buckets_from_backward"]
    if strategy == "zero1":
        return (k > 0 and c.get("reduce_scatter_tensor") == k
                and c.get("all_gather_into_tensor") == k
                and c.get("all_reduce", 0) == (1 if res["grad_clip"] else 0))
    return k > 0 and c == {"all_reduce": k}


def _run_name(model, precision, strategy, overlap):
    return (f"{model}-{precision}-{strategy}"
            + ("-overlap" if overlap else ""))


def _held_against_one(torch, tmp, name, res, one, one_name, tol):
    """The distances of a run's step 1 from the one-process step 1 at the
    same global batch: loss, global grad norm, the params' update[, the
    BN state] (relative); -> the list."""
    mine = torch.load(os.path.join(tmp, f"{name}-r0.pt"))
    ref = torch.load(os.path.join(tmp, f"{one_name}-r0.pt"))
    d = [abs(res[0]["metrics"][0]["cost"] - one["metrics"][0]["cost"])
         / abs(one["metrics"][0]["cost"]),
         abs(res[0]["grad_norm"] - one["grad_norm"]) / one["grad_norm"]]
    for key in ("update", "state1")[:len(tol) - 2]:
        a, b = (_saved_vector(torch, mine, key),
                _saved_vector(torch, ref, key))
        d.append(float((a - b).norm() / b.norm()))
    return d


def bsp_phase(torch, smi, kernels):
    """Phase 6: BSP on ranks of a process group against one process at
    the same global batch, and the exchange's ``zero1`` and overlap
    against the fused ``psum_bucket`` run.  -> each transformer bf16
    path's launches over the ranks (``train_bsp2_bf16`` and its
    ``_overlap``, ``_zero1`` and ``_zero1_overlap`` twins)."""
    import gc
    import shutil
    import statistics
    import tempfile

    import numpy as np

    from theanompi_torch import dist as tdist
    from theanompi_torch.parallel.rank_jobs import bsp_run, run_all

    n, backend, device, strategies, why = bsp_layout(torch)
    cards = [str(tdist.rank_device(device, r)) for r in range(n)]
    print(f"bsp: {n} ranks, backend {backend}, rank -> card "
          f"{dict(enumerate(cards))}", flush=True)
    if why:
        print(f"bsp: {why}", flush=True)
    tmp = tempfile.mkdtemp(prefix="bsp-")
    rng = np.random.RandomState(7)
    vals = {k: rng.randn(n, *shape).astype(np.float32)
            for k, shape in BSP_EXCH_SHAPES.items()}
    np.savez(os.path.join(tmp, "exch.npz"), **vals)
    cases = [(s, s, 2**20, 5) for s in strategies]
    models = {"transformer": (BSP_TRAIN_CFG, BSP_STEPS,
                              "theanompi_torch.models.transformer_lm",
                              "TransformerLM"),
              "resnet50": (BSP_CONV_CFG, BSP_CONV_STEPS,
                           "theanompi_torch.models.resnet50", "ResNet50")}
    # (model, precision, strategy, overlap): the fused psum_bucket runs,
    # held against one process, then the exchange's other paths
    variants = [(m, p, "psum_bucket", False) for m in models
                for p in ("bf16", "fp32")]
    variants += [("transformer", p, s, o) for p in ("bf16", "fp32")
                 for s, o in (("psum_bucket", True), ("zero1", False),
                              ("zero1", True))]
    variants.append(("resnet50", "bf16", "zero1", True))

    def job_of(model, precision, strategy, overlap, ranks):
        cfg, steps, mfile, mclass = models[model]
        return {"modelfile": mfile, "modelclass": mclass,
                "model_config": {**cfg, "precision": precision,
                                 "batch_size": cfg["batch_size"] // ranks},
                "rule_config": {"exch_strategy": strategy,
                                "exch_overlap": overlap, "seed": 0,
                                "verbose": False},
                "steps": steps,
                "out": os.path.join(tmp, _run_name(model, precision,
                                                   strategy, overlap)
                                    + ("" if ranks > 1 else "-one")),
                "save": ["params0", "params1", "state1"], "save_ranks": [0],
                # the ranks are new processes: IEEE fp32, as here
                "allow_tf32": False}

    # the one-process runs at the global batch, first (their memory is
    # returned to the card before the ranks start)
    single = {}
    for v in [(m, p, "psum_bucket", False) for m in models
              for p in ("bf16", "fp32")]:
        single[v] = bsp_run(cards[0], job_of(*v, 1))
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per_rank = tdist.spawn(run_all, n, backend, device, (
        [("exchange_cases", (os.path.join(tmp, "exch.npz"), tmp, cases)),
         *[("bsp_run", (job_of(*v, n),)) for v in variants]],),
        timeout_s=900)
    print(f"bsp: the ranks' jobs took {time.perf_counter() - t0:.1f} s",
          flush=True)
    bsp_exchange_check(tmp, vals, strategies, per_rank[0][0])
    label = ("a card shared by two ranks, all-reduce staged through the "
             "host (gloo): not a speed figure" if backend == "gloo" else
             "one card a rank (NCCL)")
    results = {v: [per_rank[r][i + 1] for r in range(n)]
               for i, v in enumerate(variants)}
    launches_by_path = {}
    for v, res in results.items():
        model, precision, strategy, overlap = v
        name = _run_name(*v)
        base = results[(model, precision, "psum_bucket", False)]
        one_v = (model, precision, "psum_bucket", False)
        one = single[one_v]
        tol = BSP_TOL[model, precision]
        p50 = statistics.median(res[0]["step_s"])
        launches = [r["launches"] for r in res]
        line = (f"bsp {model}[{precision}] {strategy}"
                + (" overlap" if overlap else "") + f" {smi}: {n} x "
                f"{res[0]['global_batch'] // n}, losses "
                f"{[m['cost'] for m in res[0]['metrics']]}; step_ms p50 "
                f"{p50 * 1e3:.3f} on {label} (one process "
                f"{statistics.median(one['step_s']) * 1e3:.3f}); exchange "
                f"wire bytes a rank a step {res[0]['wire_bytes']}, "
                f"collectives a step {res[0]['collectives']}, buckets issued "
                f"from backward {res[0]['buckets_from_backward']}; optimizer "
                f"state a rank {res[0]['opt_state_bytes']} B "
                f"(psum_bucket's {base[0]['opt_state_bytes']} B); launches "
                f"per rank {launches}")
        if not overlap:
            d = _held_against_one(torch, tmp, name, res, one,
                                  _run_name(*one_v) + "-one", tol)
            line += (f"; step 1 against one process: loss rel {d[0]:.3g} "
                     f"(tol {tol[0]:g}), grad norm rel {d[1]:.3g} (tol "
                     f"{tol[1]:g}), update rel {d[2]:.3g} (tol {tol[2]:g})"
                     + (f", BN state rel {d[3]:.3g} (tol {tol[3]:g})"
                        if len(d) > 3 else ""))
            check(all(x <= t for x, t in zip(d, tol)), f"bsp {name}: the "
                  f"{n}-rank step differs from the one-process step")
        else:
            fused = results.get((model, precision, strategy, False))
            if fused is not None:
                same = (res[0]["digests"] == fused[0]["digests"]
                        and res[0]["metrics"] == fused[0]["metrics"])
                line += (f"; params after every step bit-equal to the fused "
                         f"{strategy} run: {same}")
                check(same, f"bsp {name}: the overlapped run's params differ "
                      f"from the fused run's")
            else:
                # ResNet-50's overlapped run: no fused twin; one process
                d = _held_against_one(torch, tmp, name, res, one,
                                      _run_name(*one_v) + "-one", tol)
                line += (f"; step 1 against one process: {[f'{x:.3g}' for x in d]}"
                         f" (tol {tol})")
                check(all(x <= t for x, t in zip(d, tol)), f"bsp {name}: "
                      f"the {n}-rank step differs from the one-process step")
            check(bucket_collectives_ok(res[0], strategy), f"bsp {name}: "
                  f"{res[0]['buckets_from_backward']} buckets issued from "
                  f"backward, collectives {res[0]['collectives']}")
        print(line, flush=True)
        check(all(x == x and abs(x) != float("inf") for r in res
                  for x in (m["cost"] for m in r["metrics"])),
              f"bsp {name}: a loss is not finite")
        check(all(r["metrics"] == res[0]["metrics"] for r in res),
              f"bsp {name}: the ranks' metrics differ")
        check(all(r["digests"] == res[0]["digests"] for r in res),
              f"bsp {name}: the ranks' params differ after a step")
        check(all(r["batch_devices"] == [r["device"]] for r in res),
              f"bsp {name}: batches arrived on "
              f"{[r['batch_devices'] for r in res]}, not on the ranks' cards "
              f"{[r['device'] for r in res]}")
        if strategy == "zero1":
            ratio = res[0]["opt_state_bytes"] * n / base[0]["opt_state_bytes"]
            check(abs(ratio - 1) < 1e-3, f"bsp {name}: optimizer state a "
                  f"rank {res[0]['opt_state_bytes']} B is not 1/{n} of "
                  f"{base[0]['opt_state_bytes']} B")
        if model == "transformer":
            want = 8 * BSP_STEPS
            for r, got in enumerate(launches):
                check(all(got[k] == want for k in (
                    "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
                    f"bsp {name}: rank {r} launched {got}, expected "
                    f"{want} of each flash kernel")
            if precision == "bf16":
                path = "train_bsp2_bf16" + (
                    "" if strategy == "psum_bucket" else "_zero1") + (
                    "_overlap" if overlap else "")
                launches_by_path[path] = {
                    k.name: sum(got[k.name] for got in launches)
                    for k in kernels}
        else:
            check(not any(v for got in launches for v in got.values()),
                  f"bsp {name}: launched {launches}")
    shutil.rmtree(tmp, ignore_errors=True)
    return launches_by_path


# -- phase 7: the data plane --------------------------------------------------

#: ResNet-50 at phase 5's config in bf16, fed three ways: (rule key
#: ``prefetch``, model key ``loader_workers``; None: :func:`data_workers`)
DATA_FEEDS = ((0, 0), (2, 0), (2, None))
#: the pooled, prefetched stream's first batches held against the inline
DATA_EQUAL_BATCHES = 3
#: the transformer of phase 4 on the token stream: two synthetic sources of
#: 2**22 tokens (2047 windows each, none read twice), 4 steps, no
#: validation batch (so each flash kernel launches 8 layers x 4 steps)
DATA_STREAM_STEPS = 4
DATA_STREAM_CFG = {
    **TRAIN_CFG, "precision": "bf16", "dataset": "stream",
    "n_train": DATA_STREAM_STEPS * TRAIN_CFG["batch_size"], "n_val": 0,
    "stream_sources": [
        {"name": "syn-a", "weight": 0.75, "tokens": 2 ** 22,
         "vocab": TRAIN_CFG["vocab"], "seed": 11},
        {"name": "syn-b", "weight": 0.25, "tokens": 2 ** 22,
         "vocab": TRAIN_CFG["vocab"], "seed": 13}]}


def data_workers() -> int:
    """The loader pool's size: the host's cores less two (the training
    thread and the prefetch thread), at most 8."""
    return max(1, min(8, (os.cpu_count() or 1) - 2))


def data_conv_run(torch, smi, prefetch, workers, kernels):
    """ResNet-50 (phase 5's config, bf16) through ``BSP(...).init`` and
    ``.wait()`` at rule key ``prefetch`` and model key
    ``loader_workers``.  -> (the trainer, the printed numbers)."""
    import statistics

    from theanompi_torch import BSP

    cfg = {**CONV_CFG, "precision": "bf16", "loader_workers": workers}
    rule = BSP({"print_freq": 1, "seed": 0, "verbose": False,
                "prefetch": prefetch, "prefetch_stall_timeout": 600}).init(
        devices=1, modelfile="theanompi_torch.models.resnet50",
        modelclass="ResNet50", model_config=cfg)
    for k in kernels:
        k.launches = 0
    rec = rule.wait()
    torch.cuda.synchronize()
    losses = rec.train_history["cost"]
    calc, wait = rec.time_history["calc"], rec.time_history["wait"]
    steps_s = [c + w for c, w in zip(calc, wait)]
    b = CONV_CFG["batch_size"]
    out = {"step_ms_p50": statistics.median(calc) * 1e3,
           "wait_ms_p50": statistics.median(wait) * 1e3,
           "images_per_s": b * len(steps_s) / sum(steps_s),
           "images_per_s_after_step_1": b * (len(steps_s) - 1)
           / sum(steps_s[1:])}
    print(f"data conv[bf16] {smi} cpu_count={os.cpu_count()}: prefetch="
          f"{prefetch} loader_workers={workers}: step_ms p50 "
          f"{out['step_ms_p50']:.3f}, wait_ms p50 {out['wait_ms_p50']:.3f}, "
          f"images/s over the steps' wall time, waits included "
          f"{out['images_per_s']:.1f} (after step 1: "
          f"{out['images_per_s_after_step_1']:.1f}); wait_ms "
          f"{[round(x * 1e3, 3) for x in wait]} step_ms "
          f"{[round(x * 1e3, 3) for x in calc]} losses {losses}",
          flush=True)
    check(len(losses) == CONV_STEPS and all(
        x == x and abs(x) != float("inf") for x in losses),
        f"data conv[prefetch={prefetch}, workers={workers}]: losses "
        f"{losses}")
    check(not any(k.launches for k in kernels), "data conv: the conv-net "
          "path launched a kernel")
    return rule.trainer, out


def data_equal_and_traced(torch, smi, trainer, workers):
    """The pooled, prefetched stream's first batches, copied back to the
    host, against the inline stream; then one step on a pooled batch
    under ``torch.profiler``, whose trace must show the image batch's
    copy from pinned memory on a stream the step's kernels do not use."""
    import collections
    import shutil
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from theanompi_torch.models.data.imagenet import ImageNetData
    from theanompi_torch.models.data.prefetch import Prefetcher

    b = CONV_CFG["batch_size"]
    inline = ImageNetData(dict(CONV_CFG))
    pooled = ImageNetData({**CONV_CFG, "loader_workers": workers})
    tmp = tempfile.mkdtemp(prefix="data-")
    try:
        pf = Prefetcher(pooled.train_batches(b, 0, seed=0),
                        device=trainer.device, depth=2, stall_timeout=600)
        try:
            got = [{k: t.cpu().numpy() for k, t in next(pf).items()}
                   for _ in range(DATA_EQUAL_BATCHES)]
        finally:
            pf.close()
        want = list(itertools.islice(inline.train_batches(b, 0, seed=0),
                                     DATA_EQUAL_BATCHES))
        same = all(g["x"].dtype == np.uint8 and all(
            np.array_equal(g[k], w[k]) for k in ("x", "y"))
            for g, w in zip(got, want))
        print(f"data: the first {DATA_EQUAL_BATCHES} batches of the pooled "
              f"({workers} workers), prefetched stream, copied back from "
              f"the card, bit-equal to the inline stream: {same}",
              flush=True)
        check(same, "data: the pooled, prefetched batches differ from the "
              "inline ones")
        lr = trainer.model.adjust_hyperp(0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pf = Prefetcher(pooled.train_batches(b, 1, seed=0),
                            device=trainer.device, depth=2,
                            stall_timeout=600)
            try:
                trainer.train_iter(next(pf), lr)
                torch.cuda.synchronize()
            finally:
                pf.close()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        pooled.cleanup()
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = collections.Counter(
        e.get("args", {}).get("stream") for e in events
        if e.get("cat") == "kernel")
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    x_bytes = b * CONV_CFG["image_size"] ** 2 * 3
    if not kernels:
        print("data: the profiler saw no device activity (the pinned "
              "side-stream copy not measured)", flush=True)
        check(False, "data: no device trace of the prefetched step")
    compute = kernels.most_common(1)[0][0]
    image = [e for e in copies if e.get("args", {}).get("bytes") == x_bytes]
    print(f"data: traced step: compute stream {compute} ({kernels[compute]} "
          f"kernels); host-to-device copies "
          + "; ".join(f"{e['name']} {e['args'].get('bytes')} B on stream "
                      f"{e['args'].get('stream')}, {e.get('dur')} us"
                      for e in copies), flush=True)
    check(any("Pinned" in e["name"] and e["args"].get("stream") != compute
              for e in image), "data: the image batch's copy is not from "
          "pinned memory on a side stream")


def data_stream_run(torch, smi, prefetch, kernels):
    """The transformer on the token stream, 4 steps at rule key
    ``prefetch``, the kernels' counts zeroed just before and read just
    after.  -> (the params' checksum after the run, the losses, the
    launches, the stream's cursors)."""
    from theanompi_torch import BSP
    from theanompi_torch.parallel.rank_jobs import digest

    rule = BSP({"print_freq": 1, "seed": 0, "verbose": False,
                "prefetch": prefetch, "prefetch_stall_timeout": 600}).init(
        devices=1, modelfile="theanompi_torch.models.transformer_lm",
        modelclass="TransformerLM", model_config=dict(DATA_STREAM_CFG))
    tr = rule.trainer
    check(type(tr.model.data).__name__ == "StreamTokenDataset",
          "data stream: the model is not on the token stream")
    for k in kernels:
        k.launches = 0
    rec = rule.wait()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    out = (digest(tr.params), rec.train_history["cost"], launches,
           tr.model.data.state()["cursors"])
    del rule, tr
    torch.cuda.empty_cache()
    return out


def data_phase(torch, smi, kernels):
    """Phase 7: ResNet-50 fed inline, prefetched, and prefetched from the
    loader pool; the pooled stream against the inline one and the traced
    side-stream copy; the transformer on the token stream at prefetch 2
    against prefetch 0.  -> the stream run's launches."""
    import gc

    from theanompi_torch import native

    workers = data_workers()
    check(native.available(), "data: the native crop did not build")
    print(f"data: native crop built ({native._SO}); cpu_count "
          f"{os.cpu_count()}, loader pool {workers} workers", flush=True)
    for prefetch, w in DATA_FEEDS:
        trainer = None  # one ResNet-50 on the card at a time
        gc.collect()
        torch.cuda.empty_cache()
        trainer, _ = data_conv_run(torch, smi, prefetch,
                                   workers if w is None else w, kernels)
    data_equal_and_traced(torch, smi, trainer, workers)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    runs = {p: data_stream_run(torch, smi, p, kernels) for p in (2, 0)}
    (d2, l2, n2, c2), (d0, l0, n0, c0) = runs[2], runs[0]
    print(f"data stream[bf16] {smi}: TransformerLM on the token stream, "
          f"{DATA_STREAM_STEPS} steps; prefetch 2 losses {l2} params "
          f"checksum {d2}; prefetch 0 losses {l0} checksum {d0}; bit-equal "
          f"{d2 == d0 and l2 == l0}; cursors after the epoch {c2}; "
          f"launches {n2}", flush=True)
    check(d2 == d0 and l2 == l0 and c2 == c0, "data stream: prefetch 2 and "
          "prefetch 0 trained different params")
    check(len(l2) == DATA_STREAM_STEPS and all(
        x == x and abs(x) != float("inf") for x in l2),
        f"data stream: losses {l2}")
    want = 8 * DATA_STREAM_STEPS
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(n2[name] == n0[name] == want, f"data stream: {name} launched "
              f"{n2[name]} / {n0[name]} times, expected {want}")
    return n2


# -- phase 8: checkpoints and resume ------------------------------------------

#: the transformer of phase 4 in bf16, 3 steps an epoch and 1 validation
#: batch, through ``python -m theanompi_torch.launcher``
CKPT_STEPS = 3
CKPT_TRAIN_CFG = {**TRAIN_CFG, "precision": "bf16",
                  "n_train": CKPT_STEPS * TRAIN_CFG["batch_size"],
                  "n_val": TRAIN_CFG["batch_size"]}
#: ResNet-50 at phase 5's config in bf16, global batch 256 over two ranks
#: of 128 (shards of 128), 3 steps an epoch, 1 validation batch
CKPT_CONV_CFG = {**BSP_CONV_CFG, "precision": "bf16",
                 "batch_size": CONV_CFG["batch_size"] // 2}
CKPT_RANKS = 2
_PUBLISHED = re.compile(r"checkpoint: published (ckpt_e\d+\.npz) .*: (\d+) "
                        r"bytes, snapshot_ms ([\d.]+), write_ms ([\d.]+)")


def flip_leaf_byte(path, member=None):
    """Flip the last byte of ``member``'s data (the first member's by
    default) inside the archive, its zip directory and headers intact:
    only a ``full`` verify sees it."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        info = z.getinfo(member or z.namelist()[0])
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)
        n_name = int.from_bytes(f.read(2), "little")
        n_extra = int.from_bytes(f.read(2), "little")
        at = info.header_offset + 30 + n_name + n_extra \
            + info.compress_size - 1
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 0xFF]))


def ckpt_launcher(args, what, expect=0):
    """``python -m theanompi_torch.launcher ARGS`` from the checkout, in a
    process of its own; -> its standard output.  Fails unless it exits
    ``expect``."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "theanompi_torch.launcher",
                        *args], cwd=HERE, capture_output=True, text=True,
                       timeout=900, env={**os.environ, "PYTHONPATH": HERE})
    print(f"ckpt {what}: exit {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if r.returncode != expect:
        print(r.stdout[-4000:] + r.stderr[-4000:], flush=True)
    check(r.returncode == expect, f"ckpt {what}: the launcher exited "
          f"{r.returncode}, expected {expect}")
    return r.stdout


def ckpt_verify_cli(d, expect):
    r = subprocess.run([sys.executable, "-m",
                        "theanompi_torch.utils.checkpoint", "--verify", d],
                       cwd=HERE, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": HERE})
    print(f"ckpt --verify {os.path.basename(d)}: exit {r.returncode}: "
          f"{r.stdout.strip().splitlines()[-1]}", flush=True)
    check(r.returncode == expect, f"ckpt: --verify {d} exited "
          f"{r.returncode}, expected {expect}")


def ckpt_same(a, b, name):
    """Epoch 1 of run ``a`` against run ``b``: every leaf bit-equal, the
    manifests byte-equal.  -> the count of leaves."""
    import numpy as np

    fa, fb = (os.path.join(d, "ckpt_e0001.npz") for d in (a, b))
    with np.load(fa) as za, np.load(fb) as zb:
        check(set(za.files) == set(zb.files), f"ckpt {name}: the leaf sets "
              f"differ")
        diff = [k for k in za.files if za[k].tobytes() != zb[k].tobytes()]
        n = len(za.files)
    with open(fa[:-4] + ".manifest.json", "rb") as f1, \
            open(fb[:-4] + ".manifest.json", "rb") as f2:
        same_manifest = f1.read() == f2.read()
    print(f"ckpt {name}: the resumed run's ckpt_e0001.npz against the "
          f"uninterrupted run's: {n - len(diff)}/{n} leaves bit-equal"
          + (f" (differ: {diff[:5]})" if diff else "")
          + f"; manifests byte-equal {same_manifest}", flush=True)
    check(not diff and same_manifest, f"ckpt {name}: the resumed run's "
          f"epoch 1 differs from the uninterrupted run's")
    return n


def ckpt_numbers(name, smi, out, d):
    """Print the saves' bytes, ``snapshot_ms`` (the training thread's
    share) and ``write_ms`` (the writer's), the full verify's time, and
    the first step after the epoch boundary against the step p50."""
    import statistics

    import numpy as np

    from theanompi_torch.utils.checkpoint import verify_file

    saves = _PUBLISHED.findall(out)
    check(len(saves) == 2, f"ckpt {name}: {len(saves)} publish lines, "
          f"expected 2")
    t0 = time.perf_counter()
    verify_file(os.path.join(d, "ckpt_e0001.npz"), "full")
    verify_ms = (time.perf_counter() - t0) * 1e3
    calc = np.load(os.path.join(d, "time_history.npy"),
                   allow_pickle=True).item()["calc"].tolist()
    first = calc[CKPT_STEPS]
    p50 = statistics.median(calc[1:])
    for f, nbytes, snap, write in saves:
        print(f"ckpt {name} {smi}: {f}: {nbytes} bytes, snapshot_ms {snap} "
              f"(training thread), write_ms {write} (writer thread)",
              flush=True)
    print(f"ckpt {name} {smi}: verify_full_ms {verify_ms:.3f}; the first "
          f"step after the epoch-0 boundary {first * 1e3:.3f} ms against "
          f"the p50 of the steps after the first {p50 * 1e3:.3f} ms (step "
          f"ms {[round(x * 1e3, 3) for x in calc]})", flush=True)


def ckpt_transformer(torch, smi, tmp):
    """Phase 8 (a): the transformer through the launcher.  -> run C's
    kernel launches."""
    import shutil

    import numpy as np

    from theanompi_torch.resilience.events import read_events

    base = ["--modelfile", "theanompi_torch.models.transformer_lm",
            "--modelclass", "TransformerLM", "--rule-set", "print_freq=1"]
    base += [a for k, v in CKPT_TRAIN_CFG.items()
             for a in ("--set", f"{k}={v!r}")]
    A, B = os.path.join(tmp, "lm-A"), os.path.join(tmp, "lm-B")

    def run(d, n_epochs, what, *extra, expect=0):
        return ckpt_launcher(base + ["--set", f"n_epochs={n_epochs}",
                                     "--checkpoint-dir", d, *extra],
                             what, expect)

    out_a = run(A, 2, "lm A (2 epochs)")
    run(B, 1, "lm B (1 epoch)")
    out_c = run(B, 2, "lm C (--resume of B to 2 epochs)", "--resume")
    ckpt_same(B, A, "lm")
    val = np.load(os.path.join(B, "val_history.npy"),
                  allow_pickle=True).item()
    check(list(val["epoch"]) == [0, 1], f"ckpt lm: C's validation history "
          f"holds epochs {list(val['epoch'])}")
    ckpt_numbers("lm", smi, out_a, A)
    for d in (A, B):
        ckpt_verify_cli(d, 0)
    # one byte flipped inside a leaf of a copy of B's epoch 1
    D = os.path.join(tmp, "lm-D")
    os.makedirs(D)
    for f in os.listdir(B):
        if os.path.isfile(os.path.join(B, f)):
            shutil.copy(os.path.join(B, f), D)
    flip_leaf_byte(os.path.join(D, "ckpt_e0001.npz"), "params::head/w.npy")
    ckpt_verify_cli(D, 77)
    run(D, 2, "lm D (--resume of the flipped copy, full verify)",
        "--resume", "--rule-set", "checkpoint_verify='full'")
    fell = [e for e in read_events(os.path.join(D, "resilience.json"))
            if e["name"] == "ckpt.fallback"]
    quarantined = os.path.exists(os.path.join(D, "corrupt",
                                              "ckpt_e0001.npz"))
    print(f"ckpt lm D: fell back to {[e['restored_epoch'] for e in fell]} "
          f"over {[e['bad_epochs'] for e in fell]}; ckpt_e0001.npz under "
          f"corrupt/ {quarantined}", flush=True)
    check(quarantined and [e["restored_epoch"] for e in fell] == [0],
          "ckpt lm D: the flipped file was not stepped over")
    ckpt_same(D, A, "lm D")
    launches = json.loads(out_c.split("tmlauncher: kernel launches: ")[1]
                          .splitlines()[0])
    print(f"ckpt lm C launches {launches}", flush=True)
    want = {"flash_fwd": 8 * (CKPT_STEPS + 1), "flash_bwd_dq": 8 * CKPT_STEPS,
            "flash_bwd_dkv": 8 * CKPT_STEPS}
    for k, n in want.items():
        check(launches.get(k) == n, f"ckpt lm C: {k} launched "
              f"{launches.get(k)} times, expected {n}")
    for d in (A, B, D):
        shutil.rmtree(d, ignore_errors=True)
    return launches


def ckpt_conv(torch, smi, tmp):
    """Phase 8 (b): ResNet-50 under ``zero1`` on two ranks, through the
    launcher's ``run_rank`` on each rank of ``dist.spawn``; cuDNN held to
    its deterministic algorithms, so a run repeats bit for bit."""
    import shutil

    import numpy as np

    from theanompi_torch import dist as tdist
    from theanompi_torch.parallel.rank_jobs import run_all

    _, backend, device, _, _ = bsp_layout(torch)
    n = CKPT_RANKS
    workers = max(1, ((os.cpu_count() or 1) - 2) // n)
    print(f"ckpt conv: {n} ranks, backend {backend}, device {device}, "
          f"{workers} loader workers a rank", flush=True)
    A, B = os.path.join(tmp, "conv-A"), os.path.join(tmp, "conv-B")

    def run(d, n_epochs, what, resume=False):
        job = {"modelfile": "theanompi_torch.models.resnet50",
               "modelclass": "ResNet50",
               "model_config": {**CKPT_CONV_CFG, "n_epochs": n_epochs,
                                "loader_workers": workers},
               "rule_config": {"exch_strategy": "zero1", "seed": 0,
                               "print_freq": 1, "checkpoint_dir": d,
                               "resume": resume,
                               "prefetch_stall_timeout": 600},
               "allow_tf32": False, "deterministic": True}
        t0 = time.perf_counter()
        res = tdist.spawn(run_all, n, backend, device,
                          ([("launch", (job,))],), timeout_s=900)
        codes = [r[0][0] for r in res]
        print(f"ckpt {what}: exit {codes} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(codes == [0] * n, f"ckpt {what}: ranks exited {codes}")
        return res[0][0][2]

    out_a = run(A, 2, "conv A (2 epochs)")
    run(B, 1, "conv B (1 epoch)")
    run(B, 2, "conv C (resume of B to 2 epochs)", resume=True)
    n_leaves = ckpt_same(B, A, "conv")
    with np.load(os.path.join(A, "ckpt_e0001.npz")) as z:
        kinds = {k.split("::")[0] for k in z.files}
        buckets = [k for k in z.files if k.startswith("opt_state::")]
    print(f"ckpt conv: {n_leaves} leaves ({sorted(kinds)}), zero1 buckets "
          f"{len(buckets)}", flush=True)
    check({"params", "state", "opt_state"} <= kinds and buckets,
          "ckpt conv: the checkpoint lacks the BN state or the buckets")
    ckpt_numbers("conv", smi, out_a, A)
    for d in (A, B):
        ckpt_verify_cli(d, 0)
        shutil.rmtree(d, ignore_errors=True)


def ckpt_phase(torch, smi):
    """Phase 8: checkpoint and resume at full width.  -> the transformer's
    resumed run's launches (``train_resume_bf16``)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="ckpt-")
    try:
        launches = ckpt_transformer(torch, smi, tmp)
        torch.cuda.empty_cache()
        ckpt_conv(torch, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# -- phase 9: the rest of the model zoo ----------------------------------------

#: the zoo at the reference's ``default_config`` widths, bf16: (label, module
#: of ``theanompi_torch.models``, class, config over the defaults, what a
#: step's rows are).  Steps are cut to ZOO_STEPS a model (the first holds
#: cuDNN's warm-up) plus one validation batch; widths and depth are whole.
#: The LSTM runs the synthetic stream at PTB's vocabulary (10000).
ZOO = (
    ("AlexNet", "alex_net", "AlexNet", {"batch_size": 128}, "images"),
    ("VGG-16", "vggnet_16", "VGGNet_16", {"batch_size": 64}, "images"),
    ("GoogLeNet", "googlenet", "GoogLeNet",
     {"batch_size": 32, "aux": True}, "images"),
    ("PTB LSTM", "lstm", "LSTM", {"batch_size": 32, "vocab": 10000},
     "tokens"),
    ("DCGAN", "dcgan", "DCGAN", {"batch_size": 64}, "images"),
    ("WGAN", "dcgan", "WGAN", {"batch_size": 64}, "images"),
)
ZOO_STEPS = 6
#: the card-against-CPU step (fp32, TF32 off, dropout 0 on both devices),
#: from freshly seeded weights and from the bf16 run's checkpoint (its fp32
#: master weights, state and optimizer state): the batch, and (loss, grad
#: norm or the GAN's generator loss, new state, update) relative
#: tolerances, phase 5's.  The CPU's runs take the card's branch at every
#: ReLU and max-pool (:class:`_Branches`): at a kink, an input within
#: rounding of 0 or a near-tie, fp32 runs may take either branch (cuDNN's
#: default algorithms differ from run to run), and the grads jump by
#: percents; a generator whose RMSProp state is tiny follows the jump (one
#: such leaky-ReLU input in WGAN's critic put the card's update 6.43e-3
#: from the CPU's, 5.1 lr at worst, in some runs: NVIDIA H100 80GB HBM3,
#: 700 W)
ZOO_PARITY_BATCH = {"images": 4, "tokens": 4}
ZOO_PARITY_TOL = (1e-5, 1e-4, 1e-4, 5e-3)
#: every ReLU's and leaky ReLU's input in the first step (the one from the
#: same weights) held to the float64 run's, relative L2 distance at each
#: site: the card's no farther than ZOO_EXACT[0] times the CPU's fp32 one
#: plus this
ZOO_ACT_TOL = 1e-5
#: the step is also held to the same step in float64 on the CPU: the card's
#: update no farther from it than twice the CPU's fp32 update, plus 1e-4
ZOO_EXACT = (2.0, 1e-4)
#: the GAN's losses are held relative to at least this: WGAN's are gaps
#: between means of clipped critics' scores, near 0 (1e-3-1e-5)
ZOO_LOSS_FLOOR = 1e-2
#: the GAN's two steps (across WGAN's ``n_critic`` gate) under its own Adam
#: or RMSProp, the update held per element to ``ZOO_GAN_ATOL * lr`` (the
#: discriminator's at its ``lr * disc_lr_scale``), as in
#: tests/test_torch_zoo_gan.py.  From fresh optimizer state the first step
#: is ``lr * g / |g|`` elementwise: a grad element at the noise level of
#: fp32 sums gets a full-size step whose sign the summation order decides,
#: so at most ZOO_GAN_FLIPS of the elements may differ by more (the CPU's
#: fp32 step differs so from the float64 one too)
ZOO_GAN_ATOL = 2e-2
ZOO_GAN_FLIPS = 1e-4
#: the LSTM layer on the card, ATen's (cuDNN's in fp32) against the plain
#: loop at the model's width: the output's and the grads' relative
#: distances, per dtype (bf16: the two round the gates at other points)
LSTM_FUSED_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _finite(xs) -> bool:
    return all(x == x and abs(x) != float("inf") for x in xs)


def zoo_config(spec, precision, batch, steps):
    """One zoo model's config: the spec's over the defaults, ``steps``
    training batches and one validation batch of ``batch``."""
    _, _, _, over, unit = spec
    cfg = {**over, "precision": precision, "batch_size": batch,
           "n_train": steps * batch, "n_val": batch, "n_epochs": 1}
    if unit == "images" and spec[1] != "dcgan":
        cfg["shard_size"] = batch  # a step reads one synthetic shard
    return cfg


def zoo_run(torch, smi, spec, kernels, tmp):
    """One zoo model in bf16 through the launcher (``python -m
    theanompi_torch.launcher``'s ``main``, in this process), the five
    kernels' counts zeroed just before and read just after; the step
    times from the recorder's histories (``--record-dir``), the trained
    state from the checkpoint it wrote (``--checkpoint-dir``, the
    reference's leaves).  -> (launches, row, the checkpoint's leaves)."""
    import statistics

    import numpy as np

    from theanompi_torch.launcher import main as launch
    from theanompi_torch.utils.recorder import Recorder

    label, mod, cls, over, unit = spec
    batch = over["batch_size"]
    cfg = zoo_config(spec, "bf16", batch, ZOO_STEPS)
    record = os.path.join(tmp, mod + cls)
    argv = ["--modelfile", f"theanompi_torch.models.{mod}", "--modelclass",
            cls, "--rule-set", "print_freq=1", "--rule-set", "prefetch=0",
            "--record-dir", record, "--checkpoint-dir", record, "--quiet"]
    for k, v in cfg.items():
        argv += ["--set", f"{k}={v!r}"]
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    code = launch(argv)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check(code == 0, f"zoo[{label}]: the launcher exited {code}")
    rec = Recorder(verbose=False)
    rec.load(record)
    losses = rec.train_history["cost"]
    calc, wait = rec.time_history["calc"], rec.time_history["wait"]
    p50 = statistics.median(calc)
    rows = batch * (cfg.get("seq_len", 35) if unit == "tokens" else 1)
    val = {k: v[-1] for k, v in rec.val_history.items()}
    row = {"model": label, "batch": batch,
           "step_ms_p50": p50 * 1e3, f"{unit}/s": rows / p50,
           "wait_ms_p50": statistics.median(wait) * 1e3,
           "peak_GiB": peak_gb}
    print(f"zoo[{label}] bf16 {smi}: batch {batch}, launcher exit {code}, "
          f"losses={losses} step_ms={[round(x * 1e3, 3) for x in calc]} "
          f"step_ms_p50={p50 * 1e3:.3f} {unit}/s={rows / p50:.1f} "
          f"wait_ms_p50={row['wait_ms_p50']:.3f} (the host data plane, "
          f"outside the step) val={val} peak memory {peak_gb:.2f} GiB; "
          f"launches of the five kernels {launches}", flush=True)
    check(len(losses) == ZOO_STEPS and _finite(losses),
          f"zoo[{label}]: losses {losses}")
    check(val and _finite(val.values()), f"zoo[{label}]: validation {val}")
    check(not any(launches.values()),
          f"zoo[{label}]: the zoo's path launched {launches}")
    with np.load(os.path.join(record, "ckpt_e0000.npz")) as f:
        saved = {k: f[k] for k in f.files if "::" in k}
    return launches, row, saved


def _zoo_parity_model(spec):
    """The model at the parity batch, fp32, dropout 0 (GoogLeNet's aux
    heads hard-code 0.7), and its batch."""
    from theanompi_torch.ops.layers import Dropout
    from theanompi_torch.utils.helper_funcs import import_model

    _, mod, cls, _, unit = spec
    b = 8 if mod == "dcgan" else ZOO_PARITY_BATCH[unit]
    cfg = zoo_config(spec, "fp32", b, 1)
    cfg["dropout"] = 0.0
    model = import_model(f"theanompi_torch.models.{mod}", cls)(cfg)
    for net in (getattr(model, "net", None), getattr(model, "gen", None),
                getattr(model, "disc", None)):
        for m in (net.modules() if net is not None else ()):
            if isinstance(m, Dropout):
                m.rate = 0.0
    return model, next(iter(model.data.train_batches(b, 0)))


class _Branches:
    """While on (the parity runs only), records every ReLU's and leaky
    ReLU's input and every max-pool's argmax; with ``replay``, another
    run's records, it also takes that run's branch at each: the same side
    of 0 at each activation, the same argmax at each pool.  At a kink (an
    input within rounding of 0, a near-tie) two fp32 runs of one step may
    take other branches, and then their grads differ by the kink's jump,
    not by rounding; on one set of branches they differ by rounding only."""

    SLOPE = {"relu": 0.0, "leaky_relu": 0.2}

    def __init__(self, replay=None):
        self.rec, self.replay = [], replay
        self.first = None  # the records of the first step (None: all)

    def __enter__(self):
        import torch
        import torch.nn.functional as F

        from theanompi_torch.ops import layers as L

        self.acts, self.pool = dict(L.ACTIVATIONS), L.MaxPool.forward
        rec, replay, acts, pool = self.rec, self.replay, self.acts, self.pool

        def wrap(kind):
            def act(x):
                rec.append(("act", x.detach().double().cpu()))
                if replay is None:
                    return acts[kind](x)
                side = replay.rec[len(rec) - 1][1].to(x.device) > 0
                return torch.where(side, x, self.SLOPE[kind] * x)
            return act

        def maxpool(layer, params, x):
            padded, sym = L._pad(x, layer._pads(x.shape[2:]),
                                 value=float("-inf"))
            idx = F.max_pool2d(padded.detach(), layer.window, layer.stride,
                               sym, return_indices=True)[1]
            rec.append(("pool", idx.cpu()))
            if replay is None:
                return pool(layer, params, x)
            idx = replay.rec[len(rec) - 1][1].to(x.device)
            return padded.flatten(2).gather(2, idx.flatten(2)).view(
                idx.shape)

        L.ACTIVATIONS.update({k: wrap(k) for k in self.SLOPE})
        L.MaxPool.forward = maxpool
        return self

    def __exit__(self, *exc):
        from theanompi_torch.ops import layers as L

        L.ACTIVATIONS.update(self.acts)
        L.MaxPool.forward = self.pool

    def against(self, exact):
        """-> (the kinks at which this run's branch is not the one that
        ``exact``'s own arithmetic gives; the worst relative distance of
        an activation's input in the first step, the one that starts from
        the same weights)."""
        kinks, worst = 0, 0.0
        mine = self.replay.rec if self.replay else self.rec
        for i, ((kind, a), (_, b), (_, m)) in enumerate(zip(
                self.rec, exact.rec, mine, strict=True)):
            if kind == "pool":
                kinks += int((m != b).sum())
                continue
            kinks += int(((m > 0) != (b > 0)).sum())
            if self.first is None or i < self.first:
                worst = max(worst, float((a - b).norm()
                                         / max(float(b.norm()), 1e-30)))
        return kinks, worst


def _zoo_gan_steps(torch, model, optimizer, params, state, opt_state,
                   batch, zs, lr, flat, branches):
    """The GAN's two steps of :func:`_zoo_parity_start` from the draws
    ``zs`` (numpy), the ``n_critic`` gate and the critic's clip checked,
    ``branches`` told where the first step ends: -> [(cost, generator
    loss, new state, {net: update})] a step."""
    from theanompi_torch.tree import tree_leaves_with_path

    def same(a, b):
        return all(torch.equal(x, y) for (_, x), (_, y) in zip(
            tree_leaves_with_path(a), tree_leaves_with_path(b)))

    cfg, label = model.config, type(model).__name__
    x = model.prepare_x(batch["x"])
    like = next(iter(tree_leaves_with_path(params)))[1]
    steps = []
    for step in range(2):
        z1, z2 = (torch.from_numpy(z).to(like.device, like.dtype)
                  for z in zs[2 * step:2 * step + 2])
        new_params, state, new_opt, met = model.gan_step(
            optimizer, params, state, opt_state, x, z1, z2, lr, step)
        if cfg["wgan"]:
            kept = step % cfg["n_critic"] != 0
            check(not kept or (same(new_params["gen"], params["gen"])
                               and same(new_opt["gen"], opt_state["gen"])),
                  f"zoo parity[{label}]: the generator moved at step "
                  f"{step}, inside the n_critic gate")
            check(max(float(p.abs().max()) for _, p in
                      tree_leaves_with_path(new_params["disc"]))
                  <= cfg["clip"], f"zoo parity[{label}]: the critic is "
                  f"not clipped at {cfg['clip']}")
        steps.append((float(met["cost"]), float(met["g_loss"]), flat(state),
                      {k: flat(new_params[k]) - flat(params[k])
                       for k in ("gen", "disc")}))
        params, opt_state = new_params, new_opt
        branches.first = branches.first or len(branches.rec)
    return steps


def _zoo_parity_start(torch, spec, model, optimizer, batch, start, trees):
    """One start of :func:`zoo_parity`: the step (the GAN's two) on the
    card, on the CPU and in float64 on the CPU from ``trees`` (params,
    state, optimizer state), and its checks."""
    import numpy as np

    from theanompi_torch.ops.opt import global_sq_norm
    from theanompi_torch.parallel.mesh import Precision
    from theanompi_torch.parallel.trainer import loss_and_grads
    from theanompi_torch.tree import tree_leaves_with_path, tree_map
    from theanompi_torch.utils.helper_funcs import to_device

    label, cfg = spec[0], model.config
    lr = model.adjust_hyperp(0)
    gan = hasattr(model, "gan_step")
    r = np.random.RandomState(0)
    zs = [r.randn(len(batch["x"]), cfg["z_dim"]).astype(np.float32)
          for _ in range(4)] if gan else []

    def flat(tree):
        return torch.cat([x.double().flatten().cpu()
                          for _, x in tree_leaves_with_path(tree)]
                         or [torch.zeros(0, dtype=torch.float64)])

    out, branches, card = {}, {}, None
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                       ("cpu", torch.float64)):
        model.precision = Precision(dtype)

        def put(tree):
            return tree_map(lambda x: x.to(dev, dtype)
                            if x.is_floating_point() else x.to(dev), tree)

        params, state, opt_state = (put(t) for t in trees)
        b = to_device(batch, dev)
        steps = []
        # the CPU's runs take the card's branches
        with _Branches(replay=card) as branches[dev, dtype]:
            if gan:
                steps = _zoo_gan_steps(torch, model, optimizer, params,
                                       state, opt_state, b, zs, lr, flat,
                                       branches[dev, dtype])
            else:
                new_state, met, grads = loss_and_grads(model, params, state,
                                                       b, None)
                with torch.no_grad():
                    new_params, _ = optimizer.update(grads, opt_state,
                                                     params, lr)
                steps.append((float(met["cost"]),
                              float(torch.sqrt(global_sq_norm(grads))),
                              flat(new_state),
                              flat(new_params) - flat(params)))
        out[dev, dtype] = steps
        card = card or branches[dev, dtype]
    host, exact = (branches[k] for k in list(out)[1:])
    kinks, act_c = card.against(exact)
    act_h = host.against(exact)[1]
    (c_runs, h_runs, e_runs) = out.values()
    floor = ZOO_LOSS_FLOOR if gan else 0.0
    for step, (c, h, e) in enumerate(zip(c_runs, h_runs, e_runs)):
        (lc, gc, sc, uc), (lh, gh, sh, uh), (_, _, _, ue) = c, h, e
        d = [abs(lc - lh) / max(abs(lh), floor),
             abs(gc - gh) / max(abs(gh), floor),
             float((sc - sh).norm() / sh.norm()) if sh.numel() else 0.0]
        if gan:
            uc, uh, ue = (torch.cat([u["gen"], u["disc"]])
                          for u in (uc, uh, ue))
            # each element against its net's lr
            n_gen = c[3]["gen"].numel()
            scale = torch.full_like(uc, lr * cfg["disc_lr_scale"])
            scale[:n_gen] = lr
            off = (uc - uh).abs() / scale
            off_exact = int(((uh - ue).abs() / scale > ZOO_GAN_ATOL).sum())
            n_off = int((off > ZOO_GAN_ATOL).sum())
            allowed = int(ZOO_GAN_FLIPS * uc.numel()) if start == "fresh" \
                else 0
        d.append(float((uc - uh).norm() / max(float(uh.norm()), 1e-30)))
        exact_c = float((uc - ue).norm() / ue.norm())
        exact_h = float((uh - ue).norm() / ue.norm())
        what = "generator loss" if gan else "grad norm"
        line = (f"zoo parity[{label}, fp32, {start}"
                + (f", step {step}" if gan else "") + f"] batch "
                f"{len(batch['x'])}, card against CPU: loss {lc:.7g} / "
                f"{lh:.7g} (rel {d[0]:.3g}, tol {ZOO_PARITY_TOL[0]:g}); "
                f"{what} {gc:.7g} / {gh:.7g} (rel {d[1]:.3g}, tol "
                f"{ZOO_PARITY_TOL[1]:g}); state |card-cpu|/|cpu| {d[2]:.3g} "
                f"(tol {ZOO_PARITY_TOL[2]:g}); update {d[3]:.3g} (tol "
                f"{ZOO_PARITY_TOL[3]:g}); update against the float64 CPU "
                f"step: card {exact_c:.3g}, CPU fp32 {exact_h:.3g}; kinks "
                f"where the card's branch, which the CPU's runs take, is "
                f"not float64's: {kinks}; activations' inputs against it "
                f"(first step): card {act_c:.3g}, CPU {act_h:.3g}")
        if gan:
            line += (f"; max |card-cpu| / lr {float(off.max()):.3g}, "
                     f"elements beyond {ZOO_GAN_ATOL:g} lr: {n_off} of "
                     f"{uc.numel()} (allowed {allowed}; CPU fp32 against "
                     f"float64: {off_exact})")
        print(line, flush=True)
        check(all(x <= t for x, t in zip(d, ZOO_PARITY_TOL)),
              f"zoo parity[{label}, {start}]: the card's step differs from "
              f"the CPU's")
        check(act_c <= ZOO_EXACT[0] * act_h + ZOO_ACT_TOL, f"zoo parity["
              f"{label}, {start}]: an activation's input is farther from the "
              f"float64 run's than the CPU's fp32 one")
        check(exact_c <= ZOO_EXACT[0] * exact_h + ZOO_EXACT[1],
              f"zoo parity[{label}, {start}]: the "
              f"card's step is farther from the float64 step than the "
              f"CPU's fp32 one")
        if gan:
            check(n_off <= allowed, f"zoo parity[{label}, {start}, step "
                  f"{step}]: {n_off} update elements beyond "
                  f"{ZOO_GAN_ATOL:g} lr")


def zoo_parity(torch, spec, saved):
    """The fp32 step (the GAN's two, across WGAN's ``n_critic`` gate, with
    the same ``z``) on the card, on the CPU and in float64 on the CPU,
    from freshly seeded weights and from the bf16 run's checkpoint
    (``saved``, its leaves): loss, grad norm (the GAN: its generator
    loss), new state, the update and the activations' inputs, the CPU's
    runs on the card's branches.  -> the model's param count."""
    from theanompi_torch.convert import train_state_from_jax
    from theanompi_torch.tree import tree_leaves_with_path

    model, batch = _zoo_parity_model(spec)
    optimizer = model.build_optimizer()
    weights, model_state = model.init_params(torch.Generator())
    fresh = (weights, model_state,
             model.init_opt_state(optimizer, weights))
    restored = train_state_from_jax(saved, dict(zip(
        ("params", "state", "opt_state"), fresh)))
    for start, trees in (("fresh", fresh), ("trained", tuple(
            restored[k] for k in ("params", "state", "opt_state")))):
        _zoo_parity_start(torch, spec, model, optimizer, batch, start,
                          trees)
    return sum(x.numel() for _, x in tree_leaves_with_path(weights))


def zoo_lstm_layer(torch, smi):
    """The LSTM layer at the PTB model's width (B 32, T 35, 650 -> 650)
    on the card: :func:`lstm_fused` (ATen's LSTM; cuDNN's in fp32)
    against :func:`lstm_loop`, forward and grads, and both timed
    (forward + backward, CUDA events)."""
    from theanompi_torch.ops.layers import lstm_fused, lstm_loop

    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device="cuda")
                    * scale).to(dtype).requires_grad_()

        x = rand(32, 35, 650)
        ws = (rand(650, 2600, scale=0.04), rand(650, 2600, scale=0.04),
              rand(2600, scale=0.1))
        gy = torch.randn((32, 35, 650), generator=g, device="cuda").to(dtype)
        outs, ms = [], {}
        for fn in (lstm_fused, lstm_loop):
            def run(fn=fn):
                y = fn(x, *ws)
                return [y] + list(torch.autograd.grad(y, [x, *ws], gy))

            outs.append([t.float() for t in run()])
            ms[fn.__name__] = time_ms(run, iters=10)
        rel = [float((a - b).norm() / b.norm()) for a, b in zip(*outs)]
        tol = LSTM_FUSED_TOL[_dname(dtype)]
        print(f"zoo lstm layer[{_dname(dtype)}] {smi}: B=32 T=35 D=H=650, "
              f"fused against the loop, rel (out, dx, dwx, dwh, db) "
              f"{[f'{v:.3g}' for v in rel]} (tol {tol:g}); forward + "
              f"backward ms: fused {ms['lstm_fused']:.4f}, loop "
              f"{ms['lstm_loop']:.4f}", flush=True)
        check(max(rel) <= tol, f"zoo lstm layer[{_dname(dtype)}]: the fused "
              f"LSTM differs from the loop ({rel})")


def zoo_phase(torch, smi, kernels):
    """Phase 9: the LSTM layer's two paths, then each zoo model in bf16
    at full width through the launcher and its fp32 card-against-CPU
    step.  -> the runs' summed launches (``train_zoo_bf16``)."""
    import gc

    import shutil
    import tempfile

    zoo_lstm_layer(torch, smi)
    total = {k.name: 0 for k in kernels}
    rows = []
    tmp = tempfile.mkdtemp(prefix="zoo-")
    try:
        for spec in ZOO:
            launches, row, saved = zoo_run(torch, smi, spec, kernels,
                                           tmp)
            for k, v in launches.items():
                total[k] += v
            rows.append(row)
            gc.collect()
            torch.cuda.empty_cache()
            row["params_M"] = zoo_parity(torch, spec, saved) / 1e6
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("zoo table " + json.dumps(rows), flush=True)
    return total


# -- phase 10: serving what the launcher trained ---------------------------------

#: phase 8's transformer (phase 4's at full width, bf16, 3 steps an epoch,
#: 1 validation batch), trained 2 epochs through the launcher; epoch 0 is
#: served, epoch 1 is the rollout's candidate
SERVE_CKPT_EPOCHS = 2
#: the rollout drive: the swap after this many decode steps of phase 3's
#: traffic (8 sequences active), then 8 requests more at the new weights
SWAP_AT_STEP = 8
#: queue replica: requests of 100-400 tokens, 16 new tokens each
QUEUE_REQUESTS = 8
#: the SIGTERM drain's budget
DRAIN_S = 20.0
#: card bytes an idle engine may differ by after a swap and its rollback
SWAP_MEM_SLACK = 1 << 20


def _copy_epoch(src, dst, epoch, as_epoch=None):
    """Publish ``src``'s epoch into ``dst`` the writer's way: the ``.npz``
    first, then its manifest (what the rollout discovers), each through a
    temporary name and ``os.replace``."""
    import shutil

    as_epoch = epoch if as_epoch is None else as_epoch
    for ext in (".npz", ".manifest.json"):
        tmp = os.path.join(dst, f"incoming{ext}")
        shutil.copy(os.path.join(src, f"ckpt_e{epoch:04d}{ext}"), tmp)
        os.replace(tmp, os.path.join(dst, f"ckpt_e{as_epoch:04d}{ext}"))


def _serving_argv():
    return [a for k, v in CKPT_TRAIN_CFG.items()
            for a in ("--set", f"{k}={v!r}")]


def _engine_snapshot(params):
    """Each leaf of an engine tree, copied on the card (bf16 engine: no
    int8 leaves)."""
    from theanompi_torch.tree import tree_leaves_with_path

    return {"/".join(map(str, p)): x.clone()
            for p, x in tree_leaves_with_path(params)}


def serve_rollout(torch, smi, kernels, src, d):
    """In-process: the engine serves epoch 0 of ``d`` on the kernel path; a
    ``RolloutManager`` adopts epoch 1 in the middle of phase 3's traffic
    (the active sequences preempted and replayed), 8 further requests
    run at the new weights and are held against the plain path; a
    candidate with a leaf's byte flipped is refused while epoch 1 keeps
    serving; an injected critical verdict rolls back to epoch 0's tree bit
    for bit, and the card's allocated bytes come back to what they were.
    -> the launches of the drive (``serve_rollout_bf16``)."""
    import numpy as np

    from theanompi_torch.models.transformer_lm import TransformerLM
    from theanompi_torch.serving import (
        InferenceEngine,
        RolloutManager,
        Scheduler,
        run_open_loop,
    )
    from theanompi_torch.serving.cli import build_parser, synthetic_requests
    from theanompi_torch.utils.checkpoint import load_for_inference

    args = build_parser().parse_args(_serving_argv() + SERVE_ARGS)
    cfg = dict(CKPT_TRAIN_CFG)
    model = TransformerLM(cfg)
    template, _ = model.init_params(torch.Generator().manual_seed(0))
    ep0, _, trees = load_for_inference(d, {"params": template}, model=model)
    check(ep0 == 0, f"rollout: {d} serves epoch {ep0}")
    geometry = dict(block_size=args.block_size, max_batch=args.max_batch,
                    seed=args.seed)
    engine = InferenceEngine(model, trees["params"], **geometry)
    sched = Scheduler(engine)
    first = engine.params
    before = _engine_snapshot(first)
    clock = [0.0]
    verdicts = []
    mgr = RolloutManager(engine, d, {"params": template}, model=model,
                         verify="full", current_epoch=0, poll_s=0.0,
                         probation_s=3600.0,
                         health_verdicts=lambda: verdicts,
                         clock=lambda: clock[0])
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    _copy_epoch(src, d, 1)
    swap = {}

    def between(s):
        if "ms" not in swap and s.n_steps == SWAP_AT_STEP:
            swap["active"] = s.n_active
            t0 = time.perf_counter()
            swap["outcome"] = mgr.poll(s)
            torch.cuda.synchronize()
            swap["ms"] = (time.perf_counter() - t0) * 1e3

    reqs = synthetic_requests(
        args.requests, model.vocab, args.prompt_len, args.max_new_tokens,
        0.0, args.seed, turns=args.turns)
    after = synthetic_requests(
        8, model.vocab, args.prompt_len, args.max_new_tokens, 0.0,
        args.seed + 1)
    for r in after:
        r.rid += len(reqs)
    for k in kernels:
        k.launches = 0
    res_a, wall_a = run_open_loop(sched, reqs, between_steps=between)
    res_b, wall_b = run_open_loop(sched, after)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    check(swap.get("outcome") == "rollout" and mgr.current_epoch == 1,
          f"rollout: epoch 1 not adopted ({swap}, serving epoch "
          f"{mgr.current_epoch})")
    check(sched.n_preemptions >= swap["active"] > 0, f"rollout: "
          f"{swap['active']} active at the swap, {sched.n_preemptions} "
          f"preempted")
    served = list(res_a.values()) + list(res_b.values())
    check(len(served) == len(reqs) + len(after)
          and all(r.state == "done" for r in served),
          "rollout: not every request done across the swap")
    for name in ("flash_fwd", "paged_decode"):
        check(launches[name] > 0, f"rollout: {name} never launched on the "
              f"swapped weights ({launches})")
    n_tok = sum(len(r.generated) for r in served)
    print(f"serve_rollout {smi}: adopted epoch 1 at decode step "
          f"{SWAP_AT_STEP} with {swap['active']} active (preempted "
          f"{sched.n_preemptions}); swap host ms (poll: full verify, load, "
          f"to the card, preempt) {swap['ms']:.3f}; {n_tok} tokens in "
          f"{wall_a + wall_b:.3f} s; decode_step_ms p50 "
          f"{float(np.percentile(sched.step_ms, 50)):.3f}; launches "
          f"{launches}", flush=True)

    # the kernel path against the plain path at the new weights
    _, _, new = load_for_inference(d, {"params": template}, model=model)
    plain = InferenceEngine(TransformerLM({**cfg, "attn_impl": "blockwise"}),
                            new["params"], decode_kernel="off", **geometry)
    check(_same_weights(engine.params, plain.params),
          "rollout: the engine does not serve epoch 1's weights")
    serve_parity("rollout bf16", "bf16", engine, plain,
                 [res_b[r.rid] for r in after], args.max_new_tokens)
    del plain, new

    # a candidate with one leaf byte flipped: refused, epoch 1 serves on
    _copy_epoch(src, d, 1, as_epoch=2)
    flip_leaf_byte(os.path.join(d, "ckpt_e0002.npz"), "params::head/w.npy")
    swapped = engine.params
    check(mgr.poll(sched) == "refused" and mgr.n_refused == 1
          and engine.params is swapped and mgr.current_epoch == 1,
          "rollout: the flipped candidate was not refused")
    check(os.path.exists(os.path.join(d, "ckpt_e0002.npz"))
          and not os.path.exists(os.path.join(d, "corrupt")),
          "rollout: the refused candidate was moved")
    res_c, _ = run_open_loop(sched, synthetic_requests(
        2, model.vocab, args.prompt_len, 8, 0.0, args.seed + 2))
    check(all(r.state == "done" for r in res_c.values()),
          "rollout: serving stopped after the refusal")

    # a critical verdict inside probation: back to epoch 0, bit for bit
    verdicts.append({"detector": "slo", "severity": "critical"})
    clock[0] = 1.0
    t0 = time.perf_counter()
    check(mgr.poll(sched) == "rollback" and mgr.current_epoch == 0,
          "rollout: the critical verdict did not roll back")
    torch.cuda.synchronize()
    back_ms = (time.perf_counter() - t0) * 1e3
    got = _engine_snapshot(engine.params)
    same = engine.params is first and all(
        torch.equal(before[k], got[k]) for k in before)
    del swapped, got
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    print(f"serve_rollout {smi}: refused the flipped epoch 2 "
          f"(n_refused {mgr.n_refused}); rolled back to epoch 0 in "
          f"{back_ms:.3f} host ms, bit-equal {same}; card allocated bytes "
          f"{mem0} before the swap, {mem1} after the rollback", flush=True)
    check(same, "rollout: the rollback did not restore epoch 0's tree")
    check(abs(mem1 - mem0) <= SWAP_MEM_SLACK, f"rollout: {mem1 - mem0} "
          f"bytes of the card still held after the rollback")
    return launches


def _serve_child(argv, log):
    """``python -m theanompi_torch.serving`` from the checkout."""
    return subprocess.Popen(
        [sys.executable, "-m", "theanompi_torch.serving", *argv],
        cwd=HERE, env={**os.environ, "PYTHONPATH": HERE},
        stdout=subprocess.PIPE, stderr=open(log, "w"), text=True)


def serve_children(torch, smi, d, tmp):
    """Two replicas as processes of their own, at once: one serves a
    queue file to its drain sentinel, each rid recorded exactly once; the
    other serves synthetic traffic and takes SIGTERM, and must drain and
    exit 0 within ``DRAIN_S``."""
    import numpy as np

    from theanompi_torch.serving.lifecycle import (
        append_queue,
        request_drain,
        terminal_records,
    )

    q = os.path.join(tmp, "replica", "queue.jsonl")
    rng = np.random.RandomState(3)
    append_queue(q, [{"rid": i, "max_new_tokens": 16, "enq_wall": time.time(),
                      "prompt": [int(x) for x in rng.randint(
                          0, CKPT_TRAIN_CFG["vocab"], 100 * (1 + i % 4))]}
                     for i in range(QUEUE_REQUESTS)])
    request_drain(q)
    sig_log = os.path.join(tmp, "sigterm-REQUESTS.jsonl")
    base = _serving_argv() + ["--checkpoint-dir", d, "--max-batch", "8",
                              "--block-size", "16"]
    children = {
        "queue": _serve_child(base + ["--queue-file", q],
                              os.path.join(tmp, "queue.err")),
        "sigterm": _serve_child(
            base + ["--requests", "256", "--prompt-len", "200",
                    "--max-new-tokens", "64", "--requests-log", sig_log,
                    "--drain-s", str(DRAIN_S)],
            os.path.join(tmp, "sigterm.err"))}
    try:
        deadline = time.monotonic() + 300
        while not terminal_records(sig_log):
            check(children["sigterm"].poll() is None, "sigterm replica "
                  "exited before serving")
            check(time.monotonic() < deadline, "sigterm replica never "
                  "served a request")
            time.sleep(0.1)
        t0 = time.perf_counter()
        children["sigterm"].send_signal(signal.SIGTERM)
        out_s, _ = children["sigterm"].communicate(timeout=DRAIN_S + 60)
        drain_s = time.perf_counter() - t0
        out_q, _ = children["queue"].communicate(timeout=300)
    finally:
        for k, c in children.items():
            if c.poll() is None:
                c.kill()
                c.communicate(timeout=60)
            if c.returncode:
                with open(os.path.join(tmp, f"{k}.err")) as f:
                    print(f"serve child {k} exited {c.returncode}: "
                          f"{f.read()[-3000:]}", flush=True)
    codes = {k: c.returncode for k, c in children.items()}
    check(codes == {"queue": 0, "sigterm": 0}, f"serve children exited "
          f"{codes}")
    rep_q = json.loads(out_q.strip().splitlines()[-1])
    rids = [r["rid"] for r in terminal_records(
        os.path.join(tmp, "replica", "REQUESTS.jsonl"))]
    print(f"serve_queue {smi}: exit 0 on the drain sentinel, "
          f"{rep_q['terminal_states']}, tokens/s {rep_q['value']}, "
          f"ttft_ms {rep_q['ttft_ms']}, rids logged {sorted(rids)}",
          flush=True)
    check(sorted(rids) == list(range(QUEUE_REQUESTS))
          and rep_q["terminal_states"]["done"] == QUEUE_REQUESTS
          and rep_q["checkpoint_epoch"] == 0,
          "serve_queue: not every rid recorded exactly once")
    rep_s = json.loads(out_s.strip().splitlines()[-1])
    print(f"serve_sigterm {smi}: exit 0 {drain_s:.3f} s after SIGTERM "
          f"(--drain-s {DRAIN_S}), drained {rep_s['drained']}, "
          f"{rep_s['terminal_states']}", flush=True)
    check(rep_s["drained"] and drain_s <= DRAIN_S
          and sum(rep_s["terminal_states"].values()) == 256,
          "serve_sigterm: the drain did not end clean within --drain-s")


def serve_ckpt_phase(torch, smi, kernels):
    """Phase 10: the transformer trained through the launcher and served
    from its checkpoint directory.  -> the launches of the three serving
    paths (``serve_ckpt_bf16``, ``serve_ckpt_int8``,
    ``serve_rollout_bf16``)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="serve-ckpt-")
    try:
        src = os.path.join(tmp, "trained")
        t0 = time.perf_counter()
        ckpt_launcher(["--modelfile", "theanompi_torch.models.transformer_lm",
                       "--modelclass", "TransformerLM", *_serving_argv(),
                       "--set", f"n_epochs={SERVE_CKPT_EPOCHS}",
                       "--checkpoint-dir", src], "serve-ckpt train")
        d = os.path.join(tmp, "served")
        os.makedirs(d)
        _copy_epoch(src, d, 0)
        out = {}
        for quant in (False, True):
            out["serve_ckpt_int8" if quant else "serve_ckpt_bf16"] = \
                serve_run(torch, "bf16", quant, smi, kernels, ckpt=d)[0]
            torch.cuda.empty_cache()
        serve_children(torch, smi, d, tmp)
        out["serve_rollout_bf16"] = serve_rollout(torch, smi, kernels, src,
                                                  d)
        print(f"serve_ckpt phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


# -- phase 11: the async rules ------------------------------------------------

ASYNC_STEPS = 4
#: the transformer at phase 4's config in bf16, global batch 16 (N x 16/N),
#: 4 steps and one validation batch
ASYNC_TRAIN_CFG = {**TRAIN_CFG, "precision": "bf16",
                   "n_train": ASYNC_STEPS * TRAIN_CFG["batch_size"],
                   "n_val": TRAIN_CFG["batch_size"]}
#: ResNet-50 at phase 5's config in bf16, global batch 256 (N x 256/N, in
#: shards of 128), 4 steps and one validation batch; each worker keeps its
#: own BN state (no sync-BN under an async rule)
ASYNC_CONV_CFG = {**BSP_CONV_CFG, "precision": "bf16",
                  "n_train": ASYNC_STEPS * CONV_CFG["batch_size"]}
#: (model, rule, rule config, the step after which the first exchange has
#: run): EASGD τ 2 exchanges after steps 2 and 4; GOSGD at p_push 1 has
#: every worker push after every step
ASYNC_RUNS = (("transformer", "EASGD", {"tau": 2}, 2),
              ("transformer", "GOSGD", {"p_push": 1.0}, 1),
              ("resnet50", "EASGD", {"tau": 2}, 2))
ASYNC_MODELS = {"transformer": (ASYNC_TRAIN_CFG,
                                "theanompi_torch.models.transformer_lm",
                                "TransformerLM"),
                "resnet50": (ASYNC_CONV_CFG,
                             "theanompi_torch.models.resnet50", "ResNet50")}
#: the ranks against the one-process emulation (bf16 on both): phase 4's
#: bf16 limits, (loss, -, update) relative; the emulation runs the same
#: kernels on the same inputs, but the exchange's sums are the collective's
#: (gloo stages them through the host) against plain tensor ops
ASYNC_EMU_TOL = PARITY_TOL["bf16"]
#: LocalSGD τ 1 against BSP ``psum`` on the same ranks: the transformer in
#: fp32, plain SGD (no momentum, weight decay or clipping, under which an
#: average of the workers' updates is the update of the averaged grads),
#: 3 steps.  The loss within phase 6's fp32 limit.  The params: LocalSGD
#: rounds each worker's ``p - lr g_r`` to fp32 before the average, BSP
#: only ``p - lr mean(g)``, so the two differ by a few ulps of each param a
#: step, which is a large share of the update where it is small (6.7e-4 of
#: the update's norm here on an NVIDIA H100, growing with depth).  So the
#: params' distance is held within
#: ``ASYNC_LSGD_ULPS`` units of fp32 roundoff of their norm (the rounding
#: of one step is about half a unit an element, three steps of two
#: roundings each under 4 units in norm) plus phase 6's update limit of
#: the update's norm
ASYNC_LSGD_ULPS = 8
ASYNC_LSGD_STEPS = 3
ASYNC_LSGD_CFG = {**TRAIN_CFG, "precision": "fp32", "momentum": 0.0,
                  "weight_decay": 0.0, "grad_clip": None,
                  "n_train": ASYNC_LSGD_STEPS * TRAIN_CFG["batch_size"],
                  "n_val": TRAIN_CFG["batch_size"]}
ASYNC_LSGD_TOL = BSP_TOL[("transformer", "fp32")]
#: ResNet-50 ``remat="save_convs"`` against ``"none"``: phase 5's config in
#: bf16 at batch 256, one process, 2 steps, cuDNN's deterministic
#: algorithms; phase 5's limits (loss, grad norm, update, BN state)
REMAT_STEPS = 2
REMAT_TOL = CONV_PARITY_TOL


def _vec(torch, tree):
    """``tree``'s leaves as one float64 vector on the host."""
    from theanompi_torch.tree import tree_leaves_with_path

    return torch.cat([x.detach().double().flatten().cpu()
                      for _, x in tree_leaves_with_path(tree)])


def _rel(torch, a, b) -> float:
    """|a - b| / |b| of two vectors."""
    return float((a - b).norm() / b.norm())


def async_emulate(torch, model, rule, rcfg, n, device, save_step):
    """The async rule's N workers in turn in this process from the same
    init and batches as the ranks, with the exchange in plain tensor ops.
    -> (each worker's params after ``save_step``, the init params, the
    center (EASGD) or the weights (GOSGD) after the last step, the
    validation cost on ``eval_args``'s trees)."""
    from theanompi_torch.parallel.gosgd import round_draws
    from theanompi_torch.parallel.trainer import make_train_step
    from theanompi_torch.tree import tree_map, tree_to
    from theanompi_torch.utils.helper_funcs import import_model, to_device

    cfg, mfile, mclass = ASYNC_MODELS[model]
    b = cfg["batch_size"] // n
    m = import_model(mfile, mclass)({**cfg, "batch_size": b,
                                     "verbose": False})
    if rule == "EASGD" and n > 1 and rcfg.get("scale_lr", True):
        m.scale_lr(n)
    opt = m.build_optimizer()
    p0, s0 = m.init_params(torch.Generator().manual_seed(1))
    p0, s0 = tree_to(p0, device), tree_to(s0, device)
    workers = [[p0, s0, m.init_opt_state(opt, p0)] for _ in range(n)]
    step = make_train_step(m, opt, None, 0, device)
    lr = m.adjust_hyperp(0)
    tau, alpha = rcfg.get("tau", 4), rcfg.get("alpha") or 0.9 / n
    p_push = rcfg.get("p_push") or 1.0 / max(n, 2)
    center = p0
    weights = [torch.full((), 1.0 / n, dtype=torch.float32, device=device)
               for _ in range(n)]
    saved = None
    gen = m.data.train_batches(b * n, 0, seed=0)
    for i, batch in zip(range(1, ASYNC_STEPS + 1), gen):
        for r, w in enumerate(workers):
            rows = to_device({k: v[r * b:(r + 1) * b]
                              for k, v in batch.items()}, device)
            w[:] = step(*w, rows, lr, i - 1)[:3]
        with torch.no_grad():
            if rule == "EASGD" and i % tau == 0:
                diffs = [tree_map(torch.sub, w[0], center) for w in workers]
                total = tree_map(lambda *d: sum(d[1:], d[0]), *diffs)
                for w, d in zip(workers, diffs):
                    w[0] = tree_map(lambda p, x: p - alpha * x, w[0], d)
                center = tree_map(lambda c, t: c + alpha * t, center, total)
            elif rule == "GOSGD":
                push, shift = round_draws(0, i, n, p_push)
                if push.any():
                    sent = [float(push[r]) * weights[r] * 0.5
                            for r in range(n)]
                    merged = []
                    for r in range(n):
                        src, kept = (r - shift) % n, weights[r] - sent[r]
                        nw = kept + sent[src]
                        merged.append((tree_map(
                            lambda x, y, k=kept, s=sent[src], nw=nw:
                            ((k * x.float() + s * y.float()) / nw).to(
                                x.dtype), workers[r][0], workers[src][0]),
                            nw))
                    for r, (p, nw) in enumerate(merged):
                        workers[r][0], weights[r] = p, nw
        if i == save_step:
            saved = [w[0] for w in workers]
    gen.close()
    with torch.no_grad():
        state = tree_map(lambda *s: sum(s[1:], s[0]) / n,
                         *[w[1] for w in workers])
        if rule == "EASGD":
            params = center
        else:
            params = tree_map(
                lambda *p: sum(weights[r] * p[r].float()
                               for r in range(n)).to(p[0].dtype),
                *[w[0] for w in workers])
        vb = min(b * n, m.data.n_val)
        costs = []
        for batch in m.data.val_batches(vb - vb % n):
            costs.append(sum(float(m.loss_fn(
                params, state, to_device({k: v[r * (vb // n):(r + 1) * (
                    vb // n)] for k, v in batch.items()}, device), None,
                train=False)[1][1]["cost"]) for r in range(n)) / n)
    m.cleanup()
    final = center if rule == "EASGD" else [float(w) for w in weights]
    return saved, p0, final, sum(costs) / len(costs)


def async_check_run(torch, tmp, smi, n, label, model, rule, rcfg, save_step,
                    res, device):
    """Phase 11's checks of one run's ranks, and the run against its
    one-process emulation.  -> its launches summed over the ranks."""
    import statistics

    name = f"{model}-{rule}"
    cfg = ASYNC_MODELS[model][0]
    b = cfg["batch_size"] // n
    r0 = res[0]
    losses = [[m["cost"] for m in r["metrics"]] for r in res]
    check(all(x == x and abs(x) != float("inf") for ls in losses
              for x in ls), f"async {name}: a loss is not finite: {losses}")
    # the workers differ between exchanges: after every local step,
    # before the step's exchange
    check(all(len({r["pre_digests"][i] for r in res}) == n
              for i in range(ASYNC_STEPS)), f"async {name}: the workers' "
          f"params are equal after a local step")
    if rule == "EASGD":
        check(all(len({r["center_digests"][i] for r in res}) == 1
                  for i in range(ASYNC_STEPS)), f"async {name}: the "
              f"center differs across ranks")
        check(all(d > 0 for r in res for d in r["drift"]),
              f"async {name}: no drift before an exchange "
              f"{[r['drift'] for r in res]}")
    else:
        sums = [sum(r["weights"][i] for r in res)
                for i in range(ASYNC_STEPS)]
        check(all(abs(s - 1) <= 1e-6 for s in sums), f"async {name}: the "
              f"weights sum to {sums}")
    launches = [r["launches"] for r in res]
    if model == "transformer":
        want = TRAIN_CFG["n_layers"] * ASYNC_STEPS
        for r, got in enumerate(launches):
            check(all(got[k] == want for k in ("flash_fwd", "flash_bwd_dq",
                                               "flash_bwd_dkv")),
                  f"async {name}: rank {r} launched {got}, expected {want} "
                  f"of each flash kernel")
    else:
        check(not any(v for got in launches for v in got.values()),
              f"async {name}: launched {launches}")
    # against the one-process emulation
    saved, p0, final, val = async_emulate(torch, model, rule, rcfg, n,
                                          device, save_step)
    v0 = _vec(torch, p0)
    upd = []
    for r in range(n):
        mine = torch.load(os.path.join(tmp, f"{name}-r{r}-s{save_step}.pt"))
        upd.append(_rel(torch, _vec(torch, mine["params"]) - v0,
                        _vec(torch, saved[r]) - v0))
    last = torch.load(os.path.join(tmp, f"{name}-r0-s{ASYNC_STEPS}.pt"))
    if rule == "EASGD":
        extra = _rel(torch, _vec(torch, last["center"]) - v0,
                     _vec(torch, final) - v0)
        extra_ok = extra <= ASYNC_EMU_TOL[2]
        extra_s = f"center update rel {extra:.3g} (tol {ASYNC_EMU_TOL[2]:g})"
    else:
        got = [r["weights"][-1] for r in res]
        extra = max(abs(a - b) for a, b in zip(got, final))
        extra_ok = extra <= 1e-6
        extra_s = f"weights {got} against {final} (|diff| {extra:.3g}, tol 1e-6)"
    val_rel = abs(r0["val"]["cost"] - val) / abs(val)
    step50 = statistics.median(r0["step_s"])
    local50 = statistics.median(s - c for s, c in zip(r0["step_s"],
                                                      r0["comm_s"]))
    comm = [c for c in r0["comm_s"] if c > 0]
    comm50 = statistics.median(comm) if comm else 0.0
    per_worker = (b * cfg["seq_len"] if model == "transformer" else b)
    unit = "tokens/s" if model == "transformer" else "images/s"
    print(f"async {model}[bf16] {rule} {rcfg} {smi}: {n} x {b} on {label}; "
          f"gossip transport {r0['transport']}; losses rank 0 "
          f"{losses[0]}; step_ms p50 {step50 * 1e3:.3f} (the exchange "
          f"included where it ran; without it {local50 * 1e3:.3f}); "
          f"exchange (comm) ms p50 "
          f"{comm50 * 1e3:.3f} over {len(comm)} exchanges; {unit} per "
          f"worker {per_worker / step50:.1f}; peak GiB per rank "
          f"{[round(r['peak_bytes'] / 2 ** 30, 2) for r in res]}; "
          f"effective lr {r0['effective_lr']}; launches per rank "
          f"{launches}; against the one-process emulation: params update "
          f"after the first exchange (step {save_step}) rel "
          f"{[round(x, 6) for x in upd]} (tol {ASYNC_EMU_TOL[2]:g}), "
          f"{extra_s}, validation cost on eval_args {r0['val']['cost']:.6g} "
          f"against {val:.6g}, rel {val_rel:.3g} (tol "
          f"{ASYNC_EMU_TOL[0]:g})", flush=True)
    check(all(x <= ASYNC_EMU_TOL[2] for x in upd), f"async {name}: the "
          f"ranks' params differ from the emulation's: {upd}")
    check(extra_ok, f"async {name}: {extra_s}")
    check(val_rel <= ASYNC_EMU_TOL[0], f"async {name}: validation cost "
          f"{r0['val']['cost']} against the emulation's {val}")
    return {k: sum(got[k] for got in launches) for k in launches[0]}


def remat_run(torch, remat, batches, device):
    """ResNet-50 at phase 5's config in bf16, one process: the first
    step's grads, then ``REMAT_STEPS`` trainer steps on ``batches``.
    -> (losses, grads, params before and after, BN state after, peak
    bytes over the steps)."""
    from theanompi_torch import BSP
    from theanompi_torch.parallel.trainer import loss_and_grads
    from theanompi_torch.utils.helper_funcs import to_device

    cfg = {**CONV_CFG, "precision": "bf16", "remat": remat,
           "n_train": REMAT_STEPS * CONV_CFG["batch_size"]}
    tr = BSP({"seed": 0, "verbose": False, "prefetch": 0}).init(
        devices=1, modelfile="theanompi_torch.models.resnet50",
        modelclass="ResNet50", model_config=cfg, device=device).trainer
    p0 = tr.params
    _, _, grads = loss_and_grads(tr.model, tr.params, tr.state,
                                 to_device(batches[0], device), None)
    grads = _vec(torch, grads)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lr = tr.model.adjust_hyperp(0)
    losses = [float(tr.train_iter(b, lr)["cost"]) for b in batches]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = (losses, grads, _vec(torch, p0), _vec(torch, tr.params),
           _vec(torch, tr.state), peak)
    tr.model.cleanup()
    return out


def remat_compare(torch, smi, device):
    """``remat="save_convs"`` against ``"none"``, ResNet-50 bf16 at batch
    256 on one card: loss, the first step's grads, the update and the BN
    state after ``REMAT_STEPS`` steps, and both peaks."""
    import gc

    from theanompi_torch.models.data.imagenet import ImageNetData
    from theanompi_torch.utils.helper_funcs import to_device

    data = ImageNetData({**CONV_CFG, "n_train": REMAT_STEPS
                         * CONV_CFG["batch_size"]})
    gen = data.train_batches(CONV_CFG["batch_size"], 0, seed=0)
    batches = [to_device(b, device) for _, b in zip(range(REMAT_STEPS), gen)]
    gen.close()
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        runs = {}
        for remat in ("none", "save_convs"):
            runs[remat] = remat_run(torch, remat, batches, device)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    (l0, g0, a0, b0, s0, m0), (l1, g1, a1, b1, s1, m1) = (
        runs["none"], runs["save_convs"])
    d = [max(abs(x - y) / abs(x) for x, y in zip(l0, l1)),
         float(abs(g1.norm() - g0.norm()) / g0.norm()),
         _rel(torch, b1 - a1, b0 - a0), _rel(torch, s1, s0)]
    same = (l0 == l1 and torch.equal(g0, g1) and torch.equal(b0, b1)
            and torch.equal(s0, s1))
    print(f"remat ResNet-50[bf16] batch {CONV_CFG['batch_size']} {smi}: "
          f"save_convs against none, {REMAT_STEPS} steps, cuDNN "
          f"deterministic: losses {l1} against {l0}; loss rel {d[0]:.3g} "
          f"(tol {REMAT_TOL[0]:g}), first step's grad norm rel {d[1]:.3g} "
          f"(tol {REMAT_TOL[1]:g}), grads rel "
          f"{_rel(torch, g1, g0):.3g}, update rel {d[2]:.3g} (tol "
          f"{REMAT_TOL[2]:g}), BN state rel {d[3]:.3g} (tol "
          f"{REMAT_TOL[3]:g}); bit-equal: {same}; peak memory over the "
          f"steps: none {m0 / 2 ** 30:.2f} GiB, save_convs "
          f"{m1 / 2 ** 30:.2f} GiB", flush=True)
    check(all(x <= t for x, t in zip(d, REMAT_TOL))
          and _rel(torch, g1, g0) <= REMAT_TOL[2],
          f"remat: save_convs differs from none: {d}")


def async_phase(torch, smi, kernels):
    """Phase 11: EASGD and GOSGD on ranks of a process group at full
    width, each against its one-process emulation; LocalSGD τ 1 against
    BSP ``psum``; ResNet-50's ``save_convs`` against ``none``.  -> each
    transformer run's launches over the ranks (``train_easgd2_bf16``,
    ``train_gosgd2_bf16``)."""
    import gc
    import shutil
    import statistics
    import tempfile

    from theanompi_torch import dist as tdist
    from theanompi_torch.parallel.rank_jobs import run_all

    t_phase = time.perf_counter()
    n, backend, device, _, _ = bsp_layout(torch)
    cards = [str(tdist.rank_device(device, r)) for r in range(n)]
    label = ("a card shared by two ranks, collectives staged through the "
             "host (gloo): not a speed figure" if backend == "gloo" else
             "one card a rank (NCCL)")
    print(f"async: {n} ranks, backend {backend}, rank -> card "
          f"{dict(enumerate(cards))}", flush=True)
    tmp = tempfile.mkdtemp(prefix="async-")
    calls = []
    for model, rule, rcfg, save_step in ASYNC_RUNS:
        cfg, mfile, mclass = ASYNC_MODELS[model]
        calls.append(("async_run", ({
            "rule": rule, "modelfile": mfile, "modelclass": mclass,
            "model_config": {**cfg, "batch_size": cfg["batch_size"] // n},
            "rule_config": {**rcfg, "seed": 0},
            "steps": ASYNC_STEPS, "validate": True, "print_freq": 1,
            "save_at": [save_step, ASYNC_STEPS],
            "out": os.path.join(tmp, f"{model}-{rule}"),
            "allow_tf32": False},)))
    lsgd = {"modelfile": "theanompi_torch.models.transformer_lm",
            "modelclass": "TransformerLM",
            "model_config": {**ASYNC_LSGD_CFG, "batch_size":
                             ASYNC_LSGD_CFG["batch_size"] // n},
            "steps": ASYNC_LSGD_STEPS, "allow_tf32": False}
    calls.append(("async_run", ({**lsgd, "rule": "LocalSGD",
                                 "rule_config": {"tau": 1, "seed": 0},
                                 "save_at": [ASYNC_LSGD_STEPS],
                                 "out": os.path.join(tmp, "lsgd")},)))
    calls.append(("bsp_run", ({**lsgd, "rule_config": {
        "exch_strategy": "psum", "seed": 0, "verbose": False},
        "out": os.path.join(tmp, "bsp"), "save": ["params0", "params"],
        "save_ranks": [0]},)))
    t0 = time.perf_counter()
    res = tdist.spawn(run_all, n, backend, device, (calls,), timeout_s=900)
    print(f"async: the ranks' jobs took {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches_by_path = {}
    for i, (model, rule, rcfg, save_step) in enumerate(ASYNC_RUNS):
        got = async_check_run(torch, tmp, smi, n, label, model, rule, rcfg,
                              save_step, [r[i] for r in res], cards[0])
        if model == "transformer":
            launches_by_path[f"train_{rule.lower()}2_bf16"] = got
        gc.collect()
        torch.cuda.empty_cache()
    # LocalSGD τ 1 against BSP psum: the same init, batches and ranks
    lres = [r[len(ASYNC_RUNS)] for r in res]
    bres = res[0][len(ASYNC_RUNS) + 1]
    bsp = torch.load(os.path.join(tmp, "bsp-r0.pt"))
    mine = torch.load(os.path.join(tmp, f"lsgd-r0-s{ASYNC_LSGD_STEPS}.pt"))
    v0 = _vec(torch, bsp["params0"])
    got, want = _vec(torch, mine["params"]), _vec(torch, bsp["params"])
    upd = _rel(torch, got - v0, want - v0)
    bound = (ASYNC_LSGD_ULPS * 2.0 ** -24 * want.norm()
             + ASYNC_LSGD_TOL[2] * (want - v0).norm())
    worst = float((got - want).norm() / bound)
    mean_loss = [statistics.fmean(r["metrics"][i]["cost"] for r in lres)
                 for i in range(ASYNC_LSGD_STEPS)]
    loss_rel = max(abs(a - m["cost"]) / abs(m["cost"])
                   for a, m in zip(mean_loss, bres["metrics"]))
    print(f"async LocalSGD tau 1 against BSP psum, transformer[fp32] {smi}: "
          f"plain SGD, {ASYNC_LSGD_STEPS} steps, {n} ranks: the workers' "
          f"mean loss {mean_loss} against {[m['cost'] for m in bres['metrics']]}"
          f", rel {loss_rel:.3g} (tol {ASYNC_LSGD_TOL[0]:g}); params update "
          f"after {ASYNC_LSGD_STEPS} steps rel {upd:.3g}; |diff| / "
          f"({ASYNC_LSGD_ULPS} x 2^-24 |params| + {ASYNC_LSGD_TOL[2]:g} "
          f"|update|) {worst:.3g} (limit 1)", flush=True)
    check(loss_rel <= ASYNC_LSGD_TOL[0] and worst <= 1.0,
          f"async: LocalSGD tau 1 differs from BSP psum (loss {loss_rel}, "
          f"params {worst} of their limit)")
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    remat_compare(torch, smi, cards[0])
    print(f"async: phase 11 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches_by_path


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
    check(not torch.backends.cuda.matmul.allow_tf32,
          "fp32 matmuls would run in TF32")

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
                    if any(w in line for w in ("Compiling entry", "registers",
                                               "spill", "wgmma")):
                        print(f"ptxas {f}: {line.strip()}")
    check_hgmma(K)

    # -- phase 2 -----------------------------------------------------------
    if "--conv" in sys.argv[1:]:
        # development run: phase 5 only, no result line
        conv_phase(torch, smi, K.KERNELS)
        return 0
    if "--bsp" in sys.argv[1:]:
        # development run: phase 6 only, no result line
        bsp_phase(torch, smi, K.KERNELS)
        return 0
    if "--data" in sys.argv[1:]:
        # development run: phase 7 only, no result line
        data_phase(torch, smi, K.KERNELS)
        return 0
    if "--ckpt" in sys.argv[1:]:
        # development run: phase 8 only, no result line
        ckpt_phase(torch, smi)
        return 0
    if "--zoo" in sys.argv[1:]:
        # development run: phase 9 only, no result line
        zoo_phase(torch, smi, K.KERNELS)
        return 0
    if "--serve-ckpt" in sys.argv[1:]:
        # development run: phase 10 only, no result line
        serve_ckpt_phase(torch, smi, K.KERNELS)
        return 0
    if "--async" in sys.argv[1:]:
        # development run: phase 11 only, no result line
        async_phase(torch, smi, K.KERNELS)
        return 0
    if "--decode" in sys.argv[1:]:
        # development run: kernels 4 and 5 only, no result line
        checks = {"paged_decode": check_paged(torch),
                  "int8_matmul": check_int8(torch)}
        for k, rows in checks.items():
            print_rows(k, rows)
        decode_step_ms(checks)
        return 0
    checks = {"flash_fwd": check_flash(torch),
              "paged_decode": check_paged(torch),
              "int8_matmul": check_int8(torch)}
    checks["flash_bwd_dq"], checks["flash_bwd_dkv"] = check_flash_bwd(torch)
    for k, rows in checks.items():
        print_rows(k, rows)
    decode_step_ms(checks)
    check_flash_autograd(torch)

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

    # -- phase 4 -----------------------------------------------------------
    trains = {p: train_run(torch, p, smi, K.KERNELS)
              for p in ("bf16", "fp32")}
    for p in ("fp32", "bf16"):
        train_parity(torch, p)
    train_launches = trains["bf16"][0]
    print(f"launches per training step (bf16, {TRAIN_STEPS} steps + "
          f"{VAL_BATCHES} validation batches): "
          + ", ".join(f"{k}={train_launches[k] / TRAIN_STEPS:g}"
                      for k in ("flash_fwd", "flash_bwd_dq",
                                "flash_bwd_dkv")), flush=True)
    # -- phase 5 -----------------------------------------------------------
    conv_phase(torch, smi, K.KERNELS)
    # -- phase 6 -----------------------------------------------------------
    bsp_launches = bsp_phase(torch, smi, K.KERNELS)
    # -- phase 7 -----------------------------------------------------------
    stream_launches = data_phase(torch, smi, K.KERNELS)
    # -- phase 8 -----------------------------------------------------------
    resume_launches = ckpt_phase(torch, smi)
    # -- phase 9 -----------------------------------------------------------
    zoo_launches = zoo_phase(torch, smi, K.KERNELS)
    # -- phase 10 ----------------------------------------------------------
    ckpt_serve_launches = serve_ckpt_phase(torch, smi, K.KERNELS)
    # -- phase 11 ----------------------------------------------------------
    async_launches = async_phase(torch, smi, K.KERNELS)

    # the serving slice's kernels report their serve run; the flash
    # kernels the training run, which launches all three
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        main_launches[k] = train_launches[k]
    by_path = {k.name: {"serve_bf16": runs[("bf16", False)][0][k.name],
                        "serve_bf16_int8": runs[("bf16", True)][0][k.name],
                        "train_bf16": train_launches[k.name],
                        "train_stream_bf16": stream_launches[k.name],
                        "train_resume_bf16": resume_launches.get(k.name,
                                                                 0),
                        "train_zoo_bf16": zoo_launches[k.name],
                        **{path: got[k.name] for path, got
                           in ckpt_serve_launches.items()},
                        **{path: got[k.name] for path, got
                           in async_launches.items()},
                        **{path: got[k.name]
                           for path, got in bsp_launches.items()}}
               for k in K.KERNELS}

    # one representative main-path shape per kernel for the summary line
    t_shape = (f"B={TRAIN_ATTN['b']} T={TRAIN_ATTN['t']} "
               f"H={TRAIN_ATTN['h']} D={TRAIN_ATTN['d']} causal")
    rep = {"flash_fwd": ("bfloat16", "B=1 T=1024"),
           "paged_decode": ("bfloat16", "B=8"),
           "int8_matmul": ("bfloat16", "M=8 [512,32768]"),
           "flash_bwd_dq": ("bfloat16", t_shape),
           "flash_bwd_dkv": ("bfloat16", t_shape)}
    summary = []
    for k in K.KERNELS:
        dt, key = rep[k.name]
        row = next(r for r in checks[k.name]
                   if r["dtype"] == dt and r["shape"].startswith(key))
        summary.append({
            "name": k.name, "route": "cuda",
            "source": f"theanompi_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces, "launches": main_launches[k.name],
            "launches_by_path": by_path[k.name],
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
