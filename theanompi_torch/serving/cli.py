"""``python -m theanompi_torch.serving``: the port's ``tmserve``.

Counterpart of ``theanompi_tpu/serving/cli.py``: the same flags, the same
synthetic open-loop traffic and the same one-line JSON report, served by
the port's engine on the card (``--device cpu`` runs every kernel's plain
version on the host).  The weights are the model's seeded random init.

Exit codes (the reference's contract): 0 clean, 70 serving crash, 78
config error, each with one ``tmserve: error:`` line on stderr.  A flag
whose machinery is not ported yet exits 78 with ``... not yet ported``:
``--checkpoint-dir``, ``--rollout-watch``, ``--telemetry-dir``,
``--supervise``, ``--queue-file``, ``--requests-log``, ``--snapshot``.

Example (one H100)::

    python -m theanompi_torch.serving --set dim=512 --set heads=8 \\
        --set n_layers=8 --set seq_len=2048 --set vocab=32768 \\
        --requests 16 --prompt-len 256 --max-new-tokens 32
"""

from __future__ import annotations

import argparse
import ast
import importlib
import json
import os
import signal
import sys
import threading

EXIT_CRASH = 70
EXIT_CONFIG = 78

#: flags whose machinery (verified checkpoints, rollout, telemetry,
#: supervision, the router's queue, request logs, live snapshots) comes
#: with a later slice
NOT_PORTED = ("checkpoint_dir", "rollout_watch", "telemetry_dir",
              "supervise", "queue_file", "requests_log", "snapshot")


def _parse_kv(pairs: list[str]) -> dict:
    """``k=v`` pairs with Python-literal values; bare strings stay
    strings."""
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"expected key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tmserve",
        description="Serve synthetic open-loop traffic through the "
        "continuous-batching inference engine (PyTorch/CUDA port).",
        allow_abbrev=False,
    )
    p.add_argument("--modelfile",
                   default="theanompi_torch.models.transformer_lm")
    p.add_argument("--modelclass", default="TransformerLM")
    p.add_argument("--set", dest="model_set", action="append", default=[],
                   metavar="K=V", help="model config entry (repeatable)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; no CUDA is an "
                   "error unless 'cpu' is asked for)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="not yet ported")
    p.add_argument("--serve-verify", default="fast",
                   choices=["fast", "full", "none"],
                   help="checkpoint verification level (with "
                   "--checkpoint-dir, not yet ported)")
    p.add_argument("--serve-force", action="store_true",
                   help="override the checkpoint fingerprint check (with "
                   "--checkpoint-dir, not yet ported)")
    # -- engine ------------------------------------------------------------
    p.add_argument("--max-batch", type=int, default=8,
                   help="fixed decode batch width (slots)")
    p.add_argument("--block-size", type=int, default=16,
                   help="KV-cache tokens per block")
    p.add_argument("--num-blocks", type=int, default=None,
                   help="KV block pool size (default: worst case; smaller "
                   "values oversubscribe and rely on preemption)")
    p.add_argument("--quantize-int8", action="store_true",
                   help="int8 weight-only quantization of matmul weights "
                   "(per-chunk-scale format; decode runs kernel 5)")
    p.add_argument("--top-k", type=int, default=0,
                   help="restrict sampling to the top-k logits (0 = off)")
    p.add_argument("--decode-kernel", default="auto",
                   choices=("on", "off", "auto"),
                   help="decode kernels (paged attention, int8 matmul): on "
                   "takes them everywhere, off pins the plain path, auto "
                   "takes them on the card (a geometry a kernel refuses "
                   "raises) and the plain path elsewhere")
    p.add_argument("--prefix-cache", action="store_true",
                   help="radix prefix cache over the KV block pool")
    # -- synthetic traffic -------------------------------------------------
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--prompt-len", type=int, default=16,
                   help="synthetic prompt length (with --turns>1, the "
                   "per-turn extension length)")
    p.add_argument("--turns", type=int, default=1,
                   help="multi-turn sessions of this many requests each")
    p.add_argument("--shared-prefix-len", type=int, default=0,
                   help="identical tokens prepended to every request")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--arrival-rate", type=float, default=0.0,
                   help="Poisson arrival rate in requests/sec (0 = all at "
                   "t=0)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; >0 samples under seeded generators")
    p.add_argument("--seed", type=int, default=0)
    # -- request lifecycle -------------------------------------------------
    p.add_argument("--ttft-deadline-ms", type=float, default=None,
                   help="per-request time-to-first-token deadline")
    p.add_argument("--total-deadline-ms", type=float, default=None,
                   help="per-request end-to-end deadline")
    p.add_argument("--shed", action="store_true",
                   help="admission-time load shedding of requests whose "
                   "deadline the backlog cannot meet")
    p.add_argument("--drain-s", type=float, default=5.0,
                   help="graceful-drain budget after SIGTERM")
    p.add_argument("--requests-log", default=None, help="not yet ported")
    p.add_argument("--queue-file", default=None, help="not yet ported")
    p.add_argument("--snapshot", default=None, help="not yet ported")
    p.add_argument("--snapshot-every", type=int, default=8,
                   help="steps between live snapshots (with --snapshot, "
                   "not yet ported)")
    p.add_argument("--supervise", action="store_true",
                   help="not yet ported")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--backoff-base", type=float, default=1.0)
    p.add_argument("--rollout-watch", action="store_true",
                   help="not yet ported")
    p.add_argument("--rollout-poll-s", type=float, default=0.5)
    p.add_argument("--rollout-probation-s", type=float, default=10.0)
    # -- output ------------------------------------------------------------
    p.add_argument("--telemetry-dir", default=None, help="not yet ported")
    p.add_argument("--slo-ttft-ms", type=float, default=None,
                   help="serving SLO (with --telemetry-dir, not yet "
                   "ported)")
    p.add_argument("--out", default=None,
                   help="write the report dict as JSON here (SERVE.json)")
    p.add_argument("--quiet", action="store_true")
    return p


def _error_line(phase: str, e: BaseException) -> None:
    print(f"tmserve: error: {phase}: {type(e).__name__}: {e}",
          file=sys.stderr, flush=True)


def synthetic_requests(n: int, vocab: int, prompt_len: int,
                       max_new_tokens: int, rate: float, seed: int,
                       temperature: float = 0.0,
                       ttft_deadline_ms: float | None = None,
                       total_deadline_ms: float | None = None,
                       turns: int = 1, shared_prefix: int = 0):
    """Seeded open-loop request stream — the reference's generator, so
    the same arguments give the same prompts and arrivals: uniform-random
    prompts, Poisson arrivals at ``rate`` req/s (0 = one burst),
    ``shared_prefix`` tokens on every prompt, and ``turns``-request
    sessions whose turn t extends turn t-1 by ``prompt_len`` tokens."""
    import numpy as np

    from theanompi_torch.serving.scheduler import Request

    rng = np.random.RandomState(seed)
    shared = ([int(x) for x in rng.randint(0, vocab, shared_prefix)]
              if shared_prefix > 0 else [])
    t = 0.0
    out = []
    convo: list[int] = []
    for rid in range(n):
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        if turns <= 1 or rid % turns == 0:
            convo = []
        convo = convo + [int(x) for x in rng.randint(0, vocab, prompt_len)]
        out.append(Request(
            rid=rid, prompt=shared + convo, max_new_tokens=max_new_tokens,
            temperature=temperature, arrival_s=t if rate > 0 else 0.0,
            ttft_deadline_ms=ttft_deadline_ms,
            total_deadline_ms=total_deadline_ms))
    return out


def serve(args, on_terminal=None) -> dict:
    """Build model + engine + scheduler, run the synthetic load; ->
    report.  SIGTERM drains: admission stops, in-flight requests finish or
    expire within ``--drain-s``.  ``on_terminal(request)`` fires once per
    request as it reaches its terminal state (generated tokens
    included)."""
    import torch

    from theanompi_torch.serving.engine import InferenceEngine
    from theanompi_torch.serving.scheduler import (
        Scheduler,
        run_open_loop,
        serve_report,
    )

    for flag in NOT_PORTED:
        if getattr(args, flag, None):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} not yet ported")
    cls = getattr(importlib.import_module(args.modelfile), args.modelclass)
    model = cls(_parse_kv(args.model_set))
    params, _ = model.init_params(torch.Generator().manual_seed(args.seed))
    engine = InferenceEngine(
        model, params, block_size=args.block_size,
        num_blocks=args.num_blocks, max_batch=args.max_batch,
        quantize_int8=args.quantize_int8, top_k=args.top_k, seed=args.seed,
        decode_kernel=args.decode_kernel, device=args.device)
    sched = Scheduler(engine, shed=args.shed, prefix_cache=args.prefix_cache)
    reqs = synthetic_requests(
        args.requests, model.vocab, args.prompt_len, args.max_new_tokens,
        args.arrival_rate, args.seed, args.temperature,
        ttft_deadline_ms=args.ttft_deadline_ms,
        total_deadline_ms=args.total_deadline_ms, turns=args.turns,
        shared_prefix=args.shared_prefix_len)
    drain_ev = threading.Event()
    prev_term = None
    if threading.current_thread() is threading.main_thread():
        prev_term = signal.signal(signal.SIGTERM,
                                  lambda _sig, _frm: drain_ev.set())
    try:
        results, wall_s = run_open_loop(sched, reqs, drain=drain_ev.is_set,
                                        drain_s=args.drain_s,
                                        on_terminal=on_terminal)
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
    report = serve_report(results, wall_s, sched)
    if engine.quant_stats:
        report["quantization"] = engine.quant_stats
    return report


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    try:
        report = serve(args)
    except (ImportError, AttributeError, TypeError, ValueError, KeyError,
            NotImplementedError) as e:
        _error_line("config", e)
        return EXIT_CONFIG
    except Exception as e:  # the server's boundary: report, exit 70
        _error_line("serving", e)
        return EXIT_CRASH
    if args.out:
        with open(args.out + ".tmp", "w") as f:
            json.dump(report, f, indent=1)
        os.replace(args.out + ".tmp", args.out)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
