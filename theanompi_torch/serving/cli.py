"""``python -m theanompi_torch.serving``: the port's ``tmserve``.

Counterpart of ``theanompi_tpu/serving/cli.py``: the same flags, the same
synthetic open-loop traffic and the same one-line JSON report, served by
the port's engine on the card (``--device cpu`` runs every kernel's plain
version on the host).

- **Weights**: ``--checkpoint-dir DIR`` serves the newest checkpoint of
  DIR that verifies (``--serve-verify``), written by either package's
  launcher, through the read-only chain
  (:func:`theanompi_torch.utils.checkpoint.load_for_inference`: nothing
  in DIR is written, a corrupt file is stepped over and left in place).
  The ``--set`` flags must reproduce the training config (the manifest's
  model class and config sha; ``--serve-force`` overrides).  Without it
  the model serves its seeded random init.
- **Live rollout**: ``--rollout-watch`` polls DIR between scheduler steps
  and hot-swaps newer verified checkpoints
  (:mod:`theanompi_torch.serving.rollout`).  Its probation rollback reads
  health verdicts, which come with ``--telemetry-dir`` (not ported yet).
- **Request log**: ``--requests-log FILE`` appends one JSON line per
  terminal request (:mod:`theanompi_torch.serving.lifecycle`); a rerun
  with the same log skips the ids already answered.
- **Queue**: ``--queue-file FILE`` serves a durable JSONL queue instead of
  synthetic traffic and returns on its ``{"op": "drain"}`` sentinel; the
  request log and the live snapshot (``--snapshot``, every
  ``--snapshot-every`` steps) default into its directory.
- **Drain**: SIGTERM stops admission; in-flight requests finish or expire
  within ``--drain-s``, and the exit is clean.
- **Faults**: ``THEANOMPI_FAULT_PLAN`` arms ``serve:raise``,
  ``serve:stall`` and ``serve:rollout_corrupt``
  (:mod:`theanompi_torch.resilience.faults`); ``THEANOMPI_ATTEMPT`` is
  the attempt recorded in the request log.

Exit codes (the reference's contract): 0 clean, 70 serving crash, 77 no
verifiable checkpoint, 78 config error (a fingerprint mismatch, an empty
checkpoint directory, ``--rollout-watch`` without ``--checkpoint-dir``,
a fault plan naming an unhooked site), each with one ``tmserve: error:``
line on stderr.  ``--telemetry-dir`` and ``--supervise`` are not ported
yet and exit 78 with ``... not yet ported``.

Example (one H100)::

    python -m theanompi_torch.launcher --set dim=512 --set heads=8 \\
        --set n_layers=8 --set seq_len=2048 --set vocab=32768 \\
        --set precision=bf16 --checkpoint-dir ckpt
    python -m theanompi_torch.serving --set dim=512 --set heads=8 \\
        --set n_layers=8 --set seq_len=2048 --set vocab=32768 \\
        --set precision=bf16 --checkpoint-dir ckpt \\
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

from theanompi_torch.resilience.codes import EXIT_CKPT, EXIT_CONFIG, EXIT_CRASH

#: flags whose machinery (telemetry and health, supervision) comes with a
#: later slice
NOT_PORTED = ("telemetry_dir", "supervise")


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
                   help="load weights via the verified chain (read-only; "
                   "absent = serve the seeded random init)")
    p.add_argument("--serve-verify", default="fast",
                   choices=["fast", "full", "none"],
                   help="checkpoint verification level (default fast)")
    p.add_argument("--serve-force", action="store_true",
                   help="override the model-fingerprint check on load "
                   "(mirrors tmlauncher --resume-force)")
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
    p.add_argument("--requests-log", default=None,
                   help="append one JSONL line per terminal request here; "
                   "a rerun with the same log skips already-answered ids")
    p.add_argument("--queue-file", default=None,
                   help="serve a durable admission queue instead of "
                   "synthetic traffic: tail this JSONL file for request "
                   "entries, return on its {\"op\": \"drain\"} sentinel "
                   "(REQUESTS.jsonl and SERVE_SNAPSHOT.json default into "
                   "its directory)")
    p.add_argument("--snapshot", default=None,
                   help="publish the scheduler's live load here atomically "
                   "(default: next to --queue-file)")
    p.add_argument("--snapshot-every", type=int, default=8,
                   help="scheduler steps between live-snapshot publishes")
    p.add_argument("--supervise", action="store_true",
                   help="not yet ported")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--backoff-base", type=float, default=1.0)
    p.add_argument("--rollout-watch", action="store_true",
                   help="watch --checkpoint-dir and hot-swap newly "
                   "verified checkpoints between scheduler steps (active "
                   "requests recompute under the new weights); corrupt or "
                   "half-published candidates are refused and polled "
                   "again, never quarantined")
    p.add_argument("--rollout-poll-s", type=float, default=0.5,
                   help="checkpoint-dir poll interval (listdir only)")
    p.add_argument("--rollout-probation-s", type=float, default=10.0,
                   help="after a swap, roll back to the previous weights if "
                   "a health verdict turns critical within this window "
                   "(the verdicts come with --telemetry-dir, not yet "
                   "ported)")
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
    """Build model + engine + scheduler, serve the synthetic load or the
    queue; -> report.  SIGTERM drains: admission stops, in-flight requests
    finish or expire within ``--drain-s``; the previous handler is
    restored on the way out.  ``on_terminal(request)`` fires once per
    request as it reaches its terminal state (generated tokens
    included)."""
    import torch

    from theanompi_torch.resilience.faults import FaultPlan, current_attempt
    from theanompi_torch.serving.engine import InferenceEngine
    from theanompi_torch.serving.lifecycle import (
        REQUESTS_LOG,
        SNAPSHOT,
        RequestLog,
        SnapshotPublisher,
        terminal_rids,
    )
    from theanompi_torch.serving.scheduler import (
        Scheduler,
        run_open_loop,
        run_queue_loop,
        serve_report,
    )
    from theanompi_torch.utils.checkpoint import load_for_inference

    for flag in NOT_PORTED:
        if getattr(args, flag, None):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} not yet ported")
    if args.rollout_watch and not args.checkpoint_dir:
        raise ValueError("--rollout-watch needs --checkpoint-dir (there is "
                         "nothing to watch)")
    fault_plan = FaultPlan.from_spec(None)  # THEANOMPI_FAULT_PLAN
    cls = getattr(importlib.import_module(args.modelfile), args.modelclass)
    model = cls(_parse_kv(args.model_set))
    params, _ = model.init_params(torch.Generator().manual_seed(args.seed))
    epoch = None
    if args.checkpoint_dir:
        restored = load_for_inference(
            args.checkpoint_dir, {"params": params},
            verify=args.serve_verify, model=model, force=args.serve_force)
        if restored is None:
            raise FileNotFoundError(
                f"no checkpoint in {args.checkpoint_dir} (tmserve does not "
                f"serve a random init when a directory was given)")
        epoch, _it, trees = restored
        params = trees["params"]
    attempt = current_attempt()
    engine = InferenceEngine(
        model, params, block_size=args.block_size,
        num_blocks=args.num_blocks, max_batch=args.max_batch,
        quantize_int8=args.quantize_int8, top_k=args.top_k, seed=args.seed,
        decode_kernel=args.decode_kernel, device=args.device)
    sched = Scheduler(engine, shed=args.shed, prefix_cache=args.prefix_cache,
                      fault_plan=fault_plan)
    queue_file = args.queue_file
    queue_dir = (os.path.dirname(os.path.abspath(queue_file))
                 if queue_file else None)
    reqs = [] if queue_file else synthetic_requests(
        args.requests, model.vocab, args.prompt_len, args.max_new_tokens,
        args.arrival_rate, args.seed, args.temperature,
        ttft_deadline_ms=args.ttft_deadline_ms,
        total_deadline_ms=args.total_deadline_ms, turns=args.turns,
        shared_prefix=args.shared_prefix_len)

    # the durable terminal-state log, and the rerun's dedup off it
    log_path = args.requests_log or (
        os.path.join(queue_dir, REQUESTS_LOG) if queue_file else None)
    answered: set[int] = set()
    n_skipped = 0
    if log_path:
        answered = terminal_rids(log_path)
        if queue_file:
            n_skipped = len(answered)
        elif answered:
            before = len(reqs)
            reqs = [r for r in reqs if r.rid not in answered]
            n_skipped = before - len(reqs)
    snap_path = args.snapshot or (
        os.path.join(queue_dir, SNAPSHOT) if queue_file else None)
    snapshot = (SnapshotPublisher(snap_path, every_steps=args.snapshot_every)
                if snap_path else None)
    rollout = None
    if args.rollout_watch:
        from theanompi_torch.serving.rollout import RolloutManager

        rollout = RolloutManager(
            engine, args.checkpoint_dir, {"params": params}, model=model,
            verify=args.serve_verify, current_epoch=epoch,
            poll_s=args.rollout_poll_s,
            probation_s=args.rollout_probation_s, fault_plan=fault_plan)

    req_log = RequestLog(log_path, attempt=attempt) if log_path else None

    def terminal(req, **extra):
        if req_log is not None:
            req_log.record(req, **extra)
        if on_terminal is not None:
            on_terminal(req)

    drain_ev = threading.Event()
    prev_term = None
    if threading.current_thread() is threading.main_thread():
        prev_term = signal.signal(signal.SIGTERM,
                                  lambda _sig, _frm: drain_ev.set())
    loop_kw = dict(drain=drain_ev.is_set, drain_s=args.drain_s,
                   on_terminal=terminal,
                   between_steps=rollout.poll if rollout else None,
                   snapshot=snapshot)
    try:
        if queue_file:
            results, wall_s = run_queue_loop(sched, queue_file,
                                             answered=answered, **loop_kw)
        else:
            results, wall_s = run_open_loop(sched, reqs, **loop_kw)
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
        if req_log is not None:
            req_log.close()
    report = serve_report(results, wall_s, sched)
    report["checkpoint_epoch"] = (rollout.current_epoch if rollout
                                  else epoch)
    report["attempt"] = attempt
    if n_skipped:
        report["skipped_already_answered"] = n_skipped
    if log_path:
        report["requests_log"] = log_path
    if queue_file:
        report["queue_file"] = queue_file
    if rollout is not None:
        report["rollout"] = {"rollouts": rollout.n_rollouts,
                             "rollbacks": rollout.n_rollbacks,
                             "refused": rollout.n_refused,
                             "serving_epoch": rollout.current_epoch}
    if engine.quant_stats:
        report["quantization"] = engine.quant_stats
    return report


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    from theanompi_torch.utils.checkpoint import (
        CheckpointCorruptError,
        CheckpointFingerprintError,
    )

    try:
        report = serve(args)
    except CheckpointFingerprintError as e:
        _error_line("load", e)
        return EXIT_CONFIG
    except CheckpointCorruptError as e:  # the chain exhausted included
        _error_line("checkpoint", e)
        return EXIT_CKPT
    except (ImportError, AttributeError, TypeError, ValueError, KeyError,
            FileNotFoundError, NotImplementedError) as e:
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
