"""``python -m theanompi_torch.launcher``: the port's ``tmlauncher``.

Counterpart of ``theanompi_tpu/launcher.py``: the reference's flag names
for what the port carries — ``--rule BSP|EASGD|LocalSGD|GOSGD``,
``--modelfile``,
``--modelclass``, ``--set K=V`` (model config), ``--rule-set K=V`` (rule
config), ``--config-json`` (a JSON file ``{"model": {...}, "rule":
{...}}`` that the ``--set`` / ``--rule-set`` pairs override),
``--record-dir`` (the recorder's histories), ``--checkpoint-dir``,
``--resume``, ``--resume-force``, ``--seed``, ``--quiet``, ``--devices
N|all`` — plus ``--device`` (the card by default; ``cpu`` only when
asked).  The reference's other flags (the reshard, telemetry,
supervision, ...) are accepted by the parser and refused with exit 78
``tmlauncher: error: config: --flag not yet ported``.

The async rules take their keys by ``--rule-set``: ``tau``, ``alpha`` and
``scale_lr`` (EASGD and LocalSGD), ``p_push`` (GOSGD); e.g. ``--rule
EASGD --rule-set tau=4 --devices 4``.  Each rank trains its own worker
and rank 0 prints the validation of the center (EASGD, LocalSGD) or of
the weighted consensus (GOSGD).

Checkpoints: ``--checkpoint-dir D`` saves at every epoch boundary (and
every ``--rule-set checkpoint_every_n_iters=N`` steps) in the reference's
format, so a directory written by ``tmlauncher`` resumes here and one
written here resumes in ``tmlauncher``; ``--resume`` continues from the
newest verifiable checkpoint in D, ``--resume-force`` past a fingerprint
mismatch.

``--devices N`` (the reference's worker count, :137 and :409) starts N
local ranks through :func:`theanompi_torch.dist.spawn`, one process
each: on the cards one card a rank under NCCL, on ``--device cpu`` gloo
ranks on the host.  ``all`` is every visible card (1 on the CPU).  Rank
0's exit code and final validation line are the run's.  Started by
``torchrun`` instead (``WORLD_SIZE`` set), each process joins the group
as one rank.  ``--rule-set n_model=K`` (BSP; tensor and expert
parallelism) makes each of the N workers a model group of K ranks, so
``N x K`` ranks run: one card a rank under NCCL where the cards suffice,
else gloo ranks taking the cards in turn (``dist.group_layout``; NCCL
refuses two ranks on one card), which the launcher prints.

Exit codes (the reference's contract, :mod:`theanompi_torch.resilience.
codes`): 0 clean, 70 crash (environment, training, or a checkpoint that
cannot be read), 77 no verifiable checkpoint to resume from (the recovery
chain exhausted), 78 config error or a checkpoint of another run (without
``--resume-force``), each with one ``tmlauncher: error:`` line on stderr
(``THEANOMPI_DEBUG=1`` adds the traceback).  Above one rank every rank
ends with the worst code of any rank's start.

The exchange's rule keys: ``--rule-set exch_strategy=zero1`` (the
sharded update), ``--rule-set exch_overlap=true`` (collectives from
backward) and ``--rule-set exch_ramp=ring_int8:1,psum_bucket:2`` (the
strategy by epoch).

Example (one H100; ``--devices 4`` on a host with four)::

    python -m theanompi_torch.launcher \\
        --modelfile theanompi_torch.models.transformer_lm \\
        --modelclass TransformerLM --set dim=512 --set heads=8 \\
        --set n_layers=8 --set seq_len=2048 --set vocab=32768 \\
        --set batch_size=16 --set dropout=0.0 --set n_epochs=1
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys

from theanompi_torch.resilience.codes import EXIT_CKPT, EXIT_CONFIG, EXIT_CRASH

#: reference flags whose machinery comes with later slices: (flag, dest)
NOT_PORTED = (
    ("--telemetry-dir", "telemetry_dir"),
    ("--compile-cache-dir", "compile_cache_dir"),
    ("--resume-reshard", "resume_reshard"), ("--supervise", "supervise"),
    ("--max-restarts", "max_restarts"), ("--backoff-base", "backoff_base"),
    ("--hang-timeout", "hang_timeout"), ("--elastic", "elastic"),
    ("--sentinel", "sentinel"))
_FLAGS = ("--resume-reshard", "--supervise", "--elastic")

#: init-phase exception types that will not fix themselves on a rerun
_CONFIG_ERRORS = (ImportError, AttributeError, TypeError, ValueError,
                  KeyError, IndexError, NotImplementedError)


class ConfigError(Exception):
    """A flag or ``K=V`` pair the launcher cannot act on."""


#: the shell's spellings of a bool, which ``literal_eval`` would leave
#: strings (and ``bool("false")`` is True)
_BOOLS = {"true": True, "false": False}


def _parse_kv(pairs: list[str]) -> dict:
    """``k=v`` pairs with Python-literal values (``true``/``false`` in any
    case are bools); bare strings stay strings."""
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise ConfigError(f"expected key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        if v.lower() in _BOOLS:
            out[k] = _BOOLS[v.lower()]
            continue
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tmlauncher",
        description="Train a model with a theanompi_torch rule on one card "
        "(PyTorch/CUDA port).", allow_abbrev=False)
    p.add_argument("--rule", default="BSP",
                   choices=["BSP", "EASGD", "GOSGD", "LocalSGD"],
                   help="training rule (the async rules' keys by "
                   "--rule-set: tau, alpha, scale_lr, p_push)")
    p.add_argument("--modelfile",
                   default="theanompi_torch.models.transformer_lm")
    p.add_argument("--modelclass", default="TransformerLM")
    p.add_argument("--set", dest="model_set", action="append", default=[],
                   metavar="K=V", help="model config entry (repeatable)")
    p.add_argument("--rule-set", dest="rule_set", action="append",
                   default=[], metavar="K=V",
                   help="rule config entry (repeatable)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; no CUDA is an "
                   "error unless 'cpu' is asked for)")
    p.add_argument("--devices", default="1", metavar="N|all",
                   help="worker count: N local ranks, one card each "
                   "(NCCL), or gloo ranks with --device cpu; 'all' is "
                   "every visible card (1 on the CPU)")
    p.add_argument("--config-json", default=None,
                   help="path to a JSON file with {'model': {...}, "
                   "'rule': {...}}; --set / --rule-set override it")
    p.add_argument("--record-dir", default=None,
                   help="where the recorder writes its *_history.npy and "
                   "summary.json")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save a verified checkpoint at every epoch "
                   "boundary, in the reference's format")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest verifiable checkpoint "
                   "in --checkpoint-dir")
    p.add_argument("--resume-force", action="store_true",
                   help="resume even where the checkpoint's run "
                   "fingerprint (mesh, exchange strategy, model config) "
                   "differs from this run's")
    for flag, dest in NOT_PORTED:
        if flag in _FLAGS:
            p.add_argument(flag, dest=dest, action="store_true",
                           help="not yet ported")
        else:
            p.add_argument(flag, dest=dest, default=None,
                           help="not yet ported")
    return p


def _error_line(phase: str, e: BaseException) -> None:
    print(f"tmlauncher: error: {phase}: {type(e).__name__}: {e}",
          file=sys.stderr, flush=True)
    if os.environ.get("THEANOMPI_DEBUG"):
        import traceback

        traceback.print_exc()


def build_configs(args) -> tuple[dict, dict]:
    """-> (model config, rule config); raises :class:`ConfigError` on a
    flag this slice does not carry."""
    for flag, dest in NOT_PORTED:
        if getattr(args, dest) not in (None, False):
            raise ConfigError(f"{flag} not yet ported")
    model_config: dict = {}
    rule_config: dict = {}
    if args.config_json:
        try:
            with open(args.config_json) as f:
                blob = json.load(f)
        except (OSError, ValueError) as e:
            raise ConfigError(f"--config-json {args.config_json}: {e}")
        if not isinstance(blob, dict):
            raise ConfigError(f"--config-json {args.config_json}: not a "
                              f"JSON object")
        model_config.update(blob.get("model", {}))
        rule_config.update(blob.get("rule", {}))
    model_config.update(_parse_kv(args.model_set))
    rule_config.update(_parse_kv(args.rule_set))
    rule_config.setdefault("seed", args.seed)
    for key in ("record_dir", "checkpoint_dir"):
        if getattr(args, key):
            rule_config[key] = getattr(args, key)
    if args.resume:
        rule_config["resume"] = True
    if args.resume_force:
        rule_config["resume_force"] = True
    if args.quiet:
        rule_config["verbose"] = False
    return model_config, rule_config


def worker_count(args, on_cpu: bool) -> int:
    """``--devices`` as a number of ranks; raises :class:`ConfigError`
    where the run cannot have that many."""
    import torch

    if args.devices == "all":
        n = 1 if on_cpu else torch.cuda.device_count()
        if n == 0:
            raise ConfigError("--devices all: no CUDA device visible")
        return n
    try:
        n = int(args.devices)
    except ValueError:
        raise ConfigError(f"--devices {args.devices!r}: a count or 'all'")
    if n < 1:
        raise ConfigError(f"--devices {n}: at least 1")
    if n > 1 and not on_cpu:
        if args.device is not None and torch.device(args.device).index \
                is not None:
            raise ConfigError(f"--devices {n} on one card "
                              f"({args.device}): NCCL takes one rank a card")
        if n > torch.cuda.device_count():
            raise ConfigError(f"--devices {n}: "
                              f"{torch.cuda.device_count()} card(s) visible")
    return n


def model_ranks(rule_config: dict) -> int:
    """The rule key ``n_model`` (1 when absent); raises
    :class:`ConfigError` where it is not a positive integer."""
    k = rule_config.get("n_model", 1)
    if not isinstance(k, int) or isinstance(k, bool) or k < 1:
        raise ConfigError(f"n_model={k!r}: a positive integer")
    return k


def run_rank(device, job: dict) -> tuple[int, dict | None]:
    """One rank of a launcher run (every rank calls it; ``job["rule"]``
    names the rule, BSP when absent): -> (exit code,
    final validation metrics, rank 0's; None elsewhere or on failure).
    An init failure on any rank (a resume's included) ends every rank
    with the worst code; a training failure raises (the spawner ends the
    other ranks)."""
    import torch
    import torch.distributed as dist

    import theanompi_torch
    from theanompi_torch import dist as tdist
    from theanompi_torch.utils.checkpoint import (
        CheckpointCorruptError,
        CheckpointFingerprintError,
    )

    rule_cls = getattr(theanompi_torch, job.get("rule", "BSP"))
    code, rule = 0, rule_cls(config=job["rule_config"])
    try:
        # every rank of the group: the data workers, times n_model
        rule.init(devices=None, modelfile=job["modelfile"],
                  modelclass=job["modelclass"],
                  model_config=job["model_config"], device=device)
    except CheckpointCorruptError as e:
        # the recovery chain is exhausted (the files are under corrupt/):
        # a rerun would walk the same chain
        code = EXIT_CKPT
        _error_line("checkpoint", e)
    except CheckpointFingerprintError as e:
        # another run's checkpoint: the user holds the override
        code = EXIT_CONFIG
        _error_line("resume", e)
    except _CONFIG_ERRORS as e:
        code = EXIT_CONFIG
        _error_line("init", e)
    except Exception as e:  # the launcher's boundary: report, exit 70
        code = EXIT_CRASH
        _error_line("init", e)
    if tdist.world() > 1:
        worst = torch.tensor([code], device=device)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        code = int(worst.item())
    if code:
        return code, None
    recorder = rule.wait()
    if tdist.rank() != 0:
        return 0, None
    if recorder.verbose:
        from theanompi_torch.kernels import KERNELS

        # the hand-written kernels this rank's run launched, by name
        print("tmlauncher: kernel launches: " + json.dumps(
            {k.name: k.launches for k in KERNELS}), flush=True)
    return 0, {k: v[-1] for k, v in recorder.val_history.items() if v}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    import torch

    from theanompi_torch import dist as tdist

    on_cpu = args.device is not None and torch.device(args.device).type \
        == "cpu"
    try:
        model_config, rule_config = build_configs(args)
        n = worker_count(args, on_cpu)
        k = model_ranks(rule_config)
    except ConfigError as e:
        print(f"tmlauncher: error: config: {e}", file=sys.stderr, flush=True)
        return EXIT_CONFIG
    job = {"model_config": model_config, "rule_config": rule_config,
           "modelfile": args.modelfile, "modelclass": args.modelclass,
           "rule": args.rule}
    ranks = n * k
    backend, device = ("gloo", "cpu") if on_cpu else \
        tdist.group_layout(ranks, args.device)
    if k > 1 and not args.quiet:
        cards = sorted({str(tdist.rank_device(device, r))
                        for r in range(ranks)})
        print(f"tmlauncher: {ranks} ranks ({n} data x {k} model), backend "
              f"{backend}, devices {cards}", flush=True)

    try:
        if ranks > 1:
            code, val = tdist.spawn(run_rank, ranks, backend, device,
                                    (job,))[0]
        elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
            # started by torchrun: this process is one rank
            tdist.init(backend)
            try:
                code, val = run_rank(tdist.rank_device(
                    args.device or "cuda", tdist.local_rank()), job)
            finally:
                tdist.teardown()
        else:
            code, val = run_rank(args.device, job)
    except KeyboardInterrupt:
        raise  # a human's ^C is not a crash to classify
    except Exception as e:
        from theanompi_torch.utils.checkpoint import CheckpointCorruptError

        if isinstance(e, CheckpointCorruptError):
            _error_line("checkpoint", e)
            return EXIT_CKPT
        _error_line("training", e)
        return EXIT_CRASH
    if code == 0 and val is not None and not args.quiet:
        print(f"tmlauncher: done. final val: {val}", flush=True)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
