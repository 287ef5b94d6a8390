"""``python -m theanompi_torch.launcher``: the port's ``tmlauncher``.

Counterpart of ``theanompi_tpu/launcher.py`` for one process on one card:
the reference's flag names for what this slice carries — ``--rule BSP``,
``--modelfile``, ``--modelclass``, ``--set K=V`` (model config),
``--rule-set K=V`` (rule config), ``--seed``, ``--quiet`` — plus
``--device`` (the card by default; ``cpu`` only when asked).  The
reference's other flags (multi-device, checkpoints, telemetry,
supervision, ...) are accepted by the parser and refused with exit 78
``tmlauncher: error: config: --flag not yet ported``; so are the rules
other than BSP.

Exit codes (the reference's contract): 0 clean, 70 crash (environment or
training), 78 config error, each with one ``tmlauncher: error:`` line on
stderr (``THEANOMPI_DEBUG=1`` adds the traceback).

Example (one H100)::

    python -m theanompi_torch.launcher \\
        --modelfile theanompi_torch.models.transformer_lm \\
        --modelclass TransformerLM --set dim=512 --set heads=8 \\
        --set n_layers=8 --set seq_len=2048 --set vocab=32768 \\
        --set batch_size=16 --set dropout=0.0 --set n_epochs=1
"""

from __future__ import annotations

import argparse
import ast
import os
import sys

EXIT_CRASH = 70
EXIT_CONFIG = 78

#: reference flags whose machinery comes with later slices: (flag, dest)
NOT_PORTED = (
    ("--devices", "devices"), ("--config-json", "config_json"),
    ("--record-dir", "record_dir"), ("--telemetry-dir", "telemetry_dir"),
    ("--checkpoint-dir", "checkpoint_dir"),
    ("--compile-cache-dir", "compile_cache_dir"), ("--resume", "resume"),
    ("--resume-force", "resume_force"),
    ("--resume-reshard", "resume_reshard"), ("--supervise", "supervise"),
    ("--max-restarts", "max_restarts"), ("--backoff-base", "backoff_base"),
    ("--hang-timeout", "hang_timeout"), ("--elastic", "elastic"),
    ("--sentinel", "sentinel"))
_FLAGS = ("--resume", "--resume-force", "--resume-reshard", "--supervise",
          "--elastic")

#: init-phase exception types that will not fix themselves on a rerun
_CONFIG_ERRORS = (ImportError, AttributeError, TypeError, ValueError,
                  KeyError, IndexError, NotImplementedError)


class ConfigError(Exception):
    """A flag or ``K=V`` pair the launcher cannot act on."""


def _parse_kv(pairs: list[str]) -> dict:
    """``k=v`` pairs with Python-literal values; bare strings stay
    strings."""
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise ConfigError(f"expected key=value, got {pair!r}")
        k, v = pair.split("=", 1)
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
                   help="training rule (BSP; the others are not yet ported)")
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
    flag or rule this slice does not carry."""
    for flag, dest in NOT_PORTED:
        if getattr(args, dest) not in (None, False):
            raise ConfigError(f"{flag} not yet ported")
    if args.rule != "BSP":
        raise ConfigError(f"--rule {args.rule} not yet ported")
    model_config = _parse_kv(args.model_set)
    rule_config = _parse_kv(args.rule_set)
    rule_config.setdefault("seed", args.seed)
    if args.quiet:
        rule_config["verbose"] = False
    return model_config, rule_config


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    try:
        model_config, rule_config = build_configs(args)
    except ConfigError as e:
        print(f"tmlauncher: error: config: {e}", file=sys.stderr, flush=True)
        return EXIT_CONFIG

    from theanompi_torch.parallel.bsp import BSP

    try:
        rule = BSP(config=rule_config)
        rule.init(devices=1, modelfile=args.modelfile,
                  modelclass=args.modelclass, model_config=model_config,
                  device=args.device)
    except _CONFIG_ERRORS as e:
        _error_line("init", e)
        return EXIT_CONFIG
    except Exception as e:  # the launcher's boundary: report, exit 70
        _error_line("init", e)
        return EXIT_CRASH
    try:
        recorder = rule.wait()
    except KeyboardInterrupt:
        raise  # a human's ^C is not a crash to classify
    except Exception as e:
        _error_line("training", e)
        return EXIT_CRASH
    if not args.quiet:
        last = {k: v[-1] for k, v in recorder.val_history.items() if v}
        print(f"tmlauncher: done. final val: {last}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
