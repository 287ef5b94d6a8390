"""Rule-value comparison: BSP, EASGD, LocalSGD and GOSGD trained to a
target.

Counterpart of ``theanompi_tpu/utils/rulecomp.py``: train the same model
from the same init under each rule on the same ranks, stop when the
validation metric first reaches a target (or at ``max_epochs``), and
record steps, epochs and wall-clock to target.  ``run_to_target`` (:79),
``compare_rules`` with the per-rule LR sweep and rule-config overrides
(:141), ``default_rulesets`` (:58) and the artifact's keys are the
reference's; its EASGD diagnosis grid (``diagnose_easgd_tau``,
``--diagnose-easgd``) is not ported: ``compare_rules`` with a 4-tuple
ruleset runs any such grid.

The port runs one process a worker, so these functions run on every rank
of a process group alike (or in one process): each rank calls
``rule.init(devices=N)`` with the group's N, trains its share, and
rank 0's row is the run's (its ``wall_s`` includes waiting for the other
ranks at every collective).  The CLI, ``python -m
theanompi_torch.utils.rulecomp --devices N``, starts the N ranks through
:func:`theanompi_torch.dist.spawn` (:func:`theanompi_torch.dist.
group_layout`: one card a rank under NCCL, or gloo ranks sharing the
cards, or on the CPU with ``--device cpu``); rank 0 writes ``--out`` and
prints.

Each run calls ``trainer.warmup()`` before its clock starts (every path
once, the kernels' first build and cuDNN's first choices included, then a
fresh init), so ``wall_s`` times training alone.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

DEFAULT_MODEL_CONFIG = {
    "depth": 10,
    "widen": 1,
    "batch_size": 8,
    "image_size": 16,
    "n_train": 512,
    "n_val": 128,
    "precision": "fp32",
    "lr": 0.05,
}


def default_rulesets() -> list[tuple[str, str, dict]]:
    """-> [(name, rule class name, rule config)]: the reference's grid."""
    return [
        ("bsp", "BSP", {}),
        ("easgd_tau1", "EASGD", {"tau": 1}),
        ("easgd_tau4", "EASGD", {"tau": 4}),
        ("easgd_tau16", "EASGD", {"tau": 16}),
        ("gosgd", "GOSGD", {}),
    ]


def _lead() -> bool:
    from theanompi_torch import dist as tdist

    return tdist.rank() == 0


def run_to_target(rule, *, devices, model_config: dict, target_error: float,
                  max_epochs: int, modelfile: str, modelclass: str,
                  metric: str = "error", device=None) -> dict:
    """Train one rule until the validation ``metric`` is at most the
    target (or ``max_epochs``); -> its result row.  ``metric``:
    classification error, or ``"perplexity"`` for the LM rows.
    ``device``: the rank's (None: its card)."""
    rule.init(devices=devices, modelfile=modelfile, modelclass=modelclass,
              model_config={**model_config, "n_epochs": max_epochs},
              device=device)
    rule.trainer.warmup()  # first calls outside the timed window
    hit: dict[str, Any] = {}

    def stop(epoch: int, val: dict) -> bool:
        err = val.get(metric)
        if err is not None and err <= target_error and "epoch" not in hit:
            hit["epoch"] = epoch
            hit["steps"] = rule.trainer.iteration
        return "epoch" in hit

    t0 = time.perf_counter()
    rec = rule.trainer.run(stop=stop)
    wall = time.perf_counter() - t0
    curve = [float(e) for e in rec.val_history.get(metric, [])]
    row = {
        "reached": "epoch" in hit,
        "metric": metric,
        # the LR after the rule's hooks: EASGD's scale_lr multiplies it
        "effective_lr": rule.trainer.model.config.get("lr"),
        "epochs_to_target": hit.get("epoch"),
        "steps_to_target": hit.get("steps"),
        "epochs_run": len(curve),
        "steps_run": rule.trainer.iteration,
        "wall_s": round(wall, 3),
        "best_val_error": min(curve) if curve else None,
        "val_error_curve": curve,
    }
    if metric != "error":
        row[f"best_val_{metric}"] = row["best_val_error"]
        row[f"val_{metric}_curve"] = curve
    return row


def _better(a: dict, b: dict) -> bool:
    """Is row ``a`` a better outcome than row ``b``?  Reached beats not;
    among reached, fewer epochs then less wall time; among unreached,
    lower best validation error."""
    if a["reached"] != b["reached"]:
        return a["reached"]
    if a["reached"]:
        return (a["epochs_to_target"], a["wall_s"]) < (
            b["epochs_to_target"], b["wall_s"])
    a_err = 1e9 if a["best_val_error"] is None else a["best_val_error"]
    b_err = 1e9 if b["best_val_error"] is None else b["best_val_error"]
    return a_err < b_err


def _write(artifact: dict, out_path: str) -> None:
    with open(out_path + ".tmp", "w") as f:
        json.dump(artifact, f, indent=1)
    os.replace(out_path + ".tmp", out_path)


def compare_rules(devices=None, model_config: dict | None = None,
                  target_error: float = 0.5, max_epochs: int = 8,
                  rules: list | None = None,
                  modelfile: str = "theanompi_torch.models.wide_resnet",
                  modelclass: str = "WideResNet",
                  lr_sweep: tuple[float, ...] | None = None,
                  out_path: str | None = None,
                  verbose: bool = True, device=None) -> dict:
    """Run the grid; -> the artifact (rank 0 writes ``out_path`` and
    prints each row when ``verbose``).  ``rules``: ``(name, rule class
    name, rule config[, [rule-config overrides]])`` entries; the
    overrides cross with ``lr_sweep``, and each rule is reported at its
    best setting with the whole sweep beside it.  ``devices``: the
    worker count (None: the group's)."""
    import theanompi_torch as tm
    from theanompi_torch import dist as tdist

    devices = tdist.world() if devices is None else devices
    model_config = {**DEFAULT_MODEL_CONFIG, **(model_config or {}),
                    "verbose": False}
    rows = []
    for entry in (rules or default_rulesets()):
        name, cls_name, cfg = entry[:3]
        overrides = entry[3] if len(entry) > 3 else [{}]
        sweep_rows = []
        for lr in (lr_sweep or (model_config["lr"],)):
            for ov in overrides:
                rule = getattr(tm, cls_name)(config={**cfg, **ov, "seed": 0,
                                                     "verbose": False})
                row = run_to_target(
                    rule, devices=devices,
                    model_config={**model_config, "lr": lr},
                    target_error=target_error, max_epochs=max_epochs,
                    modelfile=modelfile, modelclass=modelclass,
                    device=device)
                row["base_lr"] = lr
                if ov:
                    row["rule_overrides"] = dict(ov)
                sweep_rows.append(row)
        best = sweep_rows[0]
        for r in sweep_rows[1:]:
            if _better(r, best):
                best = r
        row = {"rule": name, "rule_class": cls_name, "rule_config": cfg,
               **best}
        if lr_sweep or len(sweep_rows) > 1:
            row["sweep"] = [
                {k: r[k] for k in ("base_lr", "effective_lr", "reached",
                                   "epochs_to_target", "steps_to_target",
                                   "best_val_error", "rule_overrides")
                 if k in r}
                for r in sweep_rows
            ]
        rows.append(row)
        if verbose and _lead():
            print(json.dumps(row), flush=True)
    artifact = {
        "model": f"{modelfile}.{modelclass}",
        "model_config": dict(model_config),
        "devices": devices,
        "target_error": target_error,
        "max_epochs": max_epochs,
        "lr_sweep": list(lr_sweep) if lr_sweep else None,
        "results": rows,
    }
    if out_path and _lead():
        _write(artifact, out_path)
    return artifact


def _rank_main(device, kwargs: dict) -> dict:
    """One rank of the CLI's run."""
    return compare_rules(device=device, **kwargs)


def main(argv=None) -> int:
    import argparse

    from theanompi_torch import dist as tdist

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=8,
                   help="worker count: ranks started through "
                   "theanompi_torch.dist.spawn")
    p.add_argument("--device", default=None,
                   help="the ranks' device (default: the cards; 'cpu' "
                   "runs gloo ranks on the host)")
    p.add_argument("--target-error", type=float, default=0.5)
    p.add_argument("--max-epochs", type=int, default=8)
    p.add_argument("--lr-sweep", default=None,
                   help="comma-separated base LRs to tune each rule over")
    p.add_argument("--out", default="rulecomp.json")
    a = p.parse_args(argv)
    sweep = (tuple(float(x) for x in a.lr_sweep.split(","))
             if a.lr_sweep else None)
    kwargs = {"devices": a.devices, "target_error": a.target_error,
              "max_epochs": a.max_epochs, "lr_sweep": sweep,
              "out_path": a.out}
    backend, device = tdist.group_layout(a.devices, a.device)
    art = tdist.spawn(_rank_main, a.devices, backend, device,
                      (kwargs,))[0]
    reached = [r for r in art["results"] if r["reached"]]
    print(json.dumps({"reached": len(reached), "of": len(art["results"]),
                      "out": a.out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
