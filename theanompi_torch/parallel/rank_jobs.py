"""Jobs for every rank of a spawned process group, driven from files.

:func:`theanompi_torch.dist.spawn` runs one of these on each rank.  Their
inputs and outputs are files (``.npz`` of numpy arrays, ``.pt`` of param
trees), so a caller that holds other state (a test module with the JAX
reference loaded, ``chip_smoke.py``) hands the ranks plain data, and the
ranks import neither it nor JAX.  Each also runs at a world of 1, without
a group: the one-process run they are held against.

- :func:`exchange_cases` — the exchanger on per-rank inputs;
- :func:`bsp_run` — steps of the BSP rule, through ``BSP().init`` on each
  rank, with what the checks need from the first step;
- :func:`pmean_case`, :func:`loaded_modules`, and :func:`run_all`, which
  runs several jobs in one spawn.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from theanompi_torch import dist as tdist
from theanompi_torch.parallel.exchanger import Exchanger, flatten, fused_pmean
from theanompi_torch.tree import tree_leaves_with_path, tree_to


@contextlib.contextmanager
def count_all_reduces():
    """Count the ``torch.distributed.all_reduce`` calls made inside the
    block; yields a one-item list holding the count."""
    real, n = dist.all_reduce, [0]

    def counting(*args, **kwargs):
        n[0] += 1
        return real(*args, **kwargs)

    dist.all_reduce = counting
    try:
        yield n
    finally:
        dist.all_reduce = real


def _tree(flat: dict, device) -> dict:
    """``{"a/b": array}`` -> the nested tree of tensors on ``device``."""
    tree: dict = {}
    for key, x in flat.items():
        *head, last = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return tree


def _flat(tree) -> dict:
    return {"/".join(p): x.detach().cpu().numpy()
            for p, x in tree_leaves_with_path(tree)}


def exchange_cases(device, in_path: str, out_dir: str, cases) -> dict:
    """``in_path``: an ``.npz`` of leaves ``"a/b" -> [n, ...]``, row r
    this rank's leaf.  ``cases``: ``[(name, strategy, bucket_bytes,
    seed), ...]``.  Writes the exchanged tree of each case to
    ``out_dir/<name>-r<rank>.npz``; -> ``{name: all-reduces issued}``."""
    r = tdist.rank()
    with np.load(in_path) as z:
        tree = _tree({k: z[k][r] for k in z.files}, device)
    counts = {}
    for name, strategy, bucket_bytes, seed in cases:
        ex = Exchanger(strategy=strategy, bucket_bytes=bucket_bytes)
        with count_all_reduces() as n:
            out = ex.exchange(tree, seed=seed)
        counts[name] = n[0]
        np.savez(os.path.join(out_dir, f"{name}-r{r}.npz"), **_flat(out))
    return counts


class _Tap:
    """The trainer's exchanger, keeping its output and the all-reduces it
    issued at the first step."""

    def __init__(self, exchanger):
        self.exchanger = exchanger
        self.grads = None
        self.all_reduces = None

    def exchange(self, tree, seed=0):
        with count_all_reduces() as n:
            out = self.exchanger.exchange(tree, seed=seed)
        if self.grads is None:
            self.grads, self.all_reduces = out, n[0]
        return out


def bsp_run(device, job: dict) -> dict:
    """Steps of BSP on this rank.  ``job``: ``modelfile``, ``modelclass``,
    ``model_config``, ``rule_config`` (``BSP`` as ``init`` takes them);
    ``steps``; ``init``, a ``.pt`` of ``{"params", "state"}`` to start
    from (None: the model's seeded init); ``allow_tf32`` (None: PyTorch's
    flags as the process has them; a bool sets both the cuBLAS and the
    cuDNN flag, so spawned ranks compute as their caller does);
    ``batches``, an ``.npz`` of the
    global batches stacked ``[steps, B, ...]`` (None: the model's own
    epoch-0 batches); ``validate`` (bool); ``out``, a path prefix: rank r
    writes ``<out>-r<r>.pt`` with the params and state before the first
    step (``params0``, ``state0``), after it (``params1``, ``state1``) and
    at the end (``params``, ``state``), and the first step's exchanged
    grads (``grads1``), or only the keys listed in ``save`` (None: nothing
    written).  -> per-step metrics and host seconds (each
    step ends in a device sync), the first step's global grad norm and
    all-reduces, the exchange's wire bytes, the validation metrics, the
    kernels' launches over the steps and the rank's device."""
    from theanompi_torch import kernels as K
    from theanompi_torch.ops import flash_attention  # noqa: F401
    from theanompi_torch.ops import paged_attention  # noqa: F401
    from theanompi_torch.ops.opt import global_sq_norm
    from theanompi_torch.parallel.bsp import BSP

    if job.get("allow_tf32") is not None:
        torch.backends.cuda.matmul.allow_tf32 = bool(job["allow_tf32"])
        torch.backends.cudnn.allow_tf32 = bool(job["allow_tf32"])
    rule = BSP(dict(job.get("rule_config") or {})).init(
        devices=tdist.world(), modelfile=job["modelfile"],
        modelclass=job["modelclass"], model_config=job["model_config"],
        device=device)
    tr = rule.trainer
    if job.get("init"):
        trees = torch.load(job["init"])
        tr.params = tree_to(trees["params"], tr.device)
        tr.state = tree_to(trees["state"], tr.device)
        tr.opt_state = tr.model.init_opt_state(tr.optimizer, tr.params)
    tap = _Tap(tr.exchanger)
    tr.exchanger = tap
    tr.compile_iter_fns()
    steps = int(job["steps"])
    lo, hi = tr.rows(tr.global_batch)
    if job.get("batches"):
        with np.load(job["batches"]) as z:
            stacked = {k: z[k] for k in z.files}
        batches = ({k: v[i][lo:hi] for k, v in stacked.items()}
                   for i in range(steps))
    else:
        batches = tr.train_batches(0)
    lr = tr.model.adjust_hyperp(0)
    cuda = tr.device.type == "cuda"
    saved = {"params0": tr.params, "state0": tr.state}
    metrics, step_s = [], []
    for k in K.KERNELS:
        k.launches = 0
    for i, batch in zip(range(steps), batches):
        t0 = time.perf_counter()
        m = tr.train_iter(batch, lr)
        if cuda:
            torch.cuda.synchronize(tr.device)
        step_s.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            saved.update(params1=tr.params, state1=tr.state,
                         grads1=tap.grads)
    launches = {k.name: k.launches for k in K.KERNELS}
    if len(metrics) != steps:
        raise RuntimeError(f"{len(metrics)} batches for {steps} steps")
    val = tr.validate(0) if job.get("validate") else None
    if job.get("out"):
        saved.update(params=tr.params, state=tr.state)
        keep = job.get("save") or list(saved)
        torch.save(tree_to({k: saved[k] for k in keep}, "cpu"),
                   f"{job['out']}-r{tdist.rank()}.pt")
    return {"metrics": metrics, "step_s": step_s,
            "grad_norm": float(torch.sqrt(global_sq_norm(tap.grads))),
            "all_reduces": tap.all_reduces,
            "grad_leaves": len(flatten(tap.grads)),
            "wire_bytes": tap.exchanger.wire_bytes(tr.params,
                                                   tr.n_workers),
            "val": val, "launches": launches, "device": str(tr.device),
            "global_batch": tr.global_batch}


def pmean_case(device, in_path: str) -> tuple[dict, int]:
    """:func:`fused_pmean` of this rank's rows of ``in_path`` (as in
    :func:`exchange_cases`); -> (the result, the all-reduces issued)."""
    r = tdist.rank()
    with np.load(in_path) as z:
        tree = _tree({k: z[k][r] for k in z.files}, device)
    with count_all_reduces() as n:
        out = fused_pmean(tree)
    return _flat(out), n[0]


def loaded_modules(device, prefixes) -> list:
    """The modules of this rank whose top-level package is one of
    ``prefixes`` (what the wall tests read: a rank imports no JAX)."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in prefixes)


JOBS = {"exchange_cases": exchange_cases, "bsp_run": bsp_run,
        "pmean_case": pmean_case, "loaded_modules": loaded_modules}


def run_all(device, calls) -> list:
    """Several jobs in one spawn: ``calls`` is ``[(job name, args tuple),
    ...]`` (names in :data:`JOBS`); -> their results in order."""
    return [JOBS[name](device, *args) for name, args in calls]
