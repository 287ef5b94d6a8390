"""Jobs for every rank of a spawned process group, driven from files.

:func:`theanompi_torch.dist.spawn` runs one of these on each rank.  Their
inputs and outputs are files (``.npz`` of numpy arrays, ``.pt`` of param
trees), so a caller that holds other state (a test module with the JAX
reference loaded, ``chip_smoke.py``) hands the ranks plain data, and the
ranks import neither it nor JAX.  Each also runs at a world of 1, without
a group: the one-process run they are held against.

- :func:`exchange_cases` — the exchanger on per-rank inputs, fused or
  with the buckets issued as backward would issue them;
- :func:`zero1_update_cases` — ``zero1``'s fused exchange and update on
  per-rank grads, for an optimizer;
- :func:`bsp_run` — steps of the BSP rule, through ``BSP().init`` on each
  rank, with what the checks need from the first step;
- :func:`launch` — one launcher run on each rank (``launcher.run_rank``:
  training, checkpoints, resume), what ``--devices N`` runs;
- :func:`async_run` — steps of an async rule (EASGD, LocalSGD, GOSGD)
  on each rank, with its worker, center and weights after chosen steps;
- :func:`rule_exchange_cases` — the async rules' exchanges (elastic,
  average, a gossip round under a transport) of per-rank inputs;
- :func:`warmup_case` — a rule's ``warmup`` against a fresh init;
  :func:`compare_rules` — the rule comparison's grid on each rank;
- :func:`pmean_case`, :func:`loaded_modules`, and :func:`run_all`, which
  runs several jobs in one spawn.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from theanompi_torch import dist as tdist
from theanompi_torch.ops import opt as opt_lib
from theanompi_torch.parallel.exchanger import (
    BucketExchange,
    Exchanger,
    flatten,
    fused_pmean,
)
from theanompi_torch.tree import tree_leaves_with_path, tree_to

#: the collectives the exchange issues
COLLECTIVES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor")


@contextlib.contextmanager
def count_collectives(counts=None):
    """Count the ``torch.distributed`` all-reduces, reduce-scatters and
    all-gathers called inside the block, by name, into ``counts`` (a
    ``Counter``; a new one if None), which it yields."""
    counts = collections.Counter() if counts is None else counts
    real = {name: getattr(dist, name) for name in COLLECTIVES}

    def counting(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return real[name](*args, **kwargs)
        return call

    for name in COLLECTIVES:
        setattr(dist, name, counting(name))
    try:
        yield counts
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


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
    return {"/".join(map(str, p)): x.detach().cpu().numpy()
            for p, x in tree_leaves_with_path(tree)}


def exchange_cases(device, in_path: str, out_dir: str, cases) -> dict:
    """``in_path``: an ``.npz`` of leaves ``"a/b" -> [n, ...]``, row r
    this rank's leaf.  ``cases``: ``[(name, strategy, bucket_bytes,
    seed[, overlap]), ...]``; with ``overlap`` the buckets are issued as
    backward's hooks issue them: leaf by leaf in reverse order, each
    bucket once complete, in reverse layout order.  Writes the exchanged
    tree of each case to ``out_dir/<name>-r<rank>.npz``; -> ``{name:
    all-reduces issued}``."""
    r = tdist.rank()
    with np.load(in_path) as z:
        tree = _tree({k: z[k][r] for k in z.files}, device)
    counts = {}
    for name, strategy, bucket_bytes, seed, *overlap in cases:
        ex = Exchanger(strategy=strategy, bucket_bytes=bucket_bytes,
                       overlap=bool(overlap and overlap[0]))
        with count_collectives() as n:
            inflight = None
            if ex.overlap:
                inflight = BucketExchange(ex, tree, seed, reverse=True)
                leaves = flatten(tree)
                for i in reversed(range(len(leaves))):
                    if leaves[i].is_floating_point():
                        inflight.put(i, leaves[i])
            out = ex.exchange(tree, seed=seed, inflight=inflight)
        counts[name] = n["all_reduce"]
        np.savez(os.path.join(out_dir, f"{name}-r{r}.npz"), **_flat(out))
    return counts


def zero1_update_cases(device, in_path: str, out_dir: str, cases) -> None:
    """``in_path``: an ``.npz`` of this rank's grads (``"g/a/b" -> [n,
    ...]``, row r this rank's) and the params (``"p/a/b"``, the same on
    every rank).  ``cases``: ``[(name, optimizer class name in
    theanompi_torch.ops.opt, its keyword arguments, bucket_bytes, lr,
    steps), ...]``: ``steps`` of ``Exchanger("zero1")``'s
    ``exchange_and_update`` of the same grads from
    ``zero1_init_opt_state``.  Writes ``{"params", "opt_state"}`` (this
    rank's) to ``out_dir/<name>-r<rank>.pt``."""
    r = tdist.rank()
    with np.load(in_path) as z:
        grads = _tree({k[2:]: z[k][r] for k in z.files
                       if k.startswith("g/")}, device)
        params0 = _tree({k[2:]: z[k] for k in z.files
                         if k.startswith("p/")}, device)
    for name, rule, kwargs, bucket_bytes, lr, steps in cases:
        opt = getattr(opt_lib, rule)(**kwargs)
        ex = Exchanger("zero1", bucket_bytes=bucket_bytes)
        params = params0
        state = ex.zero1_init_opt_state(opt, params, tdist.world())
        for _ in range(steps):
            params, state = ex.exchange_and_update(grads, state, params, lr,
                                                   opt)
        torch.save(tree_to({"params": params, "opt_state": state}, "cpu"),
                   os.path.join(out_dir, f"{name}-r{r}.pt"))


class _Tap:
    """The trainer's exchanger, watched at the first step (``watch``):
    the collectives the exchange issues, by name (those the overlapped
    exchange issues from backward too, but not sync-BN's), and what it
    gives back: the exchanged grads, or under ``zero1`` this rank's mean
    shard of each bucket (``shards``, in the order they landed).
    ``from_backward`` counts the buckets whose collective was issued
    before the step called the exchange: from backward's hooks.

    The exchanger runs as it is; the tap stands in front of its
    ``exchange`` and ``exchange_and_update`` and, on the instance, of its
    :meth:`~Exchanger.start_bucket`, which every bucketed exchange issues
    through."""

    def __init__(self, exchanger):
        self.exchanger = exchanger
        self.watch = True
        self.grads = None
        self.shards: list = []
        self.collectives = collections.Counter()
        self.from_backward = 0
        self._inside = False
        exchanger.start_bucket = self._start_bucket

    def __getattr__(self, name):
        return getattr(self.exchanger, name)

    @contextlib.contextmanager
    def _counting(self):
        """Count the block's collectives, once however deep it nests."""
        if not self.watch or self._inside:
            yield
            return
        self._inside = True
        try:
            with count_collectives(self.collectives):
                yield
        finally:
            self._inside = False

    def _done(self):
        self.watch = False
        del self.exchanger.start_bucket  # the class's again

    def _start_bucket(self, buf, seed):
        if self.watch and not self._inside:
            self.from_backward += 1
        with self._counting():
            pending = type(self.exchanger).start_bucket(self.exchanger, buf,
                                                        seed)
        if self.watch and self.exchanger.fuses_update:
            finish = pending.finish

            def keep():
                out = finish()
                self.shards.append(out)
                return out

            pending.finish = keep
        return pending

    def exchange(self, tree, seed=0, inflight=None):
        with self._counting():
            out = self.exchanger.exchange(tree, seed=seed, inflight=inflight)
        if self.watch:
            self.grads = out
            self._done()
        return out

    def exchange_and_update(self, *args, **kwargs):
        with self._counting():
            out = self.exchanger.exchange_and_update(*args, **kwargs)
        if self.watch:
            self._done()
        return out

    def grad_norm(self) -> float:
        """The global norm of the first step's exchanged grads: under
        ``zero1`` one all-reduce of the shards' squared norms."""
        if not self.shards:
            return float(torch.sqrt(opt_lib.global_sq_norm(self.grads)))
        sq = sum(s.float().square().sum() for s in self.shards)
        if tdist.world() > 1:
            dist.all_reduce(sq)
        return float(torch.sqrt(sq))


_INT_OF_SIZE = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def digest(tree) -> int:
    """A 64-bit checksum of the bits of ``tree``'s tensors, each element
    weighted by its position (bit-equal trees give equal checksums;
    computed on the tensors' device)."""
    total = 0
    for k, (_, x) in enumerate(tree_leaves_with_path(tree)):
        bits = x.detach().reshape(-1).view(_INT_OF_SIZE[x.element_size()])
        weights = torch.arange(1, bits.numel() + 1, device=bits.device)
        total = total + (bits.long() * weights * (2 * k + 1)).sum()
    return int(total)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size()
               for _, x in tree_leaves_with_path(tree)
               if isinstance(x, torch.Tensor))


def bsp_run(device, job: dict) -> dict:
    """Steps of BSP on this rank.  ``job``: ``modelfile``, ``modelclass``,
    ``model_config``, ``rule_config`` (``BSP`` as ``init`` takes them);
    ``steps``; ``init``, a ``.pt`` of ``{"params", "state"}`` to start
    from (None: the model's seeded init); ``allow_tf32`` (None: PyTorch's
    flags as the process has them; a bool sets both the cuBLAS and the
    cuDNN flag, so spawned ranks compute as their caller does);
    ``batches``, an ``.npz`` of the
    global batches stacked ``[steps, B, ...]`` (None: the model's own
    epoch-0 batches, through the trainer's prefetcher); ``validate`` (bool); ``out``, a path prefix: rank r
    writes ``<out>-r<r>.pt`` with the params and state before the first
    step (``params0``, ``state0``), after it (``params1``, ``state1``) and
    at the end (``params``, ``state``), and the first step's exchanged
    grads (``grads1``), or only the keys listed in ``save`` (None: nothing
    written), on the ranks listed in ``save_ranks`` (None: every rank),
    with the rank's optimizer state at the end (``opt_state``) beside
    them.  ``grads1`` is None under ``zero1``, which never forms the
    exchanged grads whole.  -> per-step metrics, host seconds (each
    step ends in a device sync) and the params' checksum after each step
    (:func:`digest`), the first step's global grad norm (exchanged) and
    exchange collectives by name (``all_reduces`` among them) and the
    buckets whose collective backward's hooks issued, the exchange's wire
    bytes, the optimizer state's bytes on the rank, its ``grad_clip``, the
    validation metrics, the kernels' launches over the steps, the
    rank's device and where its batches arrived (``batch_devices``: the
    prefetcher places them on the rank's device)."""
    from theanompi_torch.ops import flash_attention  # noqa: F401
    from theanompi_torch.ops import paged_attention  # noqa: F401
    from theanompi_torch.parallel.bsp import BSP
    from theanompi_torch.parallel.trainer import close_feed

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
        tr.opt_state = tr.init_opt_state()
    tr._maybe_ramp(0)
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
        # the trainer's own feed: the prefetcher, rule key ``prefetch``
        batches = tr._make_prefetcher(0)
    try:
        return _bsp_steps(tr, tap, batches, job)
    finally:
        close_feed(batches)
        tr.model.cleanup()  # the loader pool's processes, if any


def _bsp_steps(tr, tap, batches, job) -> dict:
    """:func:`bsp_run`'s steps, on ``batches``."""
    from theanompi_torch import kernels as K

    steps = int(job["steps"])
    lr = tr.model.adjust_hyperp(0)
    cuda = tr.device.type == "cuda"
    saved = {"params0": tr.params, "state0": tr.state}
    metrics, step_s, digests = [], [], []
    for k in K.KERNELS:
        k.launches = 0
    fed = set()  # where the batches arrived: "host" or a device
    for i, batch in zip(range(steps), batches):
        fed.update(str(x.device) if isinstance(x, torch.Tensor) else "host"
                   for x in batch.values())
        t0 = time.perf_counter()
        m = tr.train_iter(batch, lr)
        if cuda:
            torch.cuda.synchronize(tr.device)
        step_s.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        digests.append(digest(tr.params))
        if i == 0:
            saved.update(params1=tr.params, state1=tr.state,
                         grads1=tap.grads)
    launches = {k.name: k.launches for k in K.KERNELS}
    if len(metrics) != steps:
        raise RuntimeError(f"{len(metrics)} batches for {steps} steps")
    val = tr.validate(0) if job.get("validate") else None
    ranks = job.get("save_ranks")
    if job.get("out") and (ranks is None or tdist.rank() in ranks):
        saved.update(params=tr.params, state=tr.state,
                     opt_state=tr.opt_state)
        keep = job.get("save") or list(saved)
        torch.save(tree_to({k: saved[k] for k in keep}, "cpu"),
                   f"{job['out']}-r{tdist.rank()}.pt")
    return {"metrics": metrics, "step_s": step_s, "digests": digests,
            "grad_norm": tap.grad_norm(),
            "collectives": dict(tap.collectives),
            "all_reduces": tap.collectives["all_reduce"],
            "buckets_from_backward": tap.from_backward,
            "grad_leaves": len(flatten(tr.params)),
            "wire_bytes": tap.exchanger.wire_bytes(tr.params,
                                                   tr.n_workers),
            "opt_state_bytes": _nbytes(tr.opt_state),
            "grad_clip": tr.optimizer.grad_clip,
            "val": val, "launches": launches, "device": str(tr.device),
            "batch_devices": sorted(fed),
            "global_batch": tr.global_batch}


def pmean_case(device, in_path: str) -> tuple[dict, int]:
    """:func:`fused_pmean` of this rank's rows of ``in_path`` (as in
    :func:`exchange_cases`); -> (the result, the all-reduces issued)."""
    r = tdist.rank()
    with np.load(in_path) as z:
        tree = _tree({k: z[k][r] for k in z.files}, device)
    with count_collectives() as n:
        out = fused_pmean(tree)
    return _flat(out), n["all_reduce"]


def loaded_modules(device, prefixes) -> list:
    """The modules of this rank whose top-level package is one of
    ``prefixes`` (what the wall tests read: a rank imports no JAX)."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in prefixes)


def launch(device, job: dict) -> tuple:
    """``theanompi_torch.launcher.run_rank(device, job)`` on this rank
    (``job``: ``modelfile``, ``modelclass``, ``model_config``,
    ``rule_config``, as the launcher builds them), after ``allow_tf32``
    (as :func:`bsp_run`'s) and ``deterministic`` (True: cuDNN picks only
    deterministic algorithms, so a run repeats bit for bit).  -> the
    launcher's (exit code, final validation metrics on rank 0, what the
    run printed on this rank's standard output)."""
    import contextlib
    import io

    from theanompi_torch.launcher import run_rank

    if job.get("allow_tf32") is not None:
        torch.backends.cuda.matmul.allow_tf32 = bool(job["allow_tf32"])
        torch.backends.cudnn.allow_tf32 = bool(job["allow_tf32"])
    if job.get("deterministic"):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code, val = run_rank(device, job)
    return code, val, out.getvalue()


def _load_init(tr, path: str) -> None:
    """Start ``tr`` from the ``{"params", "state"}`` of ``path``: the
    optimizer state fresh, an async rule's center that init too."""
    trees = torch.load(path)
    tr.params = tree_to(trees["params"], tr.device)
    tr.state = tree_to(trees["state"], tr.device)
    tr.opt_state = tr.init_opt_state()
    if getattr(tr, "center", None) is not None:
        tr.center = tree_to(trees["params"], tr.device)


def async_run(device, job: dict) -> dict:
    """Steps of an async rule on this rank.  ``job``: ``rule`` (``EASGD``,
    ``LocalSGD`` or ``GOSGD``), ``modelfile``, ``modelclass``,
    ``model_config``, ``rule_config`` (as ``init`` takes them);
    ``steps``; ``init`` (as :func:`bsp_run`'s); ``batches``, an ``.npz``
    of the global batches stacked ``[steps, B, ...]`` (None: the model's
    epoch-0 batches); ``allow_tf32`` (as :func:`bsp_run`'s); ``validate``
    (bool: the validation metrics on ``eval_args`` after the steps);
    ``save_at``, the steps after which rank r writes ``<out>-r<r>-s<i>.pt``
    (params, state, and ``center`` or ``weights``); ``print_freq`` (the
    recorder's; 1 fences every step's ``calc`` and ``comm``).  -> per-step
    metrics, host seconds a step (each ends in a device sync), the
    recorder's ``comm`` seconds a step (0 where no exchange ran), the
    drift from the center before each EASGD exchange, the params'
    checksums (:func:`digest`) after each step's local update and after
    the step, the center's after each step, the weight after
    each step (GOSGD), the validation metrics, the kernels' launches over
    the steps, peak device bytes and the gossip transport."""
    import theanompi_torch
    from theanompi_torch import kernels as K
    from theanompi_torch.ops import flash_attention  # noqa: F401
    from theanompi_torch.ops import paged_attention  # noqa: F401
    from theanompi_torch.parallel.easgd import worker_drift

    if job.get("allow_tf32") is not None:
        torch.backends.cuda.matmul.allow_tf32 = bool(job["allow_tf32"])
        torch.backends.cudnn.allow_tf32 = bool(job["allow_tf32"])
    rule_config = {"verbose": False, **(job.get("rule_config") or {})}
    if job.get("print_freq"):
        rule_config["print_freq"] = job["print_freq"]
    rule = getattr(theanompi_torch, job["rule"])(rule_config).init(
        devices=tdist.world(), modelfile=job["modelfile"],
        modelclass=job["modelclass"], model_config=job["model_config"],
        device=device)
    tr = rule.trainer
    if job.get("init"):
        _load_init(tr, job["init"])
    steps = int(job["steps"])
    lo, hi = tr.rows(tr.global_batch)
    if job.get("batches"):
        with np.load(job["batches"]) as z:
            stacked = {k: z[k] for k in z.files}
        batches = [{k: v[i][lo:hi] for k, v in stacked.items()}
                   for i in range(steps)]
    else:
        gen = tr.train_batches(0)
        batches = [b for _, b in zip(range(steps), gen)]
        gen.close()
    cuda = tr.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(tr.device)
        torch.cuda.reset_peak_memory_stats(tr.device)
    lr = tr.model.adjust_hyperp(0)
    save_at = set(job.get("save_at") or ())
    center = getattr(tr, "center", None) is not None
    out = {"metrics": [], "step_s": [], "comm_s": [], "drift": [],
           "digests": [], "pre_digests": [], "center_digests": [],
           "weights": []}
    exchange = tr.post_step

    def post_step():  # the worker's params before the step's exchange
        out["pre_digests"].append(digest(tr.params))
        exchange()

    tr.post_step = post_step
    for k in K.KERNELS:
        k.launches = 0
    for i, batch in enumerate(batches, 1):
        if center and i % tr.tau == 0:
            out["drift"].append(float(worker_drift(tr.params, tr.center)))
        t0 = time.perf_counter()
        m = tr.train_iter(batch, lr)
        if cuda:
            torch.cuda.synchronize(tr.device)
        out["step_s"].append(time.perf_counter() - t0)
        out["comm_s"].append(tr.recorder.time_history["comm"][-1])
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["digests"].append(digest(tr.params))
        if center:
            out["center_digests"].append(digest(tr.center))
        if getattr(tr, "weights", None) is not None:
            out["weights"].append(float(tr.weights))
        if job.get("out") and i in save_at:
            keep = {"params": tr.params, "state": tr.state}
            keep.update({k: getattr(tr, k) for k in ("center", "weights")
                         if getattr(tr, k, None) is not None})
            torch.save(tree_to(keep, "cpu"),
                       f"{job['out']}-r{tdist.rank()}-s{i}.pt")
    out["launches"] = {k.name: k.launches for k in K.KERNELS}
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(tr.device)
                         if cuda else 0)
    out["val"] = tr.validate(0) if job.get("validate") else None
    out["transport"] = getattr(tr, "transport", None)
    out["device"] = str(tr.device)
    out["global_batch"] = tr.global_batch
    out["effective_lr"] = tr.model.config.get("lr")
    return out


def warmup_case(device, job: dict) -> dict:
    """``trainer.warmup()`` of a rule on this rank (``job``: ``rule``,
    ``modelfile``, ``modelclass``, ``model_config``, ``rule_config``):
    -> the checksums (:func:`digest`) of the params, state, optimizer
    state and the rule's center or weights after ``init``, after one step
    and after ``warmup``, and the counters after it."""
    import theanompi_torch

    rule = getattr(theanompi_torch, job["rule"])(
        {"verbose": False, **job.get("rule_config", {})}).init(
        devices=tdist.world(), modelfile=job["modelfile"],
        modelclass=job["modelclass"], model_config=job["model_config"],
        device=device)
    tr = rule.trainer

    def sums():
        return {k: digest(v) for k, v in tr.checkpoint_trees().items()}

    fresh = sums()
    gen = tr.train_batches(0)
    tr.train_iter(next(iter(gen)), tr.model.adjust_hyperp(0))
    gen.close()
    stepped = sums()
    tr.init_state()
    tr.reset_iter()
    tr.warmup()
    return {"fresh": fresh, "stepped": stepped, "warm": sums(),
            "iteration": tr.iteration, "epoch": tr.epoch,
            "comm_segments": len(tr.recorder.time_history["comm"])}


def rule_exchange_cases(device, in_path: str, out_dir: str, cases) -> None:
    """The async rules' exchanges on per-rank inputs.  ``in_path``: an
    ``.npz`` of a worker tree ``"p/a/b" -> [n, ...]`` (row r this rank's),
    a center ``"c/a/b"`` (the same on every rank) and ``"w"`` ``[n]``
    (the ranks' gossip weights).  ``cases``: ``[(name, "elastic",
    alpha) | (name, "average") | (name, "gossip", push mask, shift,
    transport), ...]``, each from the inputs: EASGD's
    :func:`~theanompi_torch.parallel.easgd.elastic_exchange`, LocalSGD's
    average, one :func:`~theanompi_torch.parallel.gosgd.gossip_merge`.
    Writes ``out_dir/<name>-r<rank>.npz``: the new worker tree (``p/``)
    and center (``c/``) or weight (``w``)."""
    from theanompi_torch.parallel.easgd import elastic_exchange
    from theanompi_torch.parallel.gosgd import gossip_merge
    from theanompi_torch.parallel.trainer import pmean_floats

    r = tdist.rank()
    with np.load(in_path) as z:
        params = _tree({k[2:]: z[k][r] for k in z.files
                        if k.startswith("p/")}, device)
        center = _tree({k[2:]: z[k] for k in z.files
                        if k.startswith("c/")}, device)
        weight = torch.from_numpy(np.array(z["w"][r])).to(device)
    for name, kind, *args in cases:
        if kind == "elastic":
            p, c = elastic_exchange(params, center, float(args[0]))
            out = {**{f"c/{k}": v for k, v in _flat(c).items()}}
        elif kind == "average":
            with torch.no_grad():
                p = pmean_floats(params)
            out = {}
        else:
            push, shift, transport = args
            p, w = gossip_merge(params, weight, np.asarray(push, np.float32),
                                int(shift), transport)
            out = {"w": w.cpu().numpy()}
        out.update({f"p/{k}": v for k, v in _flat(p).items()})
        np.savez(os.path.join(out_dir, f"{name}-r{r}.npz"), **out)


def compare_rules(device, kwargs: dict) -> dict:
    """:func:`theanompi_torch.utils.rulecomp.compare_rules` on this rank
    (``kwargs`` its arguments but the device)."""
    from theanompi_torch.utils import rulecomp

    return rulecomp.compare_rules(device=device, **kwargs)


JOBS = {"exchange_cases": exchange_cases, "bsp_run": bsp_run,
        "launch": launch, "async_run": async_run,
        "rule_exchange_cases": rule_exchange_cases,
        "warmup_case": warmup_case, "compare_rules": compare_rules,
        "zero1_update_cases": zero1_update_cases, "pmean_case": pmean_case,
        "loaded_modules": loaded_modules}


def run_all(device, calls) -> list:
    """Several jobs in one spawn: ``calls`` is ``[(job name, args tuple),
    ...]`` (names in :data:`JOBS`); -> their results in order."""
    return [JOBS[name](device, *args) for name, args in calls]
