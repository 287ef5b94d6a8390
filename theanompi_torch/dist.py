"""Process groups: one process per card under ``torch.distributed``.

Counterpart of the mesh half of ``theanompi_tpu/parallel/mesh.py``.  The
reference traces one program over an N-device ``data`` mesh
(``make_mesh`` :122), folds the replica index into its PRNG keys
(``replica_rng`` :243) and fakes an N-chip mesh on the host for its tests
(``force_host_devices`` :49).  The port runs N processes instead, one per
card, joined in the default process group; this module is their setup:

- :func:`init` / :func:`teardown` join and leave the group from the
  ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``
  variables, which :func:`spawn` sets and ``torchrun`` sets the same way.
  The backend is the caller's: ``"nccl"`` for CUDA ranks, ``"gloo"`` for
  CPU ranks (and for ranks that share one card, which NCCL refuses).  A
  backend that fails to initialise fails the run; none stands in for
  another.
- :func:`rank`, :func:`world`, :func:`local_rank`: 0, 1 and 0 when no
  group is initialised, so every single-process caller is unchanged.
- :func:`replica_key`: the parts a per-rank random stream appends to its
  seed (none at a world of 1, where a stream stays the one-process one).
- :func:`all_reduce_sum`: a summing all-reduce that autograd runs through
  (its backward sums the cotangents over the group, the transpose of the
  reference's ``psum`` inside ``shard_map``), for sync-BN.
- :func:`spawn`: N local ranks on a TCP store at 127.0.0.1 on a free port
  (the test suite's N-rank "mesh" is N gloo ranks on the CPU).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_lib
import socket
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

#: the reference's data-parallel mesh axis: here, the process group
DATA_AXIS = "data"

#: a collective that waits longer than this fails instead of hanging
COLLECTIVE_TIMEOUT_S = 600


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index among the ranks of its host (its card)."""
    if not dist.is_initialized():
        return 0
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def replica_key() -> tuple:
    """Parts to append to a random stream's seed so that each rank draws
    its own (the reference's fold of the replica index); empty at a world
    of 1."""
    return () if world() == 1 else ("rank", rank())


def init(backend: str) -> None:
    """Join the default process group from the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK``
    picks the card under NCCL)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    missing = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if v not in os.environ]
    if missing:
        raise RuntimeError(f"process group: {missing} not set (start the "
                           f"ranks with theanompi_torch.dist.spawn or "
                           f"torchrun)")
    kwargs = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs CUDA")
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                       os.environ["RANK"])))
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    dist.init_process_group(
        backend, init_method="env://",
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S), **kwargs)


def teardown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out)
        return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the group, differentiable: the cotangent is
    summed over the group too."""
    return _AllReduceSum.apply(x)


def rank_device(device, local: int) -> torch.device:
    """The device of local rank ``local`` for a requested ``device``:
    ``"cpu"`` as is, ``"cuda"`` (no index) the rank's own card
    ``cuda:<local>`` (with more ranks than cards, the ranks take the cards
    in turn: ``cuda:<local mod count>``, over gloo), ``"cuda:K"`` that card
    for every rank (ranks that share a card run gloo)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local % max(1, torch.cuda.device_count()))
    return dev


def group_layout(n: int, device=None) -> tuple[str, str]:
    """-> (backend, device) for ``n`` local ranks of a harness (rulecomp,
    converge): ``device`` ``"cpu"`` gloo ranks on the host; otherwise one
    card a rank under NCCL where there are cards enough, else gloo ranks
    taking the cards in turn (NCCL refuses two ranks on one card)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo", "cpu"
    dev = torch.device(device or "cuda")
    if dev.index is None and n <= torch.cuda.device_count():
        return "nccl", "cuda"
    return "gloo", str(dev)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, r, n, port, backend, device, args, results):
    os.environ.update({"RANK": str(r), "WORLD_SIZE": str(n),
                       "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    dev = rank_device(device, r)
    if dev.type == "cpu":
        # N ranks share the host's cores: one thread each
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    try:
        init(backend)
        results.put((r, True, fn(dev, *args)))
    except BaseException:  # reported to the parent, which raises it
        results.put((r, False, traceback.format_exc()))
    finally:
        teardown()


def spawn(fn, n: int, backend: str, device, args: tuple = (),
          timeout_s: float = 1800.0) -> list:
    """Run ``fn(device, *args)`` on ``n`` local ranks, each a fresh
    process (``spawn`` start method) in one process group; -> the ranks'
    return values, in rank order.  ``fn`` must be importable by name and
    its arguments and result picklable.  Raises ``RuntimeError`` with the
    first failing rank's traceback when a rank fails, dies or outlives
    ``timeout_s``; every process started is ended before it returns."""
    if n < 1:
        raise ValueError(f"n={n}: at least one rank")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    # not daemonic: a rank may start processes of its own (the loader
    # pool); the ``finally`` below ends every rank whatever happens
    procs = [ctx.Process(target=_child, daemon=False,
                         args=(fn, r, n, port, backend, device, args,
                               results))
             for r in range(n)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    failure = None
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < n and failure is None:
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in out and not p.is_alive()]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode} and no result")
                elif time.monotonic() > deadline:
                    failure = f"ranks still running after {timeout_s} s"
                continue
            if ok:
                out[r] = value
            else:
                failure = f"rank {r} failed:\n{value}"
    finally:
        for p in procs:
            p.join(timeout=30 if failure is None else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if failure is not None:
        raise RuntimeError(f"dist.spawn({getattr(fn, '__name__', fn)}, "
                           f"n={n}, {backend}): {failure}")
    return [out[r] for r in range(n)]
