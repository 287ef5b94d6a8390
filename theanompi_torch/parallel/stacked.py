"""The async rules' shared layout: every rank keeps its own worker.

Counterpart of what ``theanompi_tpu/parallel/trainer.py`` gives EASGD and
GOSGD: ``stack_for_workers`` (:317), ``unstack``/``restack`` and
``make_local_step(stacked=True)`` (:76).  The reference keeps a stacked
``[n, ...]`` tree sharded over the ``data`` axis, row i on worker i's
device; the port keeps rank r's own row on rank r's card, and steps it
with the collective-free local step (:func:`~theanompi_torch.parallel.
trainer.make_train_step` with no exchanger).  Every worker starts from the
same init.

Checkpoints keep the reference's layout (``theanompi_tpu/utils/
checkpoint.py:465-471``), so an async run written by either package
resumes in the other: ``params``, ``state`` and ``opt_state`` (and GOSGD's
``weights``) as ``[n, ...]`` arrays in rank order, gathered from every
rank to rank 0 (:func:`gather_rows`, one ``all_gather_into_tensor`` a
dtype, as ``zero1``'s save gathers its buckets); the rule's replicated
trees (EASGD's ``center``) as they are.  On resume rank r takes row r.  A
resume at another worker count is refused by the run fingerprint (the
reshard comes with the resilience slice).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from theanompi_torch import dist as tdist
from theanompi_torch.convert import train_state_from_jax, train_state_to_jax
from theanompi_torch.parallel.exchanger import flatten, unflatten
from theanompi_torch.parallel.trainer import (
    BaseTrainer,
    Rule,
    pmean_floats,
    require_data_parallel_mesh,
)
from theanompi_torch.tree import tree_leaves_with_path, tree_map


def gather_rows(tree):
    """-> ``tree`` with each tensor leaf ``[n, *shape]``: row r rank r's
    leaf, on the host.  A collective: every rank calls it, and every rank
    gets the rows (one ``all_gather_into_tensor`` a dtype)."""
    leaves = flatten(tree)
    n = tdist.world()
    if n == 1:
        return unflatten(tree, [x.detach()[None].cpu().clone()
                                for x in leaves])
    groups: dict = {}
    for i, x in enumerate(leaves):
        groups.setdefault(x.dtype, []).append(i)
    out = list(leaves)
    for idx in groups.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        buf = flat.new_empty(n * flat.numel())
        dist.all_gather_into_tensor(buf, flat)
        rows = buf.view(n, -1).cpu()
        off = 0
        for i in idx:
            k = leaves[i].numel()
            out[i] = rows[:, off:off + k].reshape(
                n, *leaves[i].shape).contiguous()
            off += k
    return unflatten(tree, out)


def encode_stacked(trees: dict, stacked) -> dict:
    """The trainer's checkpoint trees -> the reference's flat leaves: a
    tree named in ``stacked`` holds ``[n, ...]`` rows, each converted to
    the reference's layout (conv kernels HWIO) and stacked again."""
    out = {}
    for name, tree in trees.items():
        if name not in stacked:
            out.update(train_state_to_jax({name: tree}))
            continue
        n = next((x.shape[0] for _, x in tree_leaves_with_path(tree)), 0)
        rows = [train_state_to_jax({name: tree_map(lambda x, r=r: x[r],
                                                   tree)})
                for r in range(n)]
        out.update({k: np.stack([row[k] for row in rows])
                    for k in (rows[0] if rows else {})})
    return out


def decode_stacked(arrays: dict, templates: dict, stacked, rank: int,
                   n: int) -> dict:
    """The reference's flat leaves -> trees like ``templates``: row
    ``rank`` of every leaf of a tree named in ``stacked`` (each must hold
    ``n`` rows), the others as they are."""
    mine = {}
    for key, arr in arrays.items():
        if key.split("::", 1)[0] in stacked:
            if arr.ndim == 0 or arr.shape[0] != n:
                raise ValueError(
                    f"checkpoint leaf {key!r} shape {arr.shape}: not the "
                    f"stacked layout of {n} worker(s)")
            arr = arr[rank]
        mine[key] = arr
    return train_state_from_jax(mine, templates)


class AsyncTrainer(BaseTrainer):
    """A rank's own worker: no exchanger, the same init on every rank,
    the stacked checkpoint layout.  Subclasses add the exchange
    (``post_step``, ``warmup_exchange``) and what validation evaluates
    (``eval_args``).  ``n_model``, ``n_seq`` and ``n_pipe`` above 1 are
    refused (:func:`require_data_parallel_mesh`).  The step's metrics are
    the worker's own; the recorder averages them over the workers at
    print boundaries (:meth:`_workers_mean`), as the reference averages
    its stacked metrics at print time."""

    #: the checkpoint trees that hold one row a worker
    STACKED: tuple = ("params", "state", "opt_state")

    def __init__(self, model, n_model: int = 1, n_seq: int = 1,
                 n_pipe: int = 1, **kwargs):
        require_data_parallel_mesh(
            {"n_model": n_model, "n_seq": n_seq, "n_pipe": n_pipe},
            type(self).__name__)
        super().__init__(model, **kwargs)
        self.recorder.reduce = self._workers_mean

    def _workers_mean(self, accum: dict) -> dict:
        """A print window's per-step metrics, each step's averaged over
        the workers (one collective)."""
        return pmean_floats({
            k: torch.stack([torch.as_tensor(x, device=self.device).float()
                            for x in v]) for k, v in accum.items()})

    def _timed_exchange(self, exchange) -> None:
        """``exchange()`` inside the recorder's ``comm`` segment; the
        tensor it returns fences the segment at print boundaries (as the
        step's ``calc``), so there it is device time."""
        r = self.recorder
        r.start("comm")
        fence = exchange()
        r.end("comm", fence=fence if self.iteration % r.print_freq == 0
              else None)

    # -- checkpoints ----------------------------------------------------------
    def save_checkpoint(self, epoch: int, completed: bool = True):
        """Every rank's rows gathered to rank 0 (a collective: every rank
        calls this), which writes them beside the replicated trees."""
        if self.checkpointer is None:
            return None
        trees = self.checkpoint_trees()
        gathered = {k: gather_rows(trees[k]) for k in self.STACKED}
        if self.rank != 0:
            return None
        trees.update(gathered)
        return self.checkpointer.save(
            epoch, self.iteration, trees,
            recorder_snapshot=self.recorder.history_snapshot(),
            lr_scale=self.lr_scale,
            data_state=self._data_state(epoch, completed),
            handed_over=[x for t in gathered.values()
                         for _, x in tree_leaves_with_path(t)])

    def reserve_checkpoint_staging(self) -> None:
        """Pinned staging for the replicated trees on the card (the rows
        arrive on the host)."""
        if self.checkpointer is None or self.rank != 0:
            return
        self.checkpointer.reserve({k: v for k, v in
                                   self.checkpoint_trees().items()
                                   if k not in self.STACKED})

    def _encode(self, trees: dict) -> dict:
        return encode_stacked(trees, self.STACKED)

    def _decode(self, arrays: dict, templates: dict) -> dict:
        return decode_stacked(arrays, templates, self.STACKED, self.rank,
                              self.n_workers)


class AsyncRule(Rule):
    """A rule of :class:`AsyncTrainer` s: refuses sharded axes first."""

    trainer_cls = AsyncTrainer

    def check_config(self) -> None:
        require_data_parallel_mesh(self.config, self.trainer_cls.__name__)

    def async_kwargs(self) -> dict:
        return {k: self.config.get(k, 1) for k in ("n_model", "n_seq",
                                                   "n_pipe")}
