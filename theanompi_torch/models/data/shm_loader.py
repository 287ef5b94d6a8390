"""A persistent ring of loader processes with a shared-memory handoff.

Counterpart of ``theanompi_tpu/models/data/shm_loader.py`` (``_worker``
:36, ``ShmShardPool`` :80).  N worker processes each load one shard, run
the crop and mirror (in C where :mod:`theanompi_torch.native` builds) and
the within-shard shuffle, and write the result straight into a slot of
one ``multiprocessing.shared_memory`` block: no image is pickled, the
parent copies each shard out of its slot once.

- **spawn, not fork**: the parent holds CUDA state and threads, which a
  forked child would inherit half-held.  Spawned workers import only this
  module and the numpy data modules (never ``torch``), and the pool is
  **persistent**: created once per dataset, reused every epoch, stopped by
  ``Dataset.cleanup()``.
- **slot flow control**: a slot goes to a worker only after the consumer
  has copied it out, so the ring bounds memory however far the workers
  run ahead.
- **determinism**: results come back in shard order and each task carries
  its own seed, so a fixed task list gives the same stream bit for bit
  whatever the workers' timing.
- **liveness**: while it waits for a result the parent checks its workers
  every :data:`POLL_S` seconds, so a dead worker raises instead of
  hanging the training loop; an idle worker whose parent died exits.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_lib
import threading

import numpy as np

#: seconds between the liveness checks of a waiting parent
POLL_S = 0.5


def _worker(task_q, result_q, shm_name, slot_nbytes, image_size):
    from multiprocessing import shared_memory

    from theanompi_torch.models.data.imagenet import (
        _load_from_spec,
        random_crop_mirror,
    )
    from theanompi_torch.models.data.stream import load_token_shard

    shm = shared_memory.SharedMemory(name=shm_name)
    parent = mp.parent_process()
    try:
        while True:
            try:
                task = task_q.get(timeout=POLL_S)
            except queue_lib.Empty:
                if parent is not None and not parent.is_alive():
                    return  # orphaned: no one will read a result
                continue
            if task is None:
                return
            idx, spec, seed, slot = task
            if spec[0] == "tokens":
                # token mode: one flat int32 token shard, no augmentation
                toks = load_token_shard(spec[1])
                out = np.ndarray(toks.shape, np.int32,
                                 buffer=shm.buf[slot * slot_nbytes:])
                out[:] = toks
                del out  # views of shm.buf must die before it closes
                result_q.put((idx, slot, toks.shape, "int32", None))
                continue
            x, y = _load_from_spec(spec)
            rng = np.random.RandomState(seed)
            x = random_crop_mirror(x, image_size, rng)
            per = rng.permutation(len(x))
            x, y = x[per], y[per]
            out = np.ndarray(x.shape, np.uint8,
                             buffer=shm.buf[slot * slot_nbytes:])
            out[:] = x
            del out
            result_q.put((idx, slot, x.shape, "uint8", y))
    finally:
        shm.close()


class ShmShardPool:
    """Reusable worker ring: ``run(tasks)`` yields one epoch's augmented
    ``(x, y)`` shards in order; ``close()`` stops the workers.

    ``tasks``: a list of ``(spec, seed)``, the specs from
    ``_ShardSet.spec``/``_SyntheticShards.spec``, or ``("tokens", path)``
    (token shards, yielded as ``(int32 tokens, None)``).  Each yielded
    ``x`` is a fresh copy (its slot is recycled at once).  One epoch at a
    time: a second ``run`` while one is open raises (close the first
    generator; the prefetcher does).  ``slot_nbytes`` replaces the image
    shard's slot size for other payloads (the token mode).  The ring has
    two slots a worker."""

    def __init__(self, image_size: int, shard_size: int, workers: int,
                 slot_nbytes: int | None = None):
        from multiprocessing import shared_memory

        self.image_size = image_size
        self.workers = max(1, workers)
        self.slots = 2 * self.workers
        self.slot_nbytes = (slot_nbytes if slot_nbytes is not None
                            else shard_size * image_size * image_size * 3)
        self._shm = shared_memory.SharedMemory(
            create=True, size=max(1, self.slots * self.slot_nbytes))
        ctx = mp.get_context("spawn")
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._procs = [
            ctx.Process(target=_worker, daemon=True,
                        name=f"shm-loader-{i}",
                        args=(self._task_q, self._result_q, self._shm.name,
                              self.slot_nbytes, image_size))
            for i in range(self.workers)]
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            for p in self._procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
            self._shm.close()
            self._shm.unlink()
            raise
        self._closed = False
        self._broken = False
        self._busy = threading.Lock()

    def _get_result(self):
        """The next result; raises if a worker died (a killed process, or
        an exception on a corrupt shard) rather than waiting forever."""
        while True:
            try:
                return self._result_q.get(timeout=POLL_S)
            except queue_lib.Empty:
                dead = [p for p in self._procs if not p.is_alive()]
                if dead:
                    self._broken = True
                    raise RuntimeError(
                        f"ShmShardPool: {len(dead)} worker(s) died "
                        f"(exit codes {[p.exitcode for p in dead]}); a "
                        f"shard load or augment likely raised, see the "
                        f"worker's stderr") from None

    def run(self, tasks):
        if self._closed or self._broken:
            raise RuntimeError("ShmShardPool is closed or broken")
        if not self._busy.acquire(blocking=False):
            raise RuntimeError(
                "ShmShardPool already serving an epoch; close the previous "
                "batch generator first")
        try:
            tasks = list(tasks)
            free = list(range(self.slots))
            next_submit = 0

            def submit():
                nonlocal next_submit
                if next_submit < len(tasks) and free:
                    spec, seed = tasks[next_submit]
                    self._task_q.put(
                        (next_submit, spec, int(seed), free.pop()))
                    next_submit += 1

            for _ in range(min(self.slots, len(tasks))):
                submit()
            pending: dict[int, tuple] = {}
            served = 0
            try:
                for want in range(len(tasks)):
                    while want not in pending:
                        idx, slot, shape, dt, y = self._get_result()
                        pending[idx] = (slot, shape, dt, y)
                    slot, shape, dt, y = pending.pop(want)
                    view = np.ndarray(
                        shape, np.dtype(dt),
                        buffer=self._shm.buf[slot * self.slot_nbytes:])
                    x = view.copy()  # the slot is recycled right after
                    del view
                    free.append(slot)
                    submit()
                    served += 1
                    yield x, y
            finally:
                # an early close: drain the results still in flight, so
                # the next epoch starts from an empty ring
                inflight = next_submit - served - len(pending)
                try:
                    for _ in range(inflight):
                        self._get_result()
                except RuntimeError:
                    pass  # a worker died: _get_result marked the pool broken
                pending.clear()
        finally:
            self._busy.release()

    def close(self):
        if self._closed:
            return
        self._closed = True
        for _ in self._procs:
            self._task_q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for q in (self._task_q, self._result_q):
            q.close()
            q.join_thread()
        self._shm.close()
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass
