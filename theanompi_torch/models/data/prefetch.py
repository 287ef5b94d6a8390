"""Background prefetch: the next batches are read, augmented and copied to
the card while the current step runs.

Counterpart of ``theanompi_tpu/models/data/prefetch.py``
(``PrefetchStallError`` :29, ``Prefetcher`` :37, ``prefetch`` :205).  A
daemon thread drains the rank's batch iterator ``depth`` batches ahead
into a bounded queue.  The reference's thread places each batch on its
mesh with ``device_put``; here the thread turns each leaf into a tensor
(:func:`theanompi_torch.utils.helper_funcs.as_step_tensor`: uint8
stays uint8, other integers become int64) and, for a CUDA
``device``:

- copies it once into pinned host memory and issues the copy to the card
  with ``non_blocking=True`` on a side stream of that card, then records
  an event on the side stream;
- :meth:`Prefetcher.__next__` makes the consumer's current stream wait on
  that event (no host sync), and marks every tensor as used on that
  stream (``record_stream``), so the caching allocator does not hand its
  blocks to the side stream's next copy while the step still reads them;
- keeps each batch's pinned buffers until its copy's event has completed
  (PyTorch's caching host allocator reuses a freed pinned block only
  after that too).

On the CPU the same conversion runs without a stream.  The trainer's
``wait`` segment still measures what the queue did not hide.  Telemetry
spans and fault-plan sites (the reference's ``telemetry`` and
``fault_plan``) come with the telemetry and resilience slices.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
import warnings

import torch

from theanompi_torch.utils.helper_funcs import as_step_tensor

_END = object()


class PrefetchStallError(RuntimeError):
    """The source iterator produced nothing for ``stall_timeout`` seconds:
    the training thread gets an error it can report instead of blocking
    forever."""


class Prefetcher:
    """Iterate ``it`` on a daemon thread, ``depth`` batches ahead.

    ``device`` None leaves the batches as the source made them; a device
    gives dicts of tensors on it (see the module's docstring).  An
    exception in the source is raised again at the consumer.
    ``stall_timeout`` (seconds; None blocks forever) bounds the wait on an
    empty queue, then :class:`PrefetchStallError`.  ``start_batch`` is
    the global index of the first batch ``it`` yields (a source already
    fast-forwarded), and :meth:`state` reports ``consumed``: the index of
    the first batch not yet handed to the consumer, so batches still in
    the queue are neither replayed nor skipped by a restore there."""

    def __init__(self, it, device=None, depth: int = 2,
                 stall_timeout: float | None = None, start_batch: int = 0):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if stall_timeout is not None and stall_timeout <= 0:
            raise ValueError(
                f"prefetch stall_timeout must be positive or None, "
                f"got {stall_timeout}")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._stall_timeout = stall_timeout
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._consumed = int(start_batch)
        self._device = None if device is None else torch.device(device)
        cuda = self._device is not None and self._device.type == "cuda"
        if cuda and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._stream = (torch.cuda.Stream(device=self._device) if cuda
                        else None)
        self._thread = threading.Thread(target=self._work,
                                        name="data-prefetch", daemon=True)
        self._thread.start()

    # -- the worker thread ----------------------------------------------------
    def _put(self, item) -> bool:
        """Enqueue, giving up when the consumer has closed us."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _place(self, item, pinned):
        """-> (the batch on the device, the copy's event or None)."""
        if self._device is None:
            return item, None
        host = {k: as_step_tensor(x) for k, x in item.items()}
        if self._stream is None:
            return {k: t.to(self._device) for k, t in host.items()}, None
        out = {}
        bufs = []
        with torch.cuda.stream(self._stream):
            for k, t in host.items():
                buf = t.pin_memory()
                bufs.append(buf)
                out[k] = buf.to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        pinned.append((event, bufs))
        return out, event

    def _work(self):
        # the thread's current card defaults to 0: make it the batches'
        card = (torch.cuda.device(self._device) if self._stream is not None
                else contextlib.nullcontext())
        pinned = collections.deque()  # (event, pinned buffers) in flight
        try:
            with card:
                for item in self._it:
                    if self._stop.is_set():
                        return
                    while pinned and pinned[0][0].query():
                        pinned.popleft()  # that copy is done: buffers free
                    if not self._put(self._place(item, pinned)):
                        return
        except BaseException as e:  # raised again at the consumer
            self._err = e
        finally:
            self._put(_END)

    # -- the consumer ---------------------------------------------------------
    def __iter__(self):
        return self

    def _get(self):
        """Dequeue within ``stall_timeout`` (None: block)."""
        if self._stall_timeout is None:
            return self._q.get()
        deadline = time.perf_counter() + self._stall_timeout
        while True:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                raise PrefetchStallError(
                    f"no batch from the source iterator for "
                    f"{self._stall_timeout:g}s (loader thread alive: "
                    f"{self._thread.is_alive()}); data pipeline stalled")
            try:
                # short slices, so a concurrent close() is seen promptly
                return self._q.get(timeout=min(0.25, remaining))
            except queue.Empty:
                continue

    def __next__(self):
        item = self._get()
        if item is _END:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in batch.values():
                t.record_stream(stream)
        self._consumed += 1
        return batch

    def state(self) -> dict:
        """``consumed``: the global index of the first batch the consumer
        has not received (queued batches are not counted)."""
        return {"consumed": self._consumed}

    def _drop_queued(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def close(self) -> None:
        """Stop the thread, drop the queued batches and close the source
        generator (an abandoned one would keep its batches, and a pool's
        epoch, until collected)."""
        self._stop.set()
        self._drop_queued()
        self._thread.join(timeout=5)
        self._drop_queued()  # a put that raced the first drop
        if self._thread.is_alive():
            # a generator cannot be closed while another thread runs it
            warnings.warn(
                "Prefetcher.close(): worker still inside the source "
                "iterator after 5s; source generator left open",
                RuntimeWarning, stacklevel=2)
            return
        close = getattr(self._it, "close", None)
        if close:
            close()


def prefetch(it, device=None, depth: int = 2,
             stall_timeout: float | None = None, start_batch: int = 0):
    """``depth=0`` passes ``it`` through; else a :class:`Prefetcher`."""
    if depth == 0:
        return it
    return Prefetcher(it, device=device, depth=depth,
                      stall_timeout=stall_timeout, start_batch=start_batch)
