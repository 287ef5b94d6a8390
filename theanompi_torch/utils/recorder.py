"""Training recorder: per-iteration wall-clock splits and metric histories.

Counterpart of ``theanompi_tpu/utils/recorder.py`` (``Recorder`` :25,
``write_history_snapshot``): ``start/end`` wall-clock segments (wait,
calc, comm), train metrics averaged and printed every ``print_freq``
iterations, per-epoch validation metrics, ``*_history.npy`` and
``summary.json`` written to a record directory, and read back by
``load`` (a resumed run's histories go on from the saved ones; the
reference's files and the port's are the same).  Metrics may be device
tensors: they are turned into host floats only at the print boundary,
and ``end(..., fence=t)`` synchronizes the card only when a fence is
given (the trainer passes one at print boundaries), so the calc/comm split
reflects device time there and nowhere else adds a sync.  Telemetry spans
come with a later slice.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict

import numpy as np

SEGMENTS = ("wait", "calc", "comm")


def _host_mean(x) -> float:
    """A metric (python number, numpy array or tensor) as one float."""
    if hasattr(x, "detach"):
        return float(x.detach().float().mean().cpu())
    return float(np.asarray(x).mean())


class Recorder:
    """``reduce``: None, or a function of the print window's per-step
    metrics (``{name: [value a step]}``) -> ``{name: values}`` that the
    printed means are taken over (the async rules average their workers'
    metrics there, one collective a print, as the reference averages its
    stacked metrics at print time); every rank's recorder calls it at the
    same print boundaries."""

    def __init__(self, print_freq: int = 40, save_dir: str | None = None,
                 verbose: bool = True, reduce=None):
        self.print_freq = print_freq
        self.save_dir = save_dir
        self.verbose = verbose
        self.reduce = reduce
        self._t0: dict[str, float] = {}
        self._iter_times: dict[str, float] = defaultdict(float)
        self.time_history: dict[str, list] = defaultdict(list)
        self.train_history: dict[str, list] = defaultdict(list)
        self.val_history: dict[str, list] = defaultdict(list)
        self._train_accum: dict[str, list] = defaultdict(list)
        self.epoch_start_time: float | None = None

    # -- wall-clock segments ------------------------------------------------
    def start(self, what: str = "calc") -> None:
        self._t0[what] = time.perf_counter()

    def end(self, what: str = "calc", fence=None) -> None:
        """Close segment ``what``; a CUDA tensor as ``fence`` synchronizes
        its device first, so the split is device time, not dispatch."""
        if fence is not None and getattr(fence, "is_cuda", False):
            import torch

            torch.cuda.synchronize(fence.device)
        t0 = self._t0.pop(what, None)
        if t0 is None:
            raise RuntimeError(
                f"Recorder.end({what!r}): segment was never started "
                f"(open segments: {sorted(self._t0) or 'none'}); "
                f"use cancel() to abandon a segment")
        self._iter_times[what] += time.perf_counter() - t0

    def cancel(self, what: str) -> None:
        """Abandon an open segment without recording it."""
        self._t0.pop(what, None)

    def end_iteration(self) -> None:
        for seg in SEGMENTS:
            self.time_history[seg].append(self._iter_times.get(seg, 0.0))
        self._iter_times.clear()

    # -- metrics ------------------------------------------------------------
    def train_metrics(self, **metrics) -> None:
        """Accumulate per-iteration metrics (device tensors stay on the
        device until the print boundary)."""
        for k, v in metrics.items():
            self._train_accum[k].append(v)

    def print_train_info(self, count: int) -> None:
        """Every ``print_freq`` iterations: averaged metrics + time split."""
        if count % self.print_freq != 0 or not self._train_accum:
            return
        accum = self._train_accum
        if self.reduce is not None:
            accum = {k: [v] for k, v in self.reduce(accum).items()}
        means = {k: float(np.mean([_host_mean(x) for x in v]))
                 for k, v in accum.items()}
        for k, v in means.items():
            self.train_history[k].append(v)
        self.train_history["iter"].append(count)
        if self.verbose:
            metric_s = " ".join(f"{k} {v:.4f}" for k, v in means.items())
            n = min(self.print_freq, len(self.time_history["calc"]) or 1)
            times = {seg: float(np.sum(self.time_history[seg][-n:]))
                     for seg in SEGMENTS}
            time_s = " ".join(f"{s} {t:.3f}s" for s, t in times.items())
            print(f"iter {count}: {metric_s} | {time_s}", flush=True)
        self._train_accum.clear()

    def val_metrics(self, epoch: int, **metrics) -> None:
        self.val_history["epoch"].append(epoch)
        for k, v in metrics.items():
            self.val_history[k].append(float(v))
        if self.verbose:
            metric_s = " ".join(f"val_{k} {float(v):.4f}"
                                for k, v in metrics.items())
            dur = (f" ({time.perf_counter() - self.epoch_start_time:.1f}s)"
                   if self.epoch_start_time else "")
            print(f"epoch {epoch}: {metric_s}{dur}", flush=True)

    def start_epoch(self) -> None:
        self.epoch_start_time = time.perf_counter()

    # -- persistence --------------------------------------------------------
    def history_snapshot(self) -> dict:
        """Point-in-time copy of the three histories as plain lists."""
        return {
            "time": {k: list(v) for k, v in self.time_history.items()},
            "train": {k: list(v) for k, v in self.train_history.items()},
            "val": {k: list(v) for k, v in self.val_history.items()},
        }

    def save(self, path: str | None = None) -> None:
        path = path or self.save_dir
        if path is None:
            return
        write_history_snapshot(self.history_snapshot(), path)

    def load(self, path: str | None = None) -> None:
        """Replace the histories with ``path``'s ``*_history.npy`` (the
        reference's :159-177), values as plain Python numbers
        (``tolist``), so a later save serializes them again."""
        path = path or self.save_dir
        if path is None:
            return
        for name, hist in (("time", self.time_history),
                           ("train", self.train_history),
                           ("val", self.val_history)):
            p = os.path.join(path, f"{name}_history.npy")
            if os.path.exists(p):
                loaded = np.load(p, allow_pickle=True).item()
                hist.clear()
                hist.update({k: np.asarray(v).tolist()
                             for k, v in loaded.items()})


def write_history_snapshot(snapshot: dict, path: str) -> None:
    """Serialize a :meth:`Recorder.history_snapshot` to ``path``: the
    reference's ``*_history.npy`` files and ``summary.json``, the latter
    replaced atomically."""
    os.makedirs(path, exist_ok=True)
    for name in ("time", "train", "val"):
        hist = snapshot.get(name, {})
        np.save(os.path.join(path, f"{name}_history.npy"),
                {k: np.asarray(v) for k, v in hist.items()},
                allow_pickle=True)
    spath = os.path.join(path, "summary.json")
    with open(spath + ".tmp", "w") as f:
        json.dump({
            "iters": len(snapshot.get("time", {}).get("calc", ())),
            "last_val": {k: v[-1]
                         for k, v in snapshot.get("val", {}).items() if v},
        }, f)
    os.replace(spath + ".tmp", spath)
