"""Verified live weight rollout with rollback.

The port's copy of ``theanompi_tpu/serving/rollout.py``.  A
:class:`RolloutManager` watches a checkpoint directory a live trainer
may still own and hot-swaps newly *verified* checkpoints into the
serving engine between scheduler steps:

- **discovery** is by manifest name only (a ``listdir``; no checkpoint
  byte is read until a new epoch shows up);
- **verification** goes through the read-only chain
  (:func:`theanompi_torch.utils.checkpoint.load_for_inference`): a
  corrupt or half-published candidate (manifest visible, ``.npz`` not yet
  replaced) fails to verify as the newest epoch, which the watcher takes
  for "not yet published": it counts one refusal, keeps serving the old
  weights and polls again.  It never quarantines, moves or deletes a
  file of the writer's;
- **adoption** preempts every active sequence first (their KV cache was
  computed under the old weights; recompute preemption replays them, so
  no request is dropped), then swaps the params
  (:meth:`~theanompi_torch.serving.engine.InferenceEngine.swap_params`);
- **probation**: for ``probation_s`` after a swap the watcher reads the
  health verdicts; a critical ``slo`` or ``throughput`` verdict rolls
  back to the previous weights, and the rolled-back epoch is remembered
  as bad so it is never adopted again.

The port has no telemetry yet: ``health_verdicts`` is an injectable
callable and defaults to no verdicts (what the reference does without a
telemetry directory); the counters ``n_rollouts``, ``n_rollbacks`` and
``n_refused`` are the record.

Fault site ``serve:rollout_corrupt@i`` (narrowed by action: the
candidate ordinal, not the decode step) flips a byte of the i-th
candidate's ``.npz`` before verification.
"""

from __future__ import annotations

import os
import time

from theanompi_torch.utils.checkpoint import (
    CheckpointCorruptError,
    load_for_inference,
)

#: health detectors whose critical verdict triggers the probation rollback
ROLLBACK_DETECTORS = ("slo", "throughput")


def newest_manifest_epoch(directory: str) -> int | None:
    """Highest ``ckpt_eNNNN.manifest.json`` epoch by file name only (no
    content is read, so polling a live writer's directory cannot tear a
    read).  None when the directory has no manifests."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    best = None
    for f in names:
        if not (f.startswith("ckpt_e") and f.endswith(".manifest.json")):
            continue
        try:
            ep = int(f[len("ckpt_e"):-len(".manifest.json")])
        except ValueError:
            continue
        best = ep if best is None or ep > best else best
    return best


class RolloutManager:
    """Between-steps checkpoint watcher for one engine and scheduler.

    ``templates``: ``{"params": tree}`` to restore into (structure,
    dtypes, host device).  ``health_verdicts``: a zero-argument callable
    returning the current verdict dicts (``[{"detector", "severity",
    ...}]``); None means no verdicts.  ``clock``: the time source of the
    poll interval and the probation window (injectable for tests).
    """

    def __init__(self, engine, checkpoint_dir: str, templates: dict, *,
                 model=None, verify: str = "fast",
                 current_epoch: int | None = None,
                 poll_s: float = 0.5, probation_s: float = 10.0,
                 health_verdicts=None, fault_plan=None,
                 clock=time.perf_counter):
        self.engine = engine
        self.checkpoint_dir = checkpoint_dir
        self.templates = templates
        self.model = model
        self.verify = verify
        self.poll_s = float(poll_s)
        self.probation_s = float(probation_s)
        self._health_verdicts = health_verdicts
        self.fault_plan = fault_plan
        self._clock = clock
        self.current_epoch = -1 if current_epoch is None else current_epoch
        self._next_poll = 0.0
        self._prev: tuple[object, int] | None = None  # (engine params, epoch)
        self._probation_until: float | None = None
        self._bad_epochs: set[int] = set()
        self._refused: set[int] = set()
        self._candidate_ordinals: dict[int, int] = {}
        self.n_rollouts = 0
        self.n_rollbacks = 0
        self.n_refused = 0

    def _verdicts(self) -> list[dict]:
        if self._health_verdicts is None:
            return []
        return list(self._health_verdicts() or ())

    def _maybe_corrupt_candidate(self, epoch: int) -> None:
        """The ``serve:rollout_corrupt`` site: flip the byte in the middle
        of the candidate's ``.npz`` before verification (each distinct
        epoch considered draws the next candidate ordinal)."""
        if self.fault_plan is None:
            return
        if epoch not in self._candidate_ordinals:
            self._candidate_ordinals[epoch] = len(self._candidate_ordinals)
        ordinal = self._candidate_ordinals[epoch]
        if not self.fault_plan.fire("serve", ordinal, "rollout_corrupt"):
            return
        npz = os.path.join(self.checkpoint_dir, f"ckpt_e{epoch:04d}.npz")
        try:
            with open(npz, "r+b") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(size // 2)
                b = f.read(1)
                f.seek(size // 2)
                f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
        except OSError:
            pass  # an injected fault must not crash serving

    def poll(self, scheduler) -> str | None:
        """Run between scheduler steps; -> "rollout", "rollback",
        "refused" or None for this pass."""
        now = self._clock()
        outcome = self._check_probation(scheduler, now)
        if outcome:
            return outcome
        if now < self._next_poll:
            return None
        self._next_poll = now + self.poll_s
        candidate = newest_manifest_epoch(self.checkpoint_dir)
        if (candidate is None or candidate <= self.current_epoch
                or candidate in self._bad_epochs):
            return None
        self._maybe_corrupt_candidate(candidate)
        try:
            restored = load_for_inference(
                self.checkpoint_dir, self.templates, verify=self.verify,
                model=self.model)
        except CheckpointCorruptError:
            # the whole chain failed to verify: nothing newer to adopt;
            # keep serving the weights already loaded and poll again
            return self._refuse(candidate)
        if restored is None:  # the directory emptied meanwhile
            return self._refuse(candidate)
        epoch, _it, trees = restored
        if epoch <= self.current_epoch or epoch in self._bad_epochs:
            # the chain stepped back over the candidate: corrupt or
            # half-published, so not yet published as far as serving goes
            return self._refuse(candidate)
        self._adopt(scheduler, epoch, trees)
        return "rollout"

    def _refuse(self, epoch: int) -> str:
        if epoch not in self._refused:  # one refusal a candidate, not one
            self._refused.add(epoch)    # a poll
            self.n_refused += 1
        return "refused"

    def _adopt(self, scheduler, epoch: int, trees: dict) -> None:
        scheduler.preempt_all()
        prev_params = self.engine.swap_params(trees["params"])
        self._prev = (prev_params, self.current_epoch)
        self.current_epoch = epoch
        self._refused.discard(epoch)
        self._probation_until = self._clock() + self.probation_s
        self.n_rollouts += 1

    def _check_probation(self, scheduler, now: float) -> str | None:
        if self._probation_until is None:
            return None
        if now >= self._probation_until:
            # probation survived: the swap is committed and the old
            # weights are no longer a rollback target
            self._probation_until = None
            self._prev = None
            return None
        critical = next(
            (v for v in self._verdicts()
             if v.get("detector") in ROLLBACK_DETECTORS
             and v.get("severity") == "critical"), None)
        if critical is None or self._prev is None:
            return None
        prev_params, prev_epoch = self._prev
        scheduler.preempt_all()
        self.engine.restore_params(prev_params)
        self._bad_epochs.add(self.current_epoch)
        self.current_epoch = prev_epoch
        self._prev = None
        self._probation_until = None
        self.n_rollbacks += 1
        return "rollback"
