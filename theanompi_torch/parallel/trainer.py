"""The trainer core and the rule facade, on one rank of a data-parallel
process group (or one process alone).

Counterpart of the core of ``theanompi_tpu/parallel/trainer.py``:
``make_local_step`` (:76) as :func:`make_train_step` — loss, backward,
exchange, optimizer update, then the metrics and the new model state
averaged over the ranks (``pmean_floats`` :57, through the exchanger's
:func:`fused_pmean`) — with ``n_subb`` gradient accumulation
(``_accumulated_grads``, :229, the model state threaded through the
micro-batches in order); :class:`BaseTrainer` with ``init_state``,
``train_iter``, ``val_iter``, ``validate`` (``make_local_eval`` :280: each
rank evaluates its share of a validation batch, the means averaged over
the ranks), ``_run_epochs`` and ``run``; and :class:`Rule` with
``init``/``wait`` (:1493).  PyTorch runs eagerly, so there is nothing to
compile: ``compile_iter_fns`` builds the step closure.

The reference's ``data`` mesh axis is the process group
(:mod:`theanompi_torch.dist`): a run of N ranks trains on global batches
of ``batch_size x N`` rows (:410), rank r on rows ``[r b, (r + 1) b)``
of each, which is how the mesh shards them.  At one process the group is
absent and every collective is skipped.

Params are fp32 masters; the model casts to the compute dtype inside
``loss_fn``, and autograd through that cast returns fp32 grads.  The
trainer holds the model's state (BatchNorm running statistics) beside
params and optimizer state: each step returns the new one, and
validation evaluates on it.  Dropout draws from a ``torch.Generator`` on
the trainer's device seeded with ``derive_seed("dropout", seed, step)``
(``..., step, i`` for micro-batch ``i``), with the rank appended above a
world of 1 (:func:`theanompi_torch.dist.replica_key`), so masks repeat
for the same seed and step and differ across steps and ranks; the
exchange (``ring_int8``'s rounding) draws from its own per-rank stream,
``derive_seed("exchange", seed, step, ...rank)`` (the reference's
``EXCHANGE_RNG_TAG``).  Device syncs happen only at print boundaries and
in validation.  Only rank 0 prints and saves the recorder.

Under ``zero1`` (``exchanger.fuses_update``) the exchange is the update
(:170-178): :meth:`Exchanger.exchange_and_update` takes the grads, the
optimizer state and the params.  With ``exchanger.overlap`` at a world
above 1, backward runs hooked (:class:`BucketExchange`): each bucket's
collective goes out from backward as its grads come in, and the exchange
waits on them.  ``_run_epochs`` calls :meth:`BaseTrainer._maybe_ramp` at
the top of each epoch (:1164-1167), where BSP swaps its exchanger by
``exch_ramp``.

The epoch's batches come through a :class:`Prefetcher`
(:meth:`BaseTrainer._make_prefetcher`, the reference's :1058): a thread
``prefetch`` batches ahead (default 2; 0 iterates inline) builds this
rank's rows and copies them to the card from pinned memory on a side
stream, and ``_run_epochs`` builds the next epoch's prefetcher before
validating (:1263-1269), so the queue refills while the host validates.

Not carried by this slice, and refused rather than ignored: checkpoints
and resume, telemetry, the resilience stack (fault plans, sentinel,
watchdog, preemption), the profiler window and sharded meshes
(:data:`NOT_PORTED_KEYS`).
"""

from __future__ import annotations

from typing import Any

import torch

from theanompi_torch import dist as tdist
from theanompi_torch.models.data.base import derive_seed
from theanompi_torch.models.data.prefetch import prefetch
from theanompi_torch.parallel.exchanger import (
    BucketExchange,
    flatten,
    fused_pmean,
)
from theanompi_torch.parallel.mesh import resolve_device
from theanompi_torch.tree import tree_leaves_with_path, tree_map
from theanompi_torch.utils.helper_funcs import import_model, to_device
from theanompi_torch.utils.recorder import Recorder

#: rule keys of the reference whose machinery is not ported yet: a config
#: that sets one raises instead of training without it
NOT_PORTED_KEYS = (
    "checkpoint_dir", "checkpoint_keep", "checkpoint_async",
    "checkpoint_verify", "checkpoint_every_n_iters", "resume",
    "resume_force", "resume_reshard", "telemetry_dir",
    "telemetry_max_bytes", "telemetry_keep", "telemetry_health",
    "telemetry_blackbox", "telemetry_profile", "profile_dir",
    "profile_window", "fault_plan", "sentinel_policy",
    "sentinel_max_skips", "sentinel_max_rollbacks", "watchdog",
    "watchdog_multiple", "watchdog_min_s", "watchdog_poll_s",
    "heartbeat_path", "handle_preemption", "n_model", "n_seq", "n_pipe")


def _leaves(tree) -> list:
    return [x for _, x in tree_leaves_with_path(tree)]


def _unflatten(tree, leaves: list):
    """A tree shaped like ``tree`` holding ``leaves`` in its leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _dropout_gen(device, seed: int, *key):
    """The dropout generator of one step (and micro-batch) on this
    rank."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed("dropout", seed, *key, *tdist.replica_key()))
    return gen


def loss_and_grads(model, params, state, batch, gen, hooks=None):
    """-> (new_state, metrics, grads) of one forward + backward
    (``train=True``; ``gen`` the dropout generator or None).  ``hooks``: a
    :class:`BucketExchange` to arm on the differentiated leaves, so the
    exchange's collectives go out from backward."""
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    tree = _unflatten(params, leaves)
    if hooks is not None:
        hooks.arm(flatten(tree))
    loss, (new_state, metrics) = model.loss_fn(tree, state, batch, gen,
                                               train=True)
    return (new_state, metrics,
            _unflatten(params, torch.autograd.grad(loss, leaves)))


def _accumulated_grads(model, params, state, batch, seed, step, device,
                       n_subb, hooks=None):
    """Micro-batched forward + backward: -> (new_state, metrics, mean
    grads).  The batch splits into ``n_subb`` equal micro-batches;
    activations live for one micro-batch at a time, the grads sum into one
    params-sized tree, and the state threads through the micro-batches in
    order (BatchNorm's statistics are per micro-batch, as in the
    reference).  Float metrics come back averaged; perplexity is
    re-derived from the averaged cost (a mean of exps would be biased
    high).  ``hooks`` are armed for the last micro-batch, given the sum
    of the earlier ones."""
    n = {x.shape[0] for x in batch.values()}
    if any(b % n_subb for b in n):
        raise ValueError(f"n_subb={n_subb} must divide the per-worker batch "
                         f"(got leading dims {sorted(n)})")
    gsum, msum = None, {}
    for i in range(n_subb):
        mb = {k: x.reshape(n_subb, x.shape[0] // n_subb, *x.shape[1:])[i]
              for k, x in batch.items()}
        gen = _dropout_gen(device, seed, step, i)
        last = hooks if i == n_subb - 1 else None
        if last is not None:
            last.accumulate(gsum, n_subb)
        state, m, g = loss_and_grads(model, params, state, mb, gen, last)
        gsum = g if gsum is None else tree_map(torch.add, gsum, g)
        for k, v in m.items():
            msum[k] = v if k not in msum else msum[k] + v
    grads = tree_map(lambda g: g / n_subb, gsum)
    metrics = {k: v / n_subb for k, v in msum.items()}
    if {"perplexity", "cost"} <= metrics.keys():
        metrics["perplexity"] = torch.exp(metrics["cost"])
    return state, metrics, grads


def make_train_step(model, optimizer, exchanger, seed: int, device):
    """The per-step function: ``step(params, state, opt_state, batch, lr,
    step) -> (new_params, new_state, new_opt_state, metrics)`` — loss and
    backward (over ``n_subb`` micro-batches when the model config asks;
    hooked, under ``exchanger.overlap``, so the buckets' collectives go out
    from backward), the exchange and the optimizer update (one call under
    ``zero1``) under ``torch.no_grad``, then the float metrics and the new
    model state averaged over the ranks (one collective a dtype; already
    equal under sync-BN, the mean repairs drift otherwise)."""
    n_subb = int(model.config.get("n_subb", 1) or 1)

    def train_step(params, state, opt_state, batch, lr, step):
        xseed = derive_seed("exchange", seed, step, *tdist.replica_key())
        hooks = (BucketExchange(exchanger, params, xseed, reverse=True)
                 if exchanger.overlap and tdist.world() > 1 else None)
        if n_subb == 1:
            gen = _dropout_gen(device, seed, step)
            new_state, metrics, grads = loss_and_grads(model, params, state,
                                                       batch, gen, hooks)
        else:
            new_state, metrics, grads = _accumulated_grads(
                model, params, state, batch, seed, step, device, n_subb,
                hooks)
        with torch.no_grad():
            if exchanger.fuses_update:
                new_params, new_opt_state = exchanger.exchange_and_update(
                    grads, opt_state, params, lr, optimizer, seed=xseed,
                    inflight=hooks)
            else:
                grads = exchanger.exchange(grads, seed=xseed, inflight=hooks)
                new_params, new_opt_state = optimizer.update(
                    grads, opt_state, params, lr)
            metrics = fused_pmean(metrics)
            new_state = fused_pmean(new_state)
        return new_params, new_state, new_opt_state, metrics

    return train_step


def close_feed(batches) -> None:
    """Close a prefetcher or generator (None and plain iterators: no-op)."""
    close = getattr(batches, "close", None)
    if close is not None:
        close()


class BaseTrainer:
    """Iterate-validate-record skeleton; a rule supplies ``init_state``
    and the exchanger (reference names: ``compile_iter_fns``,
    ``train_iter``, ``val_iter``)."""

    def __init__(self, model, device=None, recorder: Recorder | None = None,
                 seed: int = 0, prefetch_depth: int = 2,
                 prefetch_stall_timeout: float | None = None):
        self.model = model
        self.prefetch_depth = int(prefetch_depth)
        self.prefetch_stall_timeout = (
            None if prefetch_stall_timeout is None
            else float(prefetch_stall_timeout))
        self.device = resolve_device(device)
        self.recorder = recorder or Recorder()
        self.seed = seed
        self.optimizer = model.build_optimizer()
        self.rank, self.n_workers = tdist.rank(), tdist.world()
        self.global_batch = model.batch_size * self.n_workers
        self.exchanger = None
        self._step_fn = None
        self.params = None
        self.state = None
        self.opt_state = None
        self.epoch = 0
        self.iteration = 0

    # -- rule surface ---------------------------------------------------------
    def init_state(self) -> None:
        raise NotImplementedError

    def _maybe_ramp(self, epoch: int) -> None:
        """Epoch-boundary hook, called at the top of each epoch (BSP swaps
        its exchanger by ``exch_ramp`` here)."""

    def compile_iter_fns(self) -> None:
        """Build the step closure around the rule's exchanger."""
        self._step_fn = make_train_step(self.model, self.optimizer,
                                        self.exchanger, self.seed,
                                        self.device)

    # -- iteration ------------------------------------------------------------
    def train_iter(self, batch: dict, lr: float):
        r = self.recorder
        r.start("wait")
        batch = to_device(batch, self.device)  # free for a placed batch
        r.end("wait")
        r.start("calc")
        self.params, self.state, self.opt_state, metrics = self._step_fn(
            self.params, self.state, self.opt_state, batch, float(lr),
            self.iteration)
        self.iteration += 1
        # fence only at print boundaries: a per-step sync would serialize
        # the host's dispatch with the card
        fence = (metrics["cost"] if self.iteration % r.print_freq == 0
                 else None)
        r.end("calc", fence=fence)
        r.end_iteration()
        r.train_metrics(**metrics)
        r.print_train_info(self.iteration)
        return metrics

    def rows(self, global_rows: int) -> tuple[int, int]:
        """This rank's rows of a global batch of ``global_rows``."""
        b = global_rows // self.n_workers
        return self.rank * b, (self.rank + 1) * b

    def train_batches(self, epoch: int, start_batch: int = 0):
        """This rank's rows of the epoch's global batches, from batch
        ``start_batch`` on."""
        return self.model.data.train_batches(
            self.global_batch, epoch, seed=self.seed,
            start_batch=start_batch, rows=self.rows(self.global_batch))

    def _make_prefetcher(self, epoch: int, start_batch: int = 0):
        """The epoch's batches on this rank's device, ``prefetch_depth``
        ahead on a thread (0: the numpy iterator itself, placed in
        :meth:`train_iter`).  Close it when done (``close``)."""
        return prefetch(self.train_batches(epoch, start_batch),
                        device=self.device, depth=self.prefetch_depth,
                        stall_timeout=self.prefetch_stall_timeout,
                        start_batch=start_batch)

    def val_iter(self, batch: dict) -> dict:
        """The metrics of this rank's share of a validation batch."""
        batch = to_device(batch, self.device)
        with torch.no_grad():
            _, (_, metrics) = self.model.loss_fn(self.params, self.state,
                                                 batch, None, train=False)
        return metrics

    def validate(self, epoch: int) -> dict:
        # the largest worker-divisible batch, as the reference (:1024)
        vb = min(self.global_batch, self.model.data.n_val)
        vb -= vb % self.n_workers
        if vb == 0:
            return {}
        accums: dict[str, list] = {}
        for batch in self.model.data.val_batches(vb, rows=self.rows(vb)):
            for k, v in self.val_iter(batch).items():
                accums.setdefault(k, []).append(v)  # one pull after the loop
        # each batch's metrics averaged over the ranks, in one collective
        stacked = fused_pmean({k: torch.stack(v) for k, v in accums.items()})
        means = {k: float(v.double().mean()) for k, v in stacked.items()}
        if {"perplexity", "cost"} <= means.keys():
            means["perplexity"] = float(torch.tensor(means["cost"]).exp())
        self.recorder.val_metrics(epoch, **means)
        return means

    def _run_epochs(self, stop=None) -> None:
        model = self.model
        batches = None
        try:
            for epoch in range(self.epoch, model.n_epochs):
                self.epoch = epoch
                self._maybe_ramp(epoch)
                self.recorder.start_epoch()
                lr = model.adjust_hyperp(epoch)
                if batches is None:  # not built at the last boundary
                    batches = self._make_prefetcher(epoch)
                it = iter(batches)
                try:
                    while True:
                        # the dequeue is the input stall: the wait segment
                        self.recorder.start("wait")
                        try:
                            batch = next(it)
                        except StopIteration:
                            self.recorder.cancel("wait")
                            break
                        self.recorder.end("wait")
                        self.train_iter(batch, lr)
                finally:
                    close_feed(batches)
                    batches = None
                # the next epoch's queue fills while the host validates
                if epoch + 1 < model.n_epochs:
                    batches = self._make_prefetcher(epoch + 1)
                val = self.validate(epoch)
                self.epoch = epoch + 1
                if stop is not None and stop(epoch, val):
                    break
        finally:
            # an early stop or an exception leaves the next epoch's
            # prefetcher open: stop its thread
            close_feed(batches)

    def run(self, stop=None):
        """Train to completion; ``stop(epoch, val_metrics) -> bool`` may
        end it early.  -> the recorder."""
        if self._step_fn is None:
            self.compile_iter_fns()
        if self.params is None:
            self.init_state()
        try:
            self._run_epochs(stop)
            self.recorder.save()
        finally:
            self.model.cleanup()  # the loader pool's processes too
        return self.recorder


class Rule:
    """Reference-compatible rule facade::

        rule = BSP(config={"exch_strategy": "psum"})
        rule.init(devices=1, modelfile="theanompi_torch.models.transformer_lm",
                  modelclass="TransformerLM", model_config={...})
        rule.wait()

    ``devices`` is the worker count: the ranks of the process group this
    process belongs to (1 without one; None takes the group's size), each
    rank calling ``init`` and ``wait`` alike.  ``device`` is the torch
    device (None: the rank's card, raising without CUDA)."""

    def __init__(self, config: dict[str, Any] | None = None):
        self.config = config or {}
        self.trainer: BaseTrainer | None = None

    def adjust_model_config(self, model_config: dict, n_workers: int) -> None:
        """Rule-specific model-config defaults (sync-BN for BSP)."""

    def make_trainer(self, model, device, recorder) -> BaseTrainer:
        raise NotImplementedError

    def init(self, devices=None,
             modelfile: str = "theanompi_torch.models.transformer_lm",
             modelclass: str = "TransformerLM",
             model_config: dict | None = None, device=None):
        unported = sorted(k for k in self.config if k in NOT_PORTED_KEYS)
        if unported:
            raise NotImplementedError(
                f"rule keys {unported} not yet ported (ROADMAP queue 1: "
                f"checkpoints item 8, the resilience stack item 14, "
                f"telemetry item 15, sharded meshes item 13)")
        n = tdist.world()
        if devices is not None and devices != n:
            raise ValueError(
                f"devices={devices!r} in a run of {n} rank(s): start "
                f"{devices} ranks (theanompi_torch.dist.spawn, or the "
                f"launcher's --devices {devices}), each calling init")
        device = resolve_device(device)
        model_config = dict(model_config or {})
        self.adjust_model_config(model_config, n)
        model = import_model(modelfile, modelclass)(model_config)
        lead = tdist.rank() == 0
        recorder = Recorder(
            print_freq=self.config.get("print_freq", 40),
            save_dir=self.config.get("record_dir") if lead else None,
            verbose=lead and self.config.get("verbose", model.verbose))
        self.trainer = self.make_trainer(model, device, recorder)
        self.trainer.compile_iter_fns()
        self.trainer.init_state()
        return self

    def wait(self):
        """Run training to completion; -> the recorder."""
        if self.trainer is None:
            raise RuntimeError("call init() before wait()")
        return self.trainer.run()
