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

With ``n_model`` above 1 (BSP only; :class:`~theanompi_torch.parallel.
mesh.Layout`) the world is ``n_data x n_model`` ranks: ``init(devices=n)``
means n data workers (the reference's :1500-1514), a rank's batch rows
and the worker count come from its data index, and the exchange, the
means of metrics and state, validation and sync-BN run over its data
group.  Each rank holds its shards of the params (the model's
``param_specs``; built whole from the seed, or restored whole, then cut:
:meth:`BaseTrainer.place`), the layers' collectives run over its model
group, and clipping's norm is the whole tree's.  The trainer binds its
layout around everything it runs (:meth:`~theanompi_torch.parallel.
mesh.Layout.bound`).  A checkpoint holds the reference's global layout:
each rank's shards are gathered over its model group and rank 0 writes
them; a resume cuts them again, and a resume at another ``n_model`` is
refused (``CheckpointReshardableMismatch``, exit 78; the reshard is item
14).  ``zero1`` is refused over sharded params, as the reference refuses
it.

Params are fp32 masters; the model casts to the compute dtype inside
``loss_fn``, and autograd through that cast returns fp32 grads.  The
trainer holds the model's state (BatchNorm running statistics) beside
params and optimizer state: each step returns the new one, and
validation evaluates on it.  Dropout draws from a ``torch.Generator`` on
the trainer's device seeded with ``derive_seed("dropout", seed, step)``
(``..., step, i`` for micro-batch ``i``), with the data index appended
above one data worker (:func:`theanompi_torch.parallel.mesh.
replica_key`), so masks repeat for the same seed and step, differ across
steps and data workers, and are the same on the ranks of one model group
(at ``n_model`` 1 the data index is the rank); the exchange
(``ring_int8``'s rounding) draws from its own per-replica stream,
``derive_seed("exchange", seed, step, ...data index)`` (the reference's
``EXCHANGE_RNG_TAG``).  Device syncs happen only at print boundaries and
in validation.  Only rank 0 prints and saves the recorder.

A model that supplies ``make_custom_step`` (the GAN) owns its inner
step (:103-130); the rule keeps the metrics' and the state's mean, and
refuses ``n_subb``, ``zero1`` and overlap for it.

With no exchanger (the async rules, :mod:`theanompi_torch.parallel.easgd`
and :mod:`~theanompi_torch.parallel.gosgd`) the step is collective-free:
``make_local_step(stacked=True)`` (:76-110), the GAN's inner step
included.  Each rank then keeps its own worker's params, state and
optimizer state (rank r holds row r of the reference's stacked ``[n,
...]`` trees), its metrics are its own, and the rule's exchange runs in
:meth:`BaseTrainer.post_step` after every step.  The other hooks of the
reference's :class:`BaseTrainer` (:454-544): ``warmup_exchange``,
``warmup`` (every path once, then a fresh init, for timing harnesses),
``reset_iter`` and ``eval_args`` (what validation evaluates: the async
rules' center or consensus).  :func:`require_data_parallel_mesh` (:290)
is the async rules' refusal of sharded axes.

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

Checkpoints (``checkpoint_dir`` and its keys, the reference's :343-410):
``save_checkpoint`` at each epoch boundary after validation, and every
``checkpoint_every_n_iters`` steps inside an epoch (``completed=False``,
the data plane's cursor in the manifest); the training thread pays the
snapshot, a writer thread the rest (:mod:`theanompi_torch.utils.
checkpoint`).  The files are the reference's (the codec is
:func:`theanompi_torch.convert.train_state_to_jax`; under ``zero1`` every
rank gathers its slices into the global buckets and rank 0 writes them),
so a run of either package resumes in the other.  ``try_resume``
(``resume``) restores the newest verifiable checkpoint: at one process
through the recovery chain, above one rank 0 decides (verifies,
quarantines, steps back) and broadcasts the epoch or the error before any
rank loads, so every rank restores the same state or raises the same
typed error.  A mid-epoch checkpoint re-enters its epoch at the saved
cursor; the dataset's ``set_state``, the manifest's ``lr_scale`` and the
recorder's histories come back with it.  ``run`` joins the writer at the
end (without letting its error hide one already raised) and drops the
``dirty`` marker.

Not carried by this slice, and refused rather than ignored: the elastic
reshard (``resume_reshard``), telemetry, the resilience stack (fault
plans, sentinel, watchdog, preemption) and the profiler window
(:data:`NOT_PORTED_KEYS`, each refused only where its value turns the
feature on), and the ``seq`` and ``pipe`` axes above 1 (item 13b).
"""

from __future__ import annotations

import functools
import os
import sys
from typing import Any

import torch
import torch.distributed as dist

from theanompi_torch import dist as tdist
from theanompi_torch.convert import train_state_from_jax, train_state_to_jax
from theanompi_torch.models.data.base import derive_seed
from theanompi_torch.models.data.prefetch import prefetch
from theanompi_torch.parallel.exchanger import (
    BucketExchange,
    flatten,
    fused_pmean,
)
from theanompi_torch.parallel import mesh
from theanompi_torch.parallel.mesh import resolve_device
from theanompi_torch.parallel.tensor import (
    check_divisible,
    full_like,
    gather_tree,
    shard_tree,
)
from theanompi_torch.tree import tree_leaves_with_path, tree_map, tree_to
from theanompi_torch.utils import checkpoint as ckpt_lib
from theanompi_torch.utils.helper_funcs import import_model, to_device
from theanompi_torch.utils.recorder import Recorder

def _watchdog_off(c: dict) -> bool:
    """The reference's ``watchdog_enabled`` false: False, or None with no
    heartbeat path (the key, or ``THEANOMPI_HEARTBEAT``)."""
    w = c.get("watchdog")
    return w is False or (w is None and not c.get("heartbeat_path")
                          and not os.environ.get("THEANOMPI_HEARTBEAT"))


def _preemption_off(c: dict) -> bool:
    """The reference's ``preemption_enabled`` false: False, or None
    outside a supervisor (``THEANOMPI_SUPERVISED``)."""
    h = c.get("handle_preemption")
    return h is False or (h is None and
                          os.environ.get("THEANOMPI_SUPERVISED") != "1")


#: the reference's rule-config features whose machinery is not ported yet
#: (for every rule: BSP, EASGD, LocalSGD and GOSGD): each feature's test
#: that a config leaves it off, as the reference resolves it
#: (``ResilienceConfig``, ``theanompi_tpu/resilience/__init__.py:83-102``,
#: and the trainer's ``resume_reshard``, ``telemetry_dir``, ``profile_dir``),
#: and its keys: the switch first, then the tuning keys, which change
#: nothing while it is off.  A key of a feature that the config turns on
#: raises instead of training without it
_UNPORTED = (
    (lambda c: not c.get("resume_reshard"), ("resume_reshard",)),
    (lambda c: c.get("telemetry_dir") is None,
     ("telemetry_dir", "telemetry_max_bytes", "telemetry_keep",
      "telemetry_health", "telemetry_blackbox", "telemetry_profile")),
    (lambda c: c.get("profile_dir") is None,
     ("profile_dir", "profile_window")),
    (lambda c: c.get("fault_plan") is None, ("fault_plan",)),
    (lambda c: c.get("sentinel_policy") is None,
     ("sentinel_policy", "sentinel_max_skips", "sentinel_max_rollbacks")),
    (_watchdog_off, ("watchdog", "watchdog_multiple", "watchdog_min_s",
                     "watchdog_poll_s", "heartbeat_path")),
    (_preemption_off, ("handle_preemption",)),
)
#: every key of :data:`_UNPORTED`
NOT_PORTED_KEYS = tuple(k for _, keys in _UNPORTED for k in keys)
#: the rule keys of the sharded mesh axes, by the reference's axis name
AXIS_KEYS = {"model": "n_model", "seq": "n_seq", "pipe": "n_pipe"}


def unported_keys(config: dict) -> list:
    """The keys of ``config`` whose feature it turns on and the port does
    not carry yet."""
    return sorted(k for off, keys in _UNPORTED if not off(config)
                  for k in keys if k in config)


#: the classes of a resume's error that every rank raises alike (the
#: last stands for any other)
_RESUME_ERRORS = (ckpt_lib.CheckpointChainExhausted,
                  ckpt_lib.CheckpointReshardableMismatch,
                  ckpt_lib.CheckpointFingerprintError, RuntimeError)


def pmean_floats(tree):
    """The mean of every floating leaf over the ranks, other leaves
    passing through (the reference's :57): one collective a dtype."""
    return fused_pmean(tree)


def require_data_parallel_mesh(config: dict, rule_name: str) -> None:
    """Refuse sharded axes for the async rules (the reference's :290):
    ``n_model``, ``n_seq`` or ``n_pipe`` above 1 in ``config``.  Their
    per-worker layout ignores the model's param specs, so a
    tensor-parallel layer's collectives would double-count."""
    for axis, key in AXIS_KEYS.items():
        size = int(config.get(key) or 1)
        if size > 1:
            raise ValueError(
                f"{rule_name} is data-parallel only: mesh axis {axis!r} has "
                f"size {size} (use BSP for tp/sp/pp shardings)")


def _leaves(tree) -> list:
    return [x for _, x in tree_leaves_with_path(tree)]


def _unflatten(tree, leaves: list):
    """A tree shaped like ``tree`` holding ``leaves`` in its leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _dropout_gen(device, seed: int, *key):
    """The dropout generator of one step (and micro-batch) on this rank,
    keyed by its data index."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed("dropout", seed, *key, *mesh.replica_key()))
    return gen


def value_and_grads(loss_of, params, hooks=None):
    """-> (loss, aux, grads of the loss against ``params``), where
    ``loss_of(params) -> (loss, aux)``.  ``hooks``: a
    :class:`BucketExchange` to arm on the differentiated leaves, so the
    exchange's collectives go out from backward."""
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    tree = _unflatten(params, leaves)
    if hooks is not None:
        hooks.arm(flatten(tree))
    loss, aux = loss_of(tree)
    return loss, aux, _unflatten(params, torch.autograd.grad(loss, leaves))


def loss_and_grads(model, params, state, batch, gen, hooks=None):
    """-> (new_state, metrics, grads) of one forward + backward
    (``train=True``; ``gen`` the dropout generator or None; ``hooks`` as
    :func:`value_and_grads`'s)."""
    _, (new_state, metrics), grads = value_and_grads(
        lambda p: model.loss_fn(p, state, batch, gen, train=True), params,
        hooks)
    return new_state, metrics, grads


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


def _custom_step(model, optimizer, exchanger, seed: int, n_subb: int):
    """The step of a model that supplies its own inner step
    (``make_custom_step(optimizer, seed, exchanger)``, the GAN's two
    updates; the reference's :103-130): the inner step does the
    forwards, backwards, exchanges and updates, the rule the mean of the
    metrics and the state over the ranks (with no exchanger, none: the
    worker's own).  ``n_subb > 1``, ``zero1`` and overlap need the
    standard grad step and are refused (``ValueError``, the launcher's
    78)."""
    who = f"{type(model).__name__} supplies make_custom_step"
    if n_subb > 1:
        raise ValueError(f"n_subb={n_subb} requires the standard grad step; "
                         f"{who}")
    if exchanger is not None and exchanger.fuses_update:
        raise ValueError(f"exch_strategy 'zero1' requires the standard grad "
                         f"step; {who}")
    if exchanger is not None and exchanger.overlap:
        raise ValueError(f"exch_overlap requires the standard grad step; "
                         f"{who}")
    inner = model.make_custom_step(optimizer, seed, exchanger)
    if exchanger is None:
        return inner

    def custom_step(params, state, opt_state, batch, lr, step):
        new_params, new_state, new_opt_state, metrics = inner(
            params, state, opt_state, batch, lr, step)
        with torch.no_grad():
            metrics = fused_pmean(metrics)
            new_state = fused_pmean(new_state)
        return new_params, new_state, new_opt_state, metrics

    return custom_step


def make_train_step(model, optimizer, exchanger, seed: int, device,
                    specs_of=None):
    """The per-step function: ``step(params, state, opt_state, batch, lr,
    step) -> (new_params, new_state, new_opt_state, metrics)`` — loss and
    backward (over ``n_subb`` micro-batches when the model config asks;
    hooked, under ``exchanger.overlap``, so the buckets' collectives go out
    from backward), the exchange and the optimizer update (one call under
    ``zero1``) under ``torch.no_grad``, then the float metrics and the new
    model state averaged over the ranks (one collective a dtype; already
    equal under sync-BN, the mean repairs drift otherwise).  A model with
    ``make_custom_step`` runs its own inner step instead
    (:func:`_custom_step`).  ``exchanger=None`` is the async rules'
    collective-free local step: the update from this rank's own grads,
    its own metrics and state.  ``specs_of() ->`` the params' specs under
    a model group, read at each step (clipping's norm is the whole
    tree's)."""
    n_subb = int(model.config.get("n_subb", 1) or 1)
    if hasattr(model, "make_custom_step"):
        return _custom_step(model, optimizer, exchanger, seed, n_subb)
    if exchanger is None:
        return _local_step(model, optimizer, seed, device, n_subb)

    def train_step(params, state, opt_state, batch, lr, step):
        xseed = derive_seed("exchange", seed, step, *mesh.replica_key())
        hooks = (BucketExchange(exchanger, params, xseed, reverse=True)
                 if exchanger.overlap and mesh.data_size() > 1 else None)
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
                    grads, opt_state, params, lr,
                    param_specs=specs_of() if specs_of else None)
            metrics = fused_pmean(metrics)
            new_state = fused_pmean(new_state)
        return new_params, new_state, new_opt_state, metrics

    return train_step


def _local_step(model, optimizer, seed: int, device, n_subb: int):
    """:func:`make_train_step` with no exchanger (the reference's
    ``make_local_step(stacked=True)``)."""
    def local_step(params, state, opt_state, batch, lr, step):
        if n_subb == 1:
            new_state, metrics, grads = loss_and_grads(
                model, params, state, batch, _dropout_gen(device, seed, step))
        else:
            new_state, metrics, grads = _accumulated_grads(
                model, params, state, batch, seed, step, device, n_subb)
        with torch.no_grad():
            new_params, new_opt_state = optimizer.update(grads, opt_state,
                                                         params, lr)
        return new_params, new_state, new_opt_state, metrics

    return local_step


def _bound(method):
    """Run a trainer method with the trainer's layout bound."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with self.layout.bound():
            return method(self, *args, **kwargs)
    return run


def close_feed(batches) -> None:
    """Close a prefetcher or generator (None and plain iterators: no-op)."""
    close = getattr(batches, "close", None)
    if close is not None:
        close()


class BaseTrainer:
    """Iterate-validate-record skeleton; a rule supplies ``init_state``
    and the exchanger (reference names: ``compile_iter_fns``,
    ``train_iter``, ``val_iter``).  ``layout``: the rank layout (None:
    the data-only one over the process group)."""

    def __init__(self, model, device=None, recorder: Recorder | None = None,
                 seed: int = 0, prefetch_depth: int = 2,
                 prefetch_stall_timeout: float | None = None,
                 checkpoint_dir: str | None = None, checkpoint_keep: int = 3,
                 checkpoint_async: bool = True,
                 checkpoint_verify: str = "auto",
                 checkpoint_every_n_iters: int = 0,
                 resume_force: bool = False,
                 layout: mesh.Layout | None = None):
        self.model = model
        self.layout = layout if layout is not None else mesh.make_layout()
        self.prefetch_depth = int(prefetch_depth)
        self.prefetch_stall_timeout = (
            None if prefetch_stall_timeout is None
            else float(prefetch_stall_timeout))
        self.device = resolve_device(device)
        self.recorder = recorder or Recorder()
        self.seed = seed
        self.optimizer = model.build_optimizer()
        # rank: the process's, which decides who writes; the workers and
        # their batch rows are the data axis's
        self.rank, self.world = tdist.rank(), tdist.world()
        self.n_workers = self.layout.n_data
        self.global_batch = model.batch_size * self.n_workers
        #: the params' specs under a model group (None: nothing is cut)
        self.specs = None
        self.exchanger = None
        self._step_fn = None
        self.params = None
        self.state = None
        self.opt_state = None
        self.epoch = 0
        self.iteration = 0
        #: the lineage's LR factor, carried from a manifest (1.0 unless a
        #: reshard, which the port does not carry yet, changed it)
        self.lr_scale = 1.0
        self._epoch_start_iter = 0
        self._resume_data_state: dict | None = None
        #: (epoch, the dataset's state as that epoch's batches start), taken
        #: before its prefetcher's producer can run ahead of training
        self._data_at_start: tuple[int, dict] | None = None
        self._zero1_layout_cache = None
        if checkpoint_verify not in ("auto", "fast", "full", "none"):
            raise ValueError(f"checkpoint_verify must be auto/fast/full/"
                             f"none, got {checkpoint_verify!r}")
        self.checkpoint_verify = checkpoint_verify
        self.checkpoint_every_n_iters = int(checkpoint_every_n_iters or 0)
        if self.checkpoint_every_n_iters < 0:
            raise ValueError(f"checkpoint_every_n_iters must be >= 0, got "
                             f"{checkpoint_every_n_iters}")
        self.checkpointer = None
        if checkpoint_dir:
            # every rank holds one (each reads the chosen file at a
            # resume); rank 0 alone writes, sweeps and marks the directory
            self.checkpointer = ckpt_lib.Checkpointer(
                checkpoint_dir, keep=checkpoint_keep,
                async_save=bool(checkpoint_async),
                fingerprint=self._run_fingerprint,
                resume_force=bool(resume_force), encode=self._encode,
                decode=self._decode, writer=self.rank == 0,
                verbose=self.recorder.verbose)

    # -- rule surface ---------------------------------------------------------
    def init_opt_state(self):
        """The optimizer state of ``self.params``."""
        return self.model.init_opt_state(self.optimizer, self.params)

    @_bound
    def init_state(self) -> None:
        """Fresh fp32 params and model state from a CPU generator seeded
        ``seed + 1`` (the reference's ``PRNGKey(seed + 1)``; the same
        values whatever the device, so every rank starts alike) and their
        optimizer state, on the device (:meth:`place`)."""
        self.place(*self.model.init_params(
            torch.Generator().manual_seed(self.seed + 1)))

    @_bound
    def place(self, params, state) -> None:
        """Take whole params and model state (the reference's global
        layout) as this rank's: its shards under a model group (the
        model's ``param_specs``), on the device, with a fresh optimizer
        state."""
        lay = self.layout
        if lay.n_model > 1:
            self.specs = self.model.param_specs(params)
            check_divisible(params, self.specs, lay.n_model)
            params = shard_tree(params, self.specs, lay.model_index,
                                lay.n_model)
        self.params = tree_to(params, self.device)
        self.state = tree_to(state, self.device)
        self.opt_state = self.init_opt_state()

    def gathered(self, tree, specs=None):
        """``tree`` (the params, or a tree shaped like them: ``specs``
        None takes :attr:`specs`) in the global layout: the shards joined
        over the model group (a collective), or as it is without one."""
        specs = self.specs if specs is None else specs
        if specs is None:
            return tree
        return gather_tree(tree, specs, self.layout.model_group,
                           self.layout.n_model)

    def _maybe_ramp(self, epoch: int) -> None:
        """Epoch-boundary hook, called at the top of each epoch (BSP swaps
        its exchanger by ``exch_ramp`` here)."""

    def _fingerprint_extra(self) -> dict:
        """Rule-specific fingerprint entries (BSP: the ramp and overlap
        knobs)."""
        return {}

    def compile_iter_fns(self) -> None:
        """Build the step closure around the rule's exchanger."""
        self._step_fn = make_train_step(self.model, self.optimizer,
                                        self.exchanger, self.seed,
                                        self.device, lambda: self.specs)

    def post_step(self) -> None:
        """The rule's periodic exchange, after every step, with
        ``self.iteration`` already advanced (the async rules)."""

    def warmup_exchange(self) -> None:
        """Run the rule's periodic exchange once (``post_step`` may not
        fire it on the first steps)."""

    def eval_args(self) -> tuple:
        """-> (params, state) that validation evaluates."""
        return self.params, self.state

    @_bound
    def warmup(self) -> None:
        """Run every path once (a step, the rule's exchange, a validation
        batch), then reset to a fresh init: timing harnesses call this so
        that their window holds no kernel build or first-call cost.  The
        dataset's state (the token stream's cursors) is put back too."""
        data = self.model.data
        start = data.state()
        gen = self.train_batches(0)
        try:
            batch = next(iter(gen))
        finally:
            close_feed(gen)
        self.train_iter(batch, self.model.adjust_hyperp(0))
        self.warmup_exchange()
        vb = min(self.global_batch, data.n_val)
        vb -= vb % self.n_workers  # validate's rule
        if vb:
            vgen = data.val_batches(vb, rows=self.rows(vb))
            try:
                vbatch = next(iter(vgen), None)
            finally:
                close_feed(vgen)
            if vbatch is not None:
                self.val_iter(vbatch)
        data.set_state(start)
        self.init_state()
        self.reset_iter()

    def reset_iter(self) -> None:
        """Zero the iteration and epoch counters and start a fresh
        recorder with the same settings."""
        self.iteration = 0
        self.epoch = 0
        self._epoch_start_iter = 0
        self._resume_data_state = None
        r = self.recorder
        self.recorder = Recorder(print_freq=r.print_freq,
                                 save_dir=r.save_dir, verbose=r.verbose,
                                 reduce=r.reduce)

    # -- iteration ------------------------------------------------------------
    @_bound
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
        self.post_step()
        r.end_iteration()
        r.train_metrics(**metrics)
        r.print_train_info(self.iteration)
        return metrics

    def rows(self, global_rows: int) -> tuple[int, int]:
        """This rank's rows of a global batch of ``global_rows``: its data
        index's (the ranks of a model group take the same rows)."""
        b = global_rows // self.n_workers
        d = self.layout.data_index
        return d * b, (d + 1) * b

    def train_batches(self, epoch: int, start_batch: int = 0):
        """This rank's rows of the epoch's global batches, from batch
        ``start_batch`` on."""
        return self.model.data.train_batches(
            self.global_batch, epoch, seed=self.seed,
            start_batch=start_batch, rows=self.rows(self.global_batch))

    def _make_prefetcher(self, epoch: int, start_batch: int = 0):
        """The epoch's batches on this rank's device, ``prefetch_depth``
        ahead on a thread (0: the numpy iterator itself, placed in
        :meth:`train_iter`).  Close it when done (``close``).  Records the
        dataset's state first: the producer exhausts the epoch's generator
        (which advances the token stream's cursors) up to ``depth`` batches
        before training reaches the end, so a save must not read the live
        state while it runs."""
        self._data_at_start = (epoch, self.model.data.state())
        return prefetch(self.train_batches(epoch, start_batch),
                        device=self.device, depth=self.prefetch_depth,
                        stall_timeout=self.prefetch_stall_timeout,
                        start_batch=start_batch)

    @_bound
    def val_iter(self, batch: dict, eval_args=None) -> dict:
        """The metrics of this rank's share of a validation batch, on
        ``eval_args`` (None: :meth:`eval_args`, which may be collective:
        :meth:`validate` takes it once for all its batches)."""
        batch = to_device(batch, self.device)
        params, state = (eval_args if eval_args is not None
                         else self.eval_args())
        with torch.no_grad():
            _, (_, metrics) = self.model.loss_fn(params, state, batch, None,
                                                 train=False)
        return metrics

    @_bound
    def validate(self, epoch: int) -> dict:
        # the largest worker-divisible batch, as the reference (:1024)
        vb = min(self.global_batch, self.model.data.n_val)
        vb -= vb % self.n_workers
        if vb == 0:
            return {}
        accums: dict[str, list] = {}
        eval_args = self.eval_args()
        for batch in self.model.data.val_batches(vb, rows=self.rows(vb)):
            for k, v in self.val_iter(batch, eval_args).items():
                accums.setdefault(k, []).append(v)  # one pull after the loop
        # each batch's metrics averaged over the ranks, in one collective
        stacked = fused_pmean({k: torch.stack(v) for k, v in accums.items()})
        means = {k: float(v.double().mean()) for k, v in stacked.items()}
        if {"perplexity", "cost"} <= means.keys():
            means["perplexity"] = float(torch.tensor(means["cost"]).exp())
        self.recorder.val_metrics(epoch, **means)
        return means

    # -- checkpoints ----------------------------------------------------------
    def checkpoint_trees(self) -> dict:
        """The named trees a checkpoint holds, live (the restore's
        templates)."""
        return {"params": self.params, "state": self.state,
                "opt_state": self.opt_state}

    def _tree_specs(self) -> dict | None:
        """The specs of :meth:`checkpoint_trees` (None: nothing is cut):
        the params', each params-shaped tree of the optimizer state's
        (SGD's velocity, Adam's moments), the rest replicated."""
        if self.specs is None:
            return None
        return {"params": self.specs,
                "state": tree_map(lambda _: None, self.state),
                "opt_state": {k: self.specs if isinstance(v, dict) else None
                              for k, v in self.opt_state.items()}}

    def _zero1_layout(self):
        """``zero1``'s bucket layout at this run's world (None for the
        per-leaf strategies)."""
        if not self.exchanger.fuses_update:
            return None
        if self._zero1_layout_cache is None:
            self._zero1_layout_cache = self.exchanger.zero1_layout(
                self.params, self.n_workers)
        return self._zero1_layout_cache

    def _encode(self, trees: dict) -> dict:
        return train_state_to_jax(trees, zero1_layout=self._zero1_layout())

    def _decode(self, arrays: dict, templates: dict) -> dict:
        layout = self._zero1_layout()
        return train_state_from_jax(
            arrays, templates,
            zero1=None if layout is None else (layout, self.rank,
                                               self.n_workers))

    def _run_fingerprint(self) -> dict:
        """The run fingerprint of the manifests (the reference's :571):
        the mesh (the process group as the reference's ``data`` axis, the
        other axes 1), the exchange strategy, ``n_subb`` and the model's
        identity, so a port run at N ranks matches a reference run on an
        N-device mesh."""
        return {
            "mesh": {"data": self.n_workers, "pipe": 1,
                     "model": self.layout.n_model, "seq": 1},
            "exchange": getattr(self.exchanger, "strategy",
                                type(self).__name__),
            "n_subb": int(self.model.config.get("n_subb", 1) or 1),
            **ckpt_lib.model_fingerprint(self.model),
            **self._fingerprint_extra(),
        }

    def _data_state(self, epoch: int, completed: bool) -> dict:
        """The data plane's position (the reference's :607): the cursor in
        samples, and the dataset's own state (the token stream's cursors)
        as the epoch a resume enters starts: ``epoch`` inside it, the next
        after its end."""
        cursor = max(0, self.iteration - self._epoch_start_iter)
        enters = epoch + 1 if completed else epoch
        if self._data_at_start is not None and \
                self._data_at_start[0] == enters:
            dataset = self._data_at_start[1]
        else:
            # the last epoch's end: no prefetcher runs ahead, the live
            # state is the next epoch's start
            dataset = self.model.data.state()
        return {"version": 1, "epoch": int(epoch),
                "completed": bool(completed), "batch_cursor": int(cursor),
                "sample_cursor": int(cursor) * int(self.global_batch),
                "global_batch": int(self.global_batch),
                "seed": int(self.seed), "dataset": dataset}

    @_bound
    def save_checkpoint(self, epoch: int, completed: bool = True):
        """Start a save of the train state as epoch ``epoch``; -> its
        handle on rank 0 (None elsewhere, or without a directory).
        ``completed=False``: a save inside the epoch, whose manifest
        carries the cursor a resume re-enters the epoch at.  Under
        ``zero1`` above one rank every rank gathers the buckets first
        (a collective), so every rank calls this."""
        if self.checkpointer is None:
            return None
        trees = self.checkpoint_trees()
        gathered = []
        specs = self._tree_specs()
        if specs is not None:
            if self.layout.data_index != 0:
                return None
            # rank 0's model group gathers its shards; rank 0 writes them
            trees = {k: self.gathered(v, specs[k]) for k, v in trees.items()}
            gathered = [x for k in trees for (_, x), (_, d) in zip(
                tree_leaves_with_path(trees[k]),
                tree_leaves_with_path(specs[k])) if d is not None]
        if self.exchanger.fuses_update and self.n_workers > 1:
            trees["opt_state"] = self.exchanger.zero1_gather_opt_state(
                trees["opt_state"])
            if self.rank == 0:  # fresh buckets, this save's alone
                gathered = [x for v in trees["opt_state"].values()
                            if isinstance(v, list) for x in v]
        if self.rank != 0:
            return None
        return self.checkpointer.save(
            epoch, self.iteration, trees,
            recorder_snapshot=self.recorder.history_snapshot(),
            lr_scale=self.lr_scale,
            data_state=self._data_state(epoch, completed),
            handed_over=gathered)

    @_bound
    def reserve_checkpoint_staging(self) -> None:
        """Allocate the pinned host memory that rank 0's saves stage the
        card's leaves through, before the first step: the first save's
        snapshot then costs what the later ones do."""
        if self.checkpointer is None or self.rank != 0:
            return
        trees = self._full_templates(
            "meta" if self.device.type == "cuda" else None)
        if self.exchanger.fuses_update:
            trees["opt_state"] = self.exchanger.zero1_gathered_like(
                trees["opt_state"])
        self.checkpointer.reserve(trees)

    def _full_templates(self, device=None) -> dict:
        """:meth:`checkpoint_trees` in the global layout, uninitialised
        (``device`` None: each leaf's own) where a tree is cut; the live
        trees where nothing is."""
        trees, specs = self.checkpoint_trees(), self._tree_specs()
        if specs is None:
            return trees
        return {k: full_like(v, specs[k], self.layout.n_model, device)
                for k, v in trees.items()}

    def _cut(self, restored: dict) -> dict:
        """Restored global-layout trees -> this rank's shards."""
        specs, lay = self._tree_specs(), self.layout
        if specs is None:
            return restored
        return {k: shard_tree(v, specs[k], lay.model_index, lay.n_model)
                for k, v in restored.items()}

    def _resume_verify_level(self) -> str:
        """``auto``: the full per-leaf hash after an unclean exit (the
        ``dirty`` marker), the structural check otherwise."""
        if self.checkpoint_verify != "auto":
            return self.checkpoint_verify
        return "full" if self.checkpointer.was_unclean() else "fast"

    @_bound
    def try_resume(self) -> bool:
        """Restore the newest verifiable checkpoint; -> resumed or not.
        Call after ``init_state`` (the fresh state is the template).  Rank
        0 alone runs the recovery chain (verify, quarantine, step back) and
        restores; above one rank it then broadcasts the epoch it restored,
        or the class of its error, and the other ranks read that epoch
        unverified, or raise the same typed error, so none is left waiting
        at the next collective.  An exhausted chain raises
        ``CheckpointChainExhausted`` (the launcher's 77), another run's
        checkpoint ``CheckpointFingerprintError`` (78) unless
        ``resume_force``."""
        ck = self.checkpointer
        if ck is None:
            return False
        code, epoch, iteration, err, res = 0, -1, 0, None, None
        if self.rank == 0:
            try:
                res = ck.load_latest_verified(
                    self._full_templates(),
                    verify=self._resume_verify_level())
            except Exception as e:
                if self.world == 1:
                    raise
                err = e
                code = next((i for i, c in enumerate(_RESUME_ERRORS, 1)
                             if isinstance(e, c)), len(_RESUME_ERRORS))
            if res is not None:
                epoch, iteration, restored = res
        if self.world > 1:
            agreed = torch.tensor([code, epoch, iteration],
                                  dtype=torch.int64, device=self.device)
            dist.broadcast(agreed, 0)
            code, epoch, iteration = (int(x) for x in agreed.tolist())
            if err is not None:
                raise err
            if code:
                raise _RESUME_ERRORS[code - 1](
                    "the resume failed on rank 0 (see its log)")
        if epoch < 0:
            return False
        if self.rank == 0:
            man = ck.last_loaded_manifest or {}
        else:
            restored = ck.load(epoch, self._full_templates(), verify="none")
            man = ckpt_lib.read_manifest(ck._path(epoch))
        for name, tree in self._cut(restored).items():
            setattr(self, name, tree)
        ds = man.get("data_state")
        if ds and not ds.get("completed", True):
            # a save inside the epoch: re-enter it at the saved cursor
            self.epoch = int(ds.get("epoch", epoch))
            self._resume_data_state = dict(ds)
        else:
            self.epoch = epoch + 1
        self.iteration = iteration
        if ds and isinstance(ds.get("dataset"), dict) and ds["dataset"]:
            # cursors that persist across epochs (the token stream's)
            self.model.data.set_state(ds["dataset"])
        self.lr_scale = float(man.get("lr_scale", 1.0) or 1.0)
        self.recorder.load(ck.directory)
        if self.recorder.verbose:
            where = (f"mid-epoch {self.epoch} at batch "
                     f"{self._resume_data_state['batch_cursor']}"
                     if self._resume_data_state is not None
                     else f"epoch {epoch}")
            print(f"resumed from {where} (iteration {self.iteration})",
                  flush=True)
        return True

    def _start_batch(self, epoch: int) -> int:
        """The batch ``epoch`` starts at: a mid-epoch resume's cursor (in
        samples, divided by this run's global batch), else 0; sets where
        the epoch's steps are counted from."""
        rds, self._resume_data_state = self._resume_data_state, None
        start = 0
        if rds is not None and int(rds.get("epoch", -1)) == epoch:
            sc = int(rds.get("sample_cursor", 0))
            start = sc // self.global_batch
            if sc % self.global_batch:
                print(f"trainer: resume sample cursor {sc} is not "
                      f"divisible by the global batch {self.global_batch}; "
                      f"flooring to batch {start} (the partial batch "
                      f"replays)", file=sys.stderr, flush=True)
        self._epoch_start_iter = self.iteration - start
        return start

    def _run_epochs(self, stop=None) -> None:
        model = self.model
        batches = None
        cad = self.checkpoint_every_n_iters
        try:
            for epoch in range(self.epoch, model.n_epochs):
                self.epoch = epoch
                self._maybe_ramp(epoch)
                start_batch = self._start_batch(epoch)
                self.recorder.start_epoch()
                lr = model.adjust_hyperp(epoch) * self.lr_scale
                if batches is None:  # not built at the last boundary
                    batches = self._make_prefetcher(epoch, start_batch)
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
                        if cad and (self.iteration
                                    - self._epoch_start_iter) % cad == 0:
                            # a save inside the epoch, superseded by the
                            # next one and by the boundary's (same label)
                            self.save_checkpoint(epoch, completed=False)
                finally:
                    close_feed(batches)
                    batches = None
                # the next epoch's queue fills while the host validates
                # and the checkpoint's snapshot is taken
                if epoch + 1 < model.n_epochs:
                    batches = self._make_prefetcher(epoch + 1)
                val = self.validate(epoch)
                self.save_checkpoint(epoch)
                self._epoch_start_iter = self.iteration
                self.epoch = epoch + 1
                if stop is not None and stop(epoch, val):
                    break
        finally:
            # an early stop or an exception leaves the next epoch's
            # prefetcher open: stop its thread
            close_feed(batches)

    @_bound
    def run(self, stop=None):
        """Train to completion; ``stop(epoch, val_metrics) -> bool`` may
        end it early.  -> the recorder."""
        if self._step_fn is None:
            self.compile_iter_fns()
        if self.params is None:
            self.init_state()
        ck = self.checkpointer
        try:
            try:
                self.reserve_checkpoint_staging()
                self._run_epochs(stop)
            except BaseException:
                # the writer's error must not hide the one raised (often
                # the same cause: a full disk)
                if ck is not None:
                    try:
                        ck.join_pending()
                    except Exception as e:
                        print(f"checkpoint writer failed during teardown: "
                              f"{e}", file=sys.stderr, flush=True)
                raise
            if ck is not None:
                # joins the writer (raising its error), then drops the
                # dirty marker: the next resume may trust the fast verify
                ck.mark_clean()
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

    def check_config(self) -> None:
        """Rule-specific refusals of the rule config, before any other
        (the async rules refuse sharded axes)."""

    def make_trainer(self, model, device, recorder) -> BaseTrainer:
        raise NotImplementedError

    def init(self, devices=None,
             modelfile: str = "theanompi_torch.models.transformer_lm",
             modelclass: str = "TransformerLM",
             model_config: dict | None = None, device=None):
        self.check_config()
        unported = unported_keys(self.config)
        if unported:
            raise NotImplementedError(
                f"rule keys {unported} not yet ported (ROADMAP queue 1: "
                f"the reshard and the resilience stack item 14, "
                f"telemetry item 15)")
        self.layout = mesh.make_layout(
            *(self.config.get(AXIS_KEYS[a], 1) for a in ("model", "seq",
                                                         "pipe")))
        n, k = self.layout.n_data, self.layout.n_model
        if devices is not None and devices != n:
            raise ValueError(
                f"devices={devices!r} in a run of {tdist.world()} rank(s) "
                f"at n_model={k}: start {devices * k} ranks "
                f"(theanompi_torch.dist.spawn, or the launcher's --devices "
                f"{devices}), each calling init")
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
        if self.config.get("resume"):
            self.trainer.try_resume()
        return self

    def trainer_kwargs(self) -> dict:
        """The rule config's keys that every trainer takes."""
        c = self.config
        return {"layout": getattr(self, "layout", None),
                "seed": c.get("seed", 0),
                "prefetch_depth": c.get("prefetch", 2),
                "prefetch_stall_timeout": c.get("prefetch_stall_timeout"),
                "checkpoint_dir": c.get("checkpoint_dir"),
                "checkpoint_keep": c.get("checkpoint_keep", 3),
                "checkpoint_async": c.get("checkpoint_async", True),
                "checkpoint_verify": c.get("checkpoint_verify", "auto"),
                "checkpoint_every_n_iters": c.get(
                    "checkpoint_every_n_iters", 0),
                "resume_force": bool(c.get("resume_force", False))}

    def wait(self):
        """Run training to completion; -> the recorder."""
        if self.trainer is None:
            raise RuntimeError("call init() before wait()")
        return self.trainer.run()
