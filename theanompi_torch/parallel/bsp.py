"""BSP: synchronous data-parallel training, one process per rank.

Counterpart of ``theanompi_tpu/parallel/bsp.py`` (``BSPTrainer`` :41,
``BSP`` :244).  The reference traces one SPMD step over a device mesh;
the port runs the step on every rank of a ``torch.distributed`` process
group (or one process alone): forward and backward on the rank's rows of
the global batch, the exchanger's mean-reduce of the grads, the optimizer
update (fused with the exchange under ``zero1``), then the metrics and
model state averaged over the ranks.  The rule key ``n_model`` makes
model groups of that many ranks (tensor and expert parallelism;
:mod:`theanompi_torch.parallel.mesh`): the exchange and the means then
run over the data groups.  ``exch_overlap`` issues the
buckets' collectives from backward, and ``exch_ramp`` swaps the exchange
strategy at epoch boundaries (:mod:`theanompi_torch.parallel.overlap`).
The run fingerprint of its checkpoints carries the ramp's base strategy
and the ramp and overlap knobs (``_fingerprint_extra``, the reference's
:215-229), so a checkpoint written in any ramp phase matches a resume of
the same run; a resume lands in the phase its epoch dictates.
"""

from __future__ import annotations

from theanompi_torch.dist import DATA_AXIS
from theanompi_torch.parallel.exchanger import BUCKETED_STRATEGIES, Exchanger
from theanompi_torch.parallel.overlap import RampSchedule
from theanompi_torch.parallel.tensor import sharded
from theanompi_torch.parallel.trainer import BaseTrainer, Rule


class BSPTrainer(BaseTrainer):
    """Drives the BSP step for one model on one rank's device."""

    def __init__(self, model, exch_strategy: str = "psum",
                 exch_bucket_mb: float = 4.0, exch_overlap: bool = False,
                 exch_ramp: str | None = None, **kwargs):
        super().__init__(model, **kwargs)
        self.exch_strategy_base = exch_strategy
        self.exch_overlap = bool(exch_overlap)
        self.ramp = (RampSchedule.parse(exch_ramp, exch_strategy)
                     if exch_ramp else None)
        bucket_bytes = int(float(exch_bucket_mb) * 2**20)

        def build(strategy, overlap):
            return Exchanger(strategy=strategy, bucket_bytes=bucket_bytes,
                             overlap=overlap)

        # every phase's exchanger is built now, so a bad phase fails here
        # and not at its epoch; overlap applies to the bucketed phases
        self._ramp_exchangers = {
            s: build(s, self.exch_overlap and s in BUCKETED_STRATEGIES)
            for s in (self.ramp.strategies if self.ramp else ())}
        self.exchanger = (self._ramp_exchangers.get(exch_strategy)
                          or build(exch_strategy, self.exch_overlap))

    def init_opt_state(self):
        """The optimizer state of ``self.params``: under ``zero1`` this
        rank's slices of the flat buckets, else the model's tree.
        ``zero1`` over params cut by a model group is refused
        (``ValueError``; the reference's :103-118): a flat bucket of one
        rank's shards is not the data group's replicated bucket."""
        if self.exchanger.fuses_update and self.specs is not None \
                and sharded(self.specs):
            raise ValueError(
                f"exch_strategy 'zero1' requires replicated (data-parallel) "
                f"params; the model's specs shard leaves over mesh axis "
                f"'model' (size {self.layout.n_model})")
        if self.exchanger.fuses_update:
            return self.exchanger.zero1_init_opt_state(
                self.optimizer, self.params, self.n_workers)
        return super().init_opt_state()

    def _fingerprint_extra(self) -> dict:
        """The base strategy under a ramp (the active one varies by
        epoch), and the ramp and overlap knobs where set: changing either
        across a resume is a change of run."""
        extra = {}
        if self.ramp is not None:
            extra["exchange"] = self.exch_strategy_base
            extra["exch_ramp"] = self.ramp.describe()
        if self.exch_overlap:
            extra["exch_overlap"] = True
        return extra

    def _maybe_ramp(self, epoch: int) -> None:
        """Activate the ramp phase of ``epoch``: swap in its exchanger
        (built at construction) and rebuild the step closure."""
        if self.ramp is None:
            return
        want = self.ramp.strategy_for_epoch(epoch)
        if want != self.exchanger.strategy:
            self.exchanger = self._ramp_exchangers[want]
            self.compile_iter_fns()


class BSP(Rule):
    """Synchronous data-parallel rule (see :class:`Rule` for usage)."""

    def adjust_model_config(self, model_config: dict, n_workers: int) -> None:
        if n_workers > 1:
            # more than one worker: cross-replica BN statistics by default
            model_config.setdefault("bn_axis", DATA_AXIS)

    def make_trainer(self, model, device, recorder) -> BSPTrainer:
        return BSPTrainer(
            model, exch_strategy=self.config.get("exch_strategy", "psum"),
            exch_bucket_mb=self.config.get("exch_bucket_mb", 4.0),
            exch_overlap=bool(self.config.get("exch_overlap", False)),
            exch_ramp=self.config.get("exch_ramp") or None,
            device=device, recorder=recorder, **self.trainer_kwargs())
