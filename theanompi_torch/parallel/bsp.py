"""BSP: synchronous data-parallel training, one process per rank.

Counterpart of ``theanompi_tpu/parallel/bsp.py`` (``BSPTrainer`` :41,
``BSP`` :244).  The reference traces one SPMD step over a device mesh;
the port runs the step on every rank of a ``torch.distributed`` process
group (or one process alone): forward and backward on the rank's rows of
the global batch, the exchanger's mean-reduce of the grads, the optimizer
update, then the metrics and model state averaged over the ranks.
"""

from __future__ import annotations

import torch

from theanompi_torch.dist import DATA_AXIS
from theanompi_torch.parallel.exchanger import Exchanger
from theanompi_torch.parallel.trainer import BaseTrainer, Rule
from theanompi_torch.tree import tree_to


class BSPTrainer(BaseTrainer):
    """Drives the BSP step for one model on one rank's device."""

    def __init__(self, model, exch_strategy: str = "psum",
                 exch_bucket_mb: float = 4.0, **kwargs):
        super().__init__(model, **kwargs)
        self.exchanger = Exchanger(
            strategy=exch_strategy,
            bucket_bytes=int(float(exch_bucket_mb) * 2**20))

    def init_state(self) -> None:
        """Fresh fp32 params and model state from a CPU generator seeded
        ``seed + 1`` (the reference's ``PRNGKey(seed + 1)``; the same
        values whatever the device, so every rank starts alike) and the
        params' optimizer state, on the device."""
        params, state = self.model.init_params(
            torch.Generator().manual_seed(self.seed + 1))
        self.params = tree_to(params, self.device)
        self.state = tree_to(state, self.device)
        self.opt_state = self.model.init_opt_state(self.optimizer,
                                                   self.params)


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
            device=device, recorder=recorder,
            seed=self.config.get("seed", 0))
