"""BSP: synchronous data-parallel training, for one process.

Counterpart of ``theanompi_tpu/parallel/bsp.py`` (``BSPTrainer`` :41,
``BSP`` :244).  The reference traces one SPMD step over a device mesh;
the port runs one process per card under ``torch.distributed``, and this
slice is the one-process case: the step is forward, backward, the
exchanger's mean-reduce (the identity at one process), the optimizer
update.  Multi-rank exchange comes with the exchanger slice.
"""

from __future__ import annotations

import torch

from theanompi_torch.parallel.exchanger import Exchanger
from theanompi_torch.parallel.trainer import BaseTrainer, Rule
from theanompi_torch.tree import tree_to


class BSPTrainer(BaseTrainer):
    """Drives the BSP step for one model on one device."""

    def __init__(self, model, exch_strategy: str = "psum", **kwargs):
        super().__init__(model, **kwargs)
        self.exchanger = Exchanger(strategy=exch_strategy)

    def init_state(self) -> None:
        """Fresh fp32 params and model state from a CPU generator seeded
        ``seed + 1`` (the reference's ``PRNGKey(seed + 1)``; the same
        values whatever the device) and the params' optimizer state, on
        the device."""
        params, state = self.model.init_params(
            torch.Generator().manual_seed(self.seed + 1))
        self.params = tree_to(params, self.device)
        self.state = tree_to(state, self.device)
        self.opt_state = self.model.init_opt_state(self.optimizer,
                                                   self.params)


class BSP(Rule):
    """Synchronous data-parallel rule (see :class:`Rule` for usage)."""

    def make_trainer(self, model, device, recorder) -> BSPTrainer:
        return BSPTrainer(
            model, exch_strategy=self.config.get("exch_strategy", "psum"),
            device=device, recorder=recorder,
            seed=self.config.get("seed", 0))
