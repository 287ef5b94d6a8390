"""The model contract: the interface the rules drive models through.

Counterpart of ``theanompi_tpu/models/contract.py`` (``Model`` :35 and
the training hooks of ``SupervisedModel`` :124) for one process.  The
model owns what is trained: its config (``default_config`` merged with the caller's), the
precision policy (``precision``: ``"bf16"``, the default, or anything else
for fp32), ``batch_size``/``n_epochs``, its data (``build_data``, built at
first use, so a serving process never builds a training set), the
optimizer choice (``build_optimizer``: SGD from the config), the LR
schedule (``adjust_hyperp``), ``init_params`` and ``loss_fn``.  The
rule's trainer owns how steps run.
"""

from __future__ import annotations

from typing import Any

from theanompi_torch.ops.opt import SGD
from theanompi_torch.parallel.mesh import BF16, FP32, Precision


class Model:
    default_config: dict[str, Any] = {}

    def __init__(self, config: dict[str, Any] | None = None):
        self.config = {**self.default_config, **(config or {})}
        self.verbose = self.config.get("verbose", True)
        self.batch_size = self.config.get("batch_size", 128)
        self.n_epochs = self.config.get("n_epochs", 10)
        self.precision: Precision = (
            BF16 if self.config.get("precision", "bf16") == "bf16" else FP32)
        self.vocab = int(self.config.get("vocab", 256))
        self._data = None

    @property
    def data(self):
        """The dataset, built by :meth:`build_data` at first use."""
        if self._data is None:
            self._data = self.build_data()
        return self._data

    # -- construction hooks -------------------------------------------------
    def build_data(self):
        raise NotImplementedError

    def build_optimizer(self):
        return SGD(
            momentum=self.config.get("momentum", 0.9),
            weight_decay=self.config.get("weight_decay", 0.0),
            nesterov=self.config.get("nesterov", False),
            grad_clip=self.config.get("grad_clip"),
        )

    def init_opt_state(self, optimizer, params):
        """Optimizer-state layout (GANs would split it per network)."""
        return optimizer.init(params)

    # -- what the trainer runs ----------------------------------------------
    def init_params(self, gen):
        """-> fp32 param tree on ``gen``'s device."""
        raise NotImplementedError

    def loss_fn(self, params, batch, gen, train: bool):
        """-> (loss, metrics).  ``gen`` is the dropout generator (None
        outside training)."""
        raise NotImplementedError

    # -- schedule -----------------------------------------------------------
    def adjust_hyperp(self, epoch: int) -> float:
        """Learning rate for ``epoch``: the base LR with step decay at the
        configured epochs (the reference method name)."""
        lr = self.config.get("lr", 0.1)
        for e in self.config.get("lr_decay_epochs", ()):
            if epoch >= e:
                lr *= self.config.get("lr_decay_factor", 0.1)
        return lr

    def cleanup(self) -> None:
        if self._data is not None:
            self._data.cleanup()
