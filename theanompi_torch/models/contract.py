"""The model contract, minimal: config merge, precision, vocab.

Counterpart of ``theanompi_tpu/models/contract.py``'s ``Model`` base.  A
model merges its ``default_config`` with the caller's, takes its precision
policy from ``precision`` (``"bf16"``, the default, or anything else for
fp32) and its vocabulary size from ``vocab``.  The data planes (PTB, the
token stream) and the training hooks come with the training slice.
"""

from __future__ import annotations

from typing import Any

from theanompi_torch.parallel.mesh import BF16, FP32, Precision


class Model:
    default_config: dict[str, Any] = {}

    def __init__(self, config: dict[str, Any] | None = None):
        self.config = {**self.default_config, **(config or {})}
        self.precision: Precision = (
            BF16 if self.config.get("precision", "bf16") == "bf16" else FP32)
        self.vocab = int(self.config.get("vocab", 256))

    def init_params(self, gen):
        """-> fp32 param tree on ``gen``'s device."""
        raise NotImplementedError
