"""The gradient exchanger, for one process.

Counterpart of ``theanompi_tpu/parallel/exchanger.py``'s ``Exchanger`` at
a world of one process: ``psum`` (the reference's default) and ``none``
are the identity there, which is what this seam does.  Every other
strategy, and any world above one process (refused by the rule), waits
for the multi-rank exchanger (NCCL collectives over ``torch.distributed``)
and raises.
"""

from __future__ import annotations

#: strategies this seam carries: both are the identity at one process
STRATEGIES = ("psum", "none")


class Exchanger:
    def __init__(self, strategy: str = "psum"):
        if strategy not in STRATEGIES:
            raise NotImplementedError(
                f"exch_strategy {strategy!r} not yet ported (ROADMAP queue "
                f"1 item 5)")
        self.strategy = strategy

    def exchange(self, grads):
        """Mean-reduce ``grads`` across the world: at one process, the
        grads themselves."""
        return grads
