"""The exchange ramp.

Counterpart of ``theanompi_tpu/parallel/overlap.py``.  Its other half, the
overlap of the bucketed exchange with backward (``fence`` and
``overlap_pred``, :61-84), is
:class:`theanompi_torch.parallel.exchanger.BucketExchange`, beside
:meth:`~theanompi_torch.parallel.exchanger.Exchanger.start_bucket`: the
fused exchange runs through the same class, and the exchanger's module
docstring says how backward's hooks issue the buckets.

:class:`RampSchedule` (:87-173) parses ``"ring_int8:5,psum_bf16_bucket:10"``
(int8 on the wire for epochs [0, 5), bf16 for [5, 10), then the base
strategy); the trainer swaps its exchanger at epoch boundaries only
(``BSPTrainer._maybe_ramp``).
"""

from __future__ import annotations

import dataclasses

from theanompi_torch.parallel.exchanger import (
    BUCKETED_STRATEGIES,
    LEAFWISE_STRATEGIES,
)


@dataclasses.dataclass(frozen=True)
class RampSchedule:
    """Epoch-indexed exchange-strategy phases parsed from ``exch_ramp``.

    ``phases`` is ``((strategy, until_epoch), ...)`` — each phase active
    for epochs ``< until_epoch`` — then the base strategy for every later
    epoch (``until_epoch`` None).  Boundaries strictly increase; the phase
    of an epoch is a function of the absolute epoch alone."""

    phases: tuple  # ((strategy, until_epoch | None), ...); last is the base

    @classmethod
    def parse(cls, spec: str, base_strategy: str) -> "RampSchedule":
        """Parse ``"strategy:until_epoch,..."`` (e.g. ``"ring_int8:5"``).

        ``zero1`` is refused anywhere in a ramp: its optimizer state is
        laid out in the exchanger's sharded buckets and cannot be re-laid
        out at a phase boundary."""
        known = set(LEAFWISE_STRATEGIES) | set(BUCKETED_STRATEGIES)
        phases = []
        last_until = 0
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            if ":" not in part:
                raise ValueError(
                    f"exch_ramp phase {part!r} must be 'strategy:until_epoch'")
            name, until_s = part.rsplit(":", 1)
            name = name.strip()
            try:
                until = int(until_s)
            except ValueError:
                raise ValueError(
                    f"exch_ramp boundary {until_s!r} is not an epoch number")
            if name not in known:
                raise ValueError(f"unknown exch_ramp strategy {name!r}; "
                                 f"available: {sorted(known)}")
            if until <= last_until:
                raise ValueError(
                    f"exch_ramp boundaries must be strictly increasing; "
                    f"got {until} after {last_until}")
            phases.append((name, until))
            last_until = until
        if not phases:
            raise ValueError(f"empty exch_ramp spec {spec!r}")
        for name, _ in phases + [(base_strategy, None)]:
            if name == "zero1":
                raise ValueError(
                    "zero1 cannot participate in an exch_ramp: its optimizer "
                    "state is laid out in the exchanger's sharded buckets and "
                    "cannot be re-laid-out at a phase boundary")
        phases.append((base_strategy, None))
        return cls(phases=tuple(phases))

    @property
    def strategies(self) -> tuple:
        """Every strategy the ramp can activate, in phase order."""
        return tuple(dict.fromkeys(name for name, _ in self.phases))

    def phase_for_epoch(self, epoch: int) -> int:
        for i, (_, until) in enumerate(self.phases):
            if until is None or epoch < until:
                return i
        return len(self.phases) - 1

    def strategy_for_epoch(self, epoch: int) -> str:
        return self.phases[self.phase_for_epoch(epoch)][0]

    def describe(self) -> str:
        """The spec back, with the base strategy last."""
        return ",".join(name if until is None else f"{name}:{until}"
                        for name, until in self.phases)
