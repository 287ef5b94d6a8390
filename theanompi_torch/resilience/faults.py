"""Deterministic fault injection: the reference's grammar, the serving
sites hooked.

The port's copy of ``theanompi_tpu/resilience/faults.py``.  A plan comes
from ``THEANOMPI_FAULT_PLAN`` (or an explicit spec string); specs are
separated by ``;`` or ``,``::

    SITE:ACTION@INDEX[@ATTEMPT]

    serve:raise@6        raise FaultInjected at serving decode step 6
    serve:stall@6        decode step 6 hangs for THEANOMPI_SERVE_STALL_S
                         seconds (default 2.0)
    serve:rollout_corrupt@0    flip a byte of the 1st rollout CANDIDATE's
                         .npz before the watcher verifies it (candidate
                         ordinal, not decode step)

``INDEX`` is, for ``serve``, the decode-step ordinal (``raise`` and
``stall``, fired by the scheduler) or the rollout-candidate ordinal
(``rollout_corrupt``, fired by the rollout watcher): the two hooks count
different things, so each narrows its ``fire`` by action.  The optional
``ATTEMPT`` gates a spec to one supervisor attempt (``THEANOMPI_ATTEMPT``;
an unsupervised process is attempt 1).  Each spec fires at most once per
process.

The grammar knows every site of the reference (:data:`SITES`); only the
sites in :data:`HOOKED` have hooks in the port.  A spec naming any other
site or action is refused as a :class:`FaultPlanError` that says "not yet
ported", so a plan can never parse and then silently never fire.

Zero cost when absent: with no plan every injection point is one
``is None`` check.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


class FaultInjected(RuntimeError):
    """An injected failure (never raised unless a fault plan asked for it)."""


class FaultPlanError(ValueError):
    """A fault-plan string that does not parse, or names a site the port
    has not hooked yet."""


#: valid actions per injection site (the reference's grammar)
SITES = {
    "step": ("raise", "kill", "nan"),
    "prefetch": ("stall", "raise"),
    "data": ("torn_read", "stall"),
    "checkpoint": ("fail", "truncate", "bitflip", "manifest_drop"),
    "reshard": ("fail",),
    "fleet": ("kill_job", "ledger_torn_write"),
    "serve": ("raise", "stall", "rollout_corrupt"),
    "easgd": ("worker_slow",),
    "gosgd": ("gossip_drop",),
}

#: the actions whose hooks exist in the port, per site
HOOKED = {
    "serve": ("raise", "stall", "rollout_corrupt"),
}


def current_attempt() -> int:
    """The supervisor attempt this process is (1 when unsupervised)."""
    try:
        return int(os.environ.get("THEANOMPI_ATTEMPT", "1"))
    except ValueError:
        return 1


@dataclass
class FaultSpec:
    site: str
    action: str
    index: int
    attempt: int | None = None
    fired: bool = field(default=False, compare=False)

    def matches(self, site: str, index: int,
                action: str | None = None) -> bool:
        return (
            not self.fired
            and self.site == site
            and self.index == int(index)
            and (action is None or self.action == action)
            and (self.attempt is None or self.attempt == current_attempt())
        )


class FaultPlan:
    """An ordered list of one-shot :class:`FaultSpec` entries."""

    def __init__(self, specs: list[FaultSpec]):
        self.specs = specs

    def __repr__(self) -> str:
        return f"FaultPlan({self.specs!r})"

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        specs = []
        for raw in text.replace(";", ",").split(","):
            raw = raw.strip()
            if not raw:
                continue
            head, _, rest = raw.partition("@")
            site, _, action = head.partition(":")
            site, action = site.strip(), action.strip()
            if site not in SITES:
                raise FaultPlanError(
                    f"unknown fault site {site!r} in {raw!r} "
                    f"(sites: {', '.join(SITES)})")
            if action not in SITES[site]:
                raise FaultPlanError(
                    f"action {action!r} invalid for site {site!r} in {raw!r} "
                    f"(valid: {', '.join(SITES[site])})")
            if action not in HOOKED.get(site, ()):
                raise FaultPlanError(
                    f"fault site {site}:{action} in {raw!r} not yet ported "
                    f"(hooked: "
                    + ", ".join(f"{s}:{a}" for s, acts in HOOKED.items()
                                for a in acts) + ")")
            if not rest:
                raise FaultPlanError(f"missing @INDEX in fault spec {raw!r}")
            parts = rest.split("@")
            if len(parts) > 2:
                raise FaultPlanError(f"too many '@' in fault spec {raw!r}")
            try:
                index = int(parts[0])
                attempt = int(parts[1]) if len(parts) == 2 else None
            except ValueError as e:
                raise FaultPlanError(
                    f"non-integer index/attempt in fault spec {raw!r}"
                ) from e
            specs.append(FaultSpec(site, action, index, attempt))
        if not specs:
            raise FaultPlanError(f"empty fault plan {text!r}")
        return cls(specs)

    @classmethod
    def from_spec(cls, spec: "str | FaultPlan | None") -> "FaultPlan | None":
        """Build from an explicit spec string, falling back to the
        ``THEANOMPI_FAULT_PLAN`` env var; None when neither is set."""
        if isinstance(spec, FaultPlan):
            return spec
        text = spec or os.environ.get("THEANOMPI_FAULT_PLAN")
        return cls.parse(text) if text else None

    def fire(self, site: str, index: int,
             action: str | None = None) -> str | None:
        """The action to inject at (site, index) now, or None.  Marks the
        matched spec fired so it cannot trigger twice in one process.
        ``action`` narrows the match to one action, for a site whose
        actions count different ordinals."""
        for s in self.specs:
            if s.matches(site, index, action):
                s.fired = True
                return s.action
        return None
