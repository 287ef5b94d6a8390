"""The port's share of the resilience layer: the exit-code contract
(:mod:`~theanompi_torch.resilience.codes`) and the crash-safe event log
inside ``<checkpoint dir>/resilience.json``
(:mod:`~theanompi_torch.resilience.events`), which the checkpoint
recovery chain writes.  Supervision, the sentinel, the watchdog and
preemption come with a later slice."""
