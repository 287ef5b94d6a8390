"""The port's share of the resilience layer: the exit-code contract
(:mod:`~theanompi_torch.resilience.codes`), the crash-safe event log
inside ``<checkpoint dir>/resilience.json``
(:mod:`~theanompi_torch.resilience.events`), which the checkpoint
recovery chain writes, and the fault-plan grammar
(:mod:`~theanompi_torch.resilience.faults`), whose serving sites are
hooked.  Supervision, the sentinel, the watchdog, preemption and the
training and checkpoint fault sites come with a later slice."""
