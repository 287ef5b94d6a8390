"""The exit-code contract, in one leaf module with no imports.

The port's copy of ``theanompi_tpu/resilience/codes.py:10-21``: the
launcher's exits and the codes a supervisor classifies them by, so a run
of either package ends with the same code for the same cause.
"""

EXIT_CLEAN = 0
EXIT_CRASH = 70      # EX_SOFTWARE: unhandled training exception
EXIT_PREEMPTED = 75  # EX_TEMPFAIL: clean resumable preemption exit
EXIT_HANG = 76       # EX_PROTOCOL (repurposed): watchdog-confirmed stall
EXIT_CKPT = 77       # EX_NOPERM (repurposed): checkpoint recovery chain
#                      exhausted, or a checkpoint failed verification
EXIT_CONFIG = 78     # EX_CONFIG: bad flags, config, model import, or a
#                      checkpoint of another run (fingerprint mismatch)
EXIT_RESHARD = 79    # an elastic resume could not replan the checkpoint
#                      onto the live topology
