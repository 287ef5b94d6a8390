"""Precision and device plumbing, the exchanger seam, the trainer core and
the BSP rule (one process)."""
