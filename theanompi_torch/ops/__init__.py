"""Ops of the port: layers, losses, the optimizer, the int8 format,
attention, and the wrappers of the hand-written kernels (kernels 1-5)."""
