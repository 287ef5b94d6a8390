"""Ops of the port: layers, the int8 format, attention, and the wrappers of
the hand-written kernels (kernels 1, 4, 5)."""
