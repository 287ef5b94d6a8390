"""Weight initializers on an explicit ``torch.Generator``.

Counterparts of ``theanompi_tpu/ops/initializers.py``'s ``normal``,
``uniform``, ``he_normal``, ``glorot_normal``, ``glorot_uniform`` and
``orthogonal``: ``fn(generator, shape, dtype) -> tensor`` on the
generator's device.  The bits differ from ``jax.random`` by
design; tests that need the reference's weights convert them
(:mod:`theanompi_torch.convert`).
"""

from __future__ import annotations

import math

import torch


def _fans(shape):
    """(fan_in, fan_out) for dense ``[in, out]`` weights and conv kernels
    in the port's OIHW layout ``[out, in, *window]``: fan_in = in x
    window, fan_out = out x window.  (The reference reads HWIO, its
    layout; reading OIHW with that rule would give the wrong scale.)"""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _randn(gen: torch.Generator, shape, dtype):
    return torch.randn(tuple(shape), generator=gen, dtype=dtype,
                       device=gen.device)


def zeros(gen, shape, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)


def ones(gen, shape, dtype=torch.float32):
    return torch.ones(tuple(shape), dtype=dtype, device=gen.device)


def normal(stddev=0.01, mean=0.0):
    """Plain gaussian."""

    def init(gen, shape, dtype=torch.float32):
        return mean + stddev * _randn(gen, shape, dtype)

    return init


def uniform(scale=0.01):
    """Uniform on ``[-scale, scale)``."""

    def init(gen, shape, dtype=torch.float32):
        u = torch.rand(tuple(shape), generator=gen, dtype=dtype,
                       device=gen.device)
        return (2.0 * u - 1.0) * scale

    return init


def he_normal(gen, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    return _randn(gen, shape, dtype) * math.sqrt(2.0 / fan_in)


def glorot_normal(gen, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    return _randn(gen, shape, dtype) * math.sqrt(2.0 / (fan_in + fan_out))


def glorot_uniform(gen, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=gen, dtype=dtype,
                   device=gen.device)
    return (2.0 * u - 1.0) * limit


def orthogonal(scale=1.0):
    """Orthogonal init (the LSTM's recurrent kernel): the Q of a gaussian
    matrix's QR, signs fixed by R's diagonal, over the flattened leading
    dims against the last."""

    def init(gen, shape, dtype=torch.float32):
        if len(shape) < 2:
            raise ValueError("orthogonal init needs >= 2 dims")
        rows, cols = math.prod(shape[:-1]), shape[-1]
        mat = _randn(gen, (max(rows, cols), min(rows, cols)), dtype)
        q, r = torch.linalg.qr(mat)
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        return scale * q[:rows, :cols].reshape(tuple(shape))

    return init
