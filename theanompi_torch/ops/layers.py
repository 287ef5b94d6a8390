"""The layers the transformer slices need: ``Dense``, ``Dropout``,
``LayerNorm``, ``Embedding``.

Counterparts of ``theanompi_tpu/ops/layers.py`` (``Dense``, ``Dropout``
:284, ``LayerNorm`` :359, ``Embedding`` :412).  Each layer is an ``nn.Module`` that holds its
configuration; its weights live in a param tree passed to ``forward``
(the ``torch.func.functional_call`` style), laid out exactly as the
reference's tree, so a converted checkpoint, the int8 transform and the
precision policy address the same leaves:

- ``init(generator, in_shape) -> (params, out_shape)`` — fp32 params on the
  generator's device;
- ``forward(params, x)`` — computes in ``x.dtype``; the caller's precision
  policy decides the dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from theanompi_torch.ops import initializers as init_lib
from theanompi_torch.ops import quant


class Layer(nn.Module):
    """Base: a parameter-free module whose weights come in ``params``."""

    def init(self, gen: torch.Generator, in_shape):
        return {}, tuple(in_shape)

    def forward(self, params, x):
        return x

    @property
    def name(self) -> str:
        """Tree key stem, the reference's ``type(self).__name__.lower()``."""
        return type(self).__name__.lower()


class Dense(Layer):
    """Fully-connected over the trailing dim; ``w`` is ``[Din, Dout]``
    used as ``x @ w`` (the reference's layout, which the int8 band layout
    depends on — never transposed into ``nn.Linear``'s)."""

    def __init__(self, units: int, use_bias: bool = True,
                 w_init=init_lib.normal(0.02), b_init=init_lib.zeros):
        super().__init__()
        self.units = units
        self.use_bias = use_bias
        self.w_init = w_init
        self.b_init = b_init

    def init(self, gen, in_shape):
        params = {"w": self.w_init(gen, (in_shape[-1], self.units))}
        if self.use_bias:
            params["b"] = self.b_init(gen, (self.units,))
        return params, (*in_shape[:-1], self.units)

    def forward(self, params, x):
        # matmul_any: ``x @ w`` for tensors; int8 QuantizedTensor leaves go
        # through the int8 matmul kernel (kernel 5)
        y = quant.matmul_any(x, params["w"])
        if self.use_bias:
            y = y + params["b"].to(x.dtype)
        return y


class Dropout(Layer):
    """Inverted dropout: in training each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)`` in its own
    dtype, else zeroed; outside training the identity.  The keep mask is
    drawn from the explicit ``torch.Generator`` the caller passes (the
    trainer seeds one per step), on that generator's device."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, params, x, train: bool = False, gen=None):
        if not train or self.rate == 0.0:
            return x
        if gen is None:
            raise ValueError("Dropout needs a generator when train=True")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class LayerNorm(Layer):
    """Layer norm over the trailing dim: fp32 row statistics (population
    variance), elementwise math in the input dtype, eps 1e-6 — the
    reference's numerics, not ``torch.nn.LayerNorm``'s."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps

    def init(self, gen, in_shape):
        c = in_shape[-1]
        return ({"scale": init_lib.ones(gen, (c,)),
                 "bias": init_lib.zeros(gen, (c,))}, tuple(in_shape))

    def forward(self, params, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        inv = torch.rsqrt(var + self.eps)
        y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        return y * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


class Embedding(Layer):
    """Token embedding: ``[..., ] int -> [..., dim]``."""

    def __init__(self, vocab: int, dim: int, w_init=init_lib.normal(0.02)):
        super().__init__()
        self.vocab = vocab
        self.dim = dim
        self.w_init = w_init

    def init(self, gen, in_shape):
        return ({"w": self.w_init(gen, (self.vocab, self.dim))},
                (*in_shape, self.dim))

    def forward(self, params, x):
        return params["w"][x]
