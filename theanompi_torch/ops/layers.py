"""The layer library: the transformer's ``Dense``, ``Dropout``,
``LayerNorm`` and ``Embedding``, the conv nets' ``Activation``,
``Conv2D``, ``ConvTranspose2D``, ``MaxPool``/``AvgPool``,
``GlobalAvgPool``, ``Flatten``, ``BatchNorm``, ``LRN`` and
``Sequential``, and the ``LSTM`` layer.

Counterparts of ``theanompi_tpu/ops/layers.py`` (``Activation`` :78,
``Dense`` :86, ``Conv2D`` :112, ``ConvTranspose2D`` :167, ``_Pool``
:208, ``GlobalAvgPool`` :263, ``Flatten`` :273, ``Dropout`` :284,
``BatchNorm`` :297, ``LayerNorm`` :359, ``LRN`` :384, ``Embedding`` :412,
``LSTM`` :427, ``Sequential`` :473).  Each layer is an
``nn.Module`` that holds its configuration; its weights live in a param
tree passed to ``forward`` (the ``torch.func.functional_call`` style),
keyed exactly as the reference's tree, so a converted checkpoint, the int8
transform and the precision policy address the same leaves:

- ``init(generator, in_shape) -> (params, out_shape)`` — fp32 params on the
  generator's device;
- ``forward(params, x)`` — computes in ``x.dtype``; the caller's precision
  policy decides the dtype.

Layers that carry state (``BatchNorm``'s running statistics, and the
containers that hold one) follow the reference's pair instead, which
:class:`Layer` also gives every stateless layer, so :class:`Sequential`
drives both kinds through it:

- ``init_stateful(generator, in_shape) -> (params, state, out_shape)``;
- ``apply_stateful(params, state, x, train=False, gen=None) -> (y,
  new_state)``.

Layout: activations are NCHW tensors (``torch.channels_last`` in memory
when they come from an NHWC batch, which is what cuDNN's fastest Hopper
convolutions take), conv kernels OIHW (``F.conv2d``'s), and per-example
shapes ``(C, H, W)``.  The reference is NHWC/HWIO;
:mod:`theanompi_torch.convert` transposes kernels.  ``"SAME"`` padding is
the reference's (XLA's): at stride 2 the odd pad goes at the end, which
torch's ``padding="same"`` does not take, so pads are computed here and
applied with ``F.pad`` where they are not symmetric.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from theanompi_torch import dist as tdist
from theanompi_torch.dist import DATA_AXIS
from theanompi_torch.ops import initializers as init_lib
from theanompi_torch.ops import quant
from theanompi_torch.parallel import mesh


class Layer(nn.Module):
    """Base: a parameter-free module whose weights come in ``params``."""

    def init(self, gen: torch.Generator, in_shape):
        return {}, tuple(in_shape)

    def forward(self, params, x):
        return x

    def init_stateful(self, gen: torch.Generator, in_shape):
        params, out_shape = self.init(gen, in_shape)
        return params, {}, out_shape

    def apply_stateful(self, params, state, x, train: bool = False,
                       gen=None):
        return self(params, x), state

    @property
    def name(self) -> str:
        """Tree key stem, the reference's ``type(self).__name__.lower()``."""
        return type(self).__name__.lower()


class StatefulLayer(Layer):
    """Base of the layers that carry state: they run only through
    ``init_stateful``/``apply_stateful``."""

    def init(self, gen, in_shape):
        raise TypeError(f"{type(self).__name__} carries state: use "
                        f"init_stateful")

    def forward(self, params, x):
        raise TypeError(f"{type(self).__name__} carries state: use "
                        f"apply_stateful")


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

    def apply_stateful(self, params, state, x, train: bool = False,
                       gen=None):
        return self(params, x, train, gen), state


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


# -- the conv nets' layers ----------------------------------------------------

def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _same_pads(size: int, window: int, stride: int, dilation: int = 1):
    """XLA's ``"SAME"`` pads of one spatial dim: the output is
    ``ceil(size / stride)``, the odd pad goes at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (window - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _pads(padding, hw, window, stride, dilation=(1, 1)):
    """``padding`` (``"SAME"``, ``"VALID"``, an int, or pairs
    ``((top, bottom), (left, right))``) -> ``((top, bottom), (left,
    right))``."""
    if padding == "SAME":
        return tuple(_same_pads(*a) for a in zip(hw, window, stride,
                                                 dilation))
    if padding == "VALID":
        return (0, 0), (0, 0)
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    return tuple(tuple(p) for p in padding)


def _out_size(size, pads, window, stride, dilation=1):
    return (size + sum(pads) - (window - 1) * dilation - 1) // stride + 1


def _pad(x, pads, value=0.0):
    """-> (x padded where the pads are not symmetric, the symmetric pads
    left for the op itself)."""
    (t, b), (l, r) = pads
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


#: the reference's activation table (``jax.nn.gelu`` is the tanh form)
ACTIVATIONS = {
    "relu": F.relu,
    "relu6": F.relu6,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.2),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "identity": lambda x: x,
}


class Activation(Layer):
    def __init__(self, kind: str = "relu"):
        super().__init__()
        if kind not in ACTIVATIONS:
            raise ValueError(f"activation {kind!r} not in "
                             f"{sorted(ACTIVATIONS)}")
        self.kind = kind

    def forward(self, params, x):
        return ACTIVATIONS[self.kind](x)


class Conv2D(Layer):
    """2-D convolution (the reference's ``Conv`` on cuDNN): ``w`` is OIHW
    ``[filters, C / groups, kh, kw]``, ``b`` ``[filters]``; ``padding`` is
    ``"SAME"`` (the default), ``"VALID"``, an int or pairs."""

    def __init__(self, filters: int, kernel=3, stride=1, padding="SAME",
                 dilation=1, groups: int = 1, use_bias: bool = True,
                 w_init=init_lib.he_normal, b_init=init_lib.zeros):
        super().__init__()
        self.filters = filters
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.padding = padding
        self.dilation = _pair(dilation)
        self.groups = groups
        self.use_bias = use_bias
        self.w_init = w_init
        self.b_init = b_init

    def _pads(self, hw):
        return _pads(self.padding, hw, self.kernel, self.stride,
                     self.dilation)

    def init(self, gen, in_shape):
        c, h, w = in_shape
        params = {"w": self.w_init(gen, (self.filters, c // self.groups,
                                         *self.kernel))}
        if self.use_bias:
            params["b"] = self.b_init(gen, (self.filters,))
        pads = self._pads((h, w))
        out = tuple(_out_size(*a) for a in zip(
            (h, w), pads, self.kernel, self.stride, self.dilation))
        return params, (self.filters, *out)

    def forward(self, params, x):
        x, sym = _pad(x, self._pads(x.shape[2:]))
        return F.conv2d(x, params["w"].to(x.dtype),
                        params["b"].to(x.dtype) if self.use_bias else None,
                        self.stride, sym, self.dilation, self.groups)


def _conv_transpose_pads(size_k: int, stride: int, padding):
    """``lax.conv_transpose``'s pads of the stride-dilated input on one
    spatial dim, for ``"SAME"`` and ``"VALID"`` (a pair passes as it
    is)."""
    k, s = size_k, stride
    if padding == "SAME":
        total = k + s - 2
        before = k - 1 if s > k - 1 else -(-total // 2)
    elif padding == "VALID":
        total = k + s - 2 + max(k - s, 0)
        before = k - 1
    else:
        return tuple(padding)
    return before, total - before


class ConvTranspose2D(Layer):
    """Transposed convolution (DCGAN's generator), the reference's
    ``lax.conv_transpose`` without ``transpose_kernel``: a plain
    convolution of the stride-dilated input with ``w`` as it is, no
    spatial flip and no swap of in and out.  ``w`` is stored as
    ``Conv2D``'s, OIHW ``[filters, C, kh, kw]`` (what the converter's
    generic HWIO -> OIHW transpose makes of the reference's ``(kh, kw, C,
    filters)``), and handed to ``F.conv_transpose2d`` — the gradient of a
    convolution, which flips the kernel in space and takes ``[C, filters,
    kh, kw]`` — flipped and swapped here.  ``padding``: ``"SAME"`` (the
    output is ``stride`` times the input), ``"VALID"`` or pairs
    ``((top, bottom), (left, right))`` of the dilated input."""

    def __init__(self, filters: int, kernel=4, stride=2, padding="SAME",
                 use_bias: bool = True, w_init=init_lib.he_normal,
                 b_init=init_lib.zeros):
        super().__init__()
        self.filters = filters
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.padding = padding
        self.use_bias = use_bias
        self.w_init = w_init
        self.b_init = b_init

    def _pads(self):
        pads = (self.padding if not isinstance(self.padding, str)
                else (self.padding,) * 2)
        return tuple(_conv_transpose_pads(k, s, p) for k, s, p in zip(
            self.kernel, self.stride, pads))

    def init(self, gen, in_shape):
        c, h, w = in_shape
        params = {"w": self.w_init(gen, (self.filters, c, *self.kernel))}
        if self.use_bias:
            params["b"] = self.b_init(gen, (self.filters,))
        out = tuple((n - 1) * s + 1 + sum(p) - k + 1 for n, s, p, k in zip(
            (h, w), self.stride, self._pads(), self.kernel))
        return params, (self.filters, *out)

    def forward(self, params, x):
        w = params["w"].to(x.dtype).flip(2, 3).transpose(0, 1)
        b = params["b"].to(x.dtype) if self.use_bias else None
        (t, bt), (lf, r) = self._pads()
        kh, kw = self.kernel
        if t == bt and lf == r and t <= kh - 1 and lf <= kw - 1:
            # at padding p, conv_transpose2d pads the dilated input by
            # k - 1 - p a side
            return F.conv_transpose2d(x, w, b, self.stride,
                                      (kh - 1 - t, kw - 1 - lf))
        # uneven pads: pad k - 1 a side, then crop (or zero-pad) the output
        y = F.conv_transpose2d(x, w, None, self.stride)
        y = F.pad(y, (lf - kw + 1, r - kw + 1, t - kh + 1, bt - kh + 1))
        return y if b is None else y + b.reshape(1, -1, 1, 1)


class _Pool(Layer):
    def __init__(self, window=2, stride=None, padding="VALID"):
        super().__init__()
        self.window = _pair(window)
        self.stride = _pair(stride if stride is not None else window)
        self.padding = padding

    def _pads(self, hw):
        return _pads(self.padding, hw, self.window, self.stride)

    def init(self, gen, in_shape):
        c, h, w = in_shape
        out = tuple(_out_size(*a) for a in zip(
            (h, w), self._pads((h, w)), self.window, self.stride))
        return {}, (c, *out)


class MaxPool(_Pool):
    """Max over windows; padded cells are ``-inf``."""

    def forward(self, params, x):
        # torch's own (symmetric) padding is -inf too
        x, sym = _pad(x, self._pads(x.shape[2:]), value=float("-inf"))
        return F.max_pool2d(x, self.window, self.stride, sym)


class AvgPool(_Pool):
    """Mean over windows: with ``"SAME"`` the sum over the count of
    unpadded cells (the reference's), otherwise over the window size."""

    def _sum(self, x, pads):
        x, sym = _pad(x, pads)
        return F.avg_pool2d(x, self.window, self.stride, sym,
                            divisor_override=1)

    def forward(self, params, x):
        pads = self._pads(x.shape[2:])
        summed = self._sum(x, pads)
        if self.padding == "SAME":
            return summed / self._sum(x.new_ones((1, 1, *x.shape[2:])), pads)
        return summed / float(math.prod(self.window))


class GlobalAvgPool(Layer):
    def init(self, gen, in_shape):
        return {}, (in_shape[0],)

    def forward(self, params, x):
        return x.mean(dim=(2, 3))


class Flatten(Layer):
    """``[N, C, H, W] -> [N, H*W*C]`` in the reference's NHWC order, so a
    converted ``Dense`` after it needs no row permutation."""

    def init(self, gen, in_shape):
        return {}, (math.prod(in_shape),)

    def forward(self, params, x):
        if x.ndim == 4:
            x = x.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)


class BatchNorm(StatefulLayer):
    """Batch normalization over the channel dim (dim 1), with the
    reference's semantics, not ``F.batch_norm``'s (whose running update
    takes the unbiased variance, weighted by ``1 - momentum`` the other
    way round):

    - train: the batch mean and ``E[x^2]`` reduced in fp32 (reductions
      with an fp32 result; no fp32 copy of ``x``), var = max(E[x^2] -
      mean^2, 0), the biased variance; running stats ``momentum * old +
      (1 - momentum) * batch``, fp32, carried out of the step detached;
    - eval: the running stats;
    - the normalize is ``x * inv + shift`` in ``x``'s dtype, with ``inv``
      and ``shift`` folded in fp32 from the (compute-dtype) scale and bias.

    ``axis_name`` is the reference's sync-BN: ``"data"`` averages the
    batch mean and ``E[x^2]`` over the data axis (the process group, or
    under a sharded :class:`~theanompi_torch.parallel.mesh.Layout` its
    data group) before the variance, the running update and the
    normalize, through an all-reduce that autograd runs through (its
    backward sums the cotangents over the group, as the transpose of the
    reference's ``pmean`` does); at one data worker it changes nothing."""

    def __init__(self, momentum: float = 0.9, eps: float = 1e-5,
                 axis_name=None, scale_init=init_lib.ones,
                 bias_init=init_lib.zeros):
        super().__init__()
        if axis_name not in (None, DATA_AXIS):
            raise ValueError(
                f"BatchNorm axis_name={axis_name!r}: the port's one axis is "
                f"{DATA_AXIS!r}, the process group")
        self.axis_name = axis_name
        self.momentum = momentum
        self.eps = eps
        self.scale_init = scale_init
        self.bias_init = bias_init

    def init_stateful(self, gen, in_shape):
        c = in_shape[0]
        params = {"scale": self.scale_init(gen, (c,)),
                  "bias": self.bias_init(gen, (c,))}
        state = {"mean": torch.zeros((c,), device=gen.device),
                 "var": torch.ones((c,), device=gen.device)}
        return params, state, tuple(in_shape)

    def apply_stateful(self, params, state, x, train: bool = False,
                       gen=None):
        dims = [d for d in range(x.ndim) if d != 1]
        acc = torch.promote_types(x.dtype, torch.float32)  # fp32 or wider
        if train:
            n = x.numel() // x.shape[1]
            mean = x.mean(dim=dims, dtype=acc)
            # the sum of squares accumulated in acc inside the reduction
            root = torch.linalg.vector_norm(x, 2, dim=dims, dtype=acc)
            mean_sq = root * root / n
            n_data = mesh.data_size()
            if self.axis_name is not None and n_data > 1:
                stats = tdist.all_reduce_sum(torch.stack([mean, mean_sq]),
                                             mesh.data_group())
                mean, mean_sq = stats / n_data
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            m = self.momentum
            new_state = {"mean": m * state["mean"] + (1 - m) * mean.detach(),
                         "var": m * state["var"] + (1 - m) * var.detach()}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        inv = torch.rsqrt(var + self.eps) * params["scale"].to(acc)
        shift = params["bias"].to(acc) - mean * inv
        shape = [1, -1] + [1] * (x.ndim - 2)
        y = (x * inv.to(x.dtype).reshape(shape)
             + shift.to(x.dtype).reshape(shape))
        return y, new_state


class LRN(Layer):
    """Across-channel local response normalization (AlexNet, GoogLeNet):
    ``x / (k + alpha / size * S)^beta``, ``S`` the sum of ``x^2`` over a
    window of ``size`` channels, the channel dim (1) zero-padded by
    ``size // 2`` on both sides; computed in fp32 and cast back, as the
    reference's windowed sum."""

    def __init__(self, size: int = 5, alpha: float = 1e-4,
                 beta: float = 0.75, k: float = 2.0):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def forward(self, params, x):
        xf = x.float()
        half = self.size // 2
        sq = F.pad(xf.square(), (0, 0) * (x.ndim - 2) + (half, half))
        window = sq.unfold(1, self.size, 1).sum(dim=-1)
        y = xf / torch.pow(self.k + (self.alpha / self.size) * window,
                           self.beta)
        return y.to(x.dtype)


def _forget_bias(hidden: int, like: torch.Tensor) -> torch.Tensor:
    """The ``+1.0`` on the forget gate (gate order i, f, g, o) as a
    ``[4H]`` bias."""
    one = like.new_zeros(4 * hidden)
    one[hidden:2 * hidden] = 1.0
    return one


def lstm_loop(x, wx, wh, b):
    """The reference's recurrence (``lax.scan``), step by step: ``x [B,
    T, D] -> h [B, T, H]`` from zero state; the input projection
    ``x @ wx + b`` hoisted out of the loop, gates ``i, f, g, o``, the
    forget gate ``sigmoid(f + 1)``.  The plain version that
    :func:`lstm_fused`, the layer's path, is held to."""
    hidden = wh.shape[0]
    xproj = x @ wx + b
    h = x.new_zeros((x.shape[0], hidden))
    c = x.new_zeros((x.shape[0], hidden))
    hs = []
    for t in range(x.shape[1]):
        i, f, g, o = (xproj[:, t] + h @ wh).chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def lstm_fused(x, wx, wh, b):
    """The same recurrence through ATen's LSTM (``torch._VF.lstm``:
    cuDNN's for fp32 on the card, ATen's fused cell otherwise), whose gate
    order is also ``i, f, g, o``: ``wx``/``wh`` go in transposed, ``b`` as
    the input bias and the forget gate's ``+1`` as the hidden bias, built
    here, so the params stay the reference's."""
    hidden = wh.shape[0]
    h0 = x.new_zeros((1, x.shape[0], hidden))
    weights = [wx.t().contiguous(), wh.t().contiguous(), b,
               _forget_bias(hidden, b)]
    out, _, _ = torch._VF.lstm(x, (h0, h0), weights, True, 1, 0.0,
                               torch.is_grad_enabled(), False, True)
    return out


class LSTM(Layer):
    """One LSTM layer over ``[B, T, D] -> [B, T, H]``: ``wx [D, 4H]``,
    ``wh [H, 4H]``, ``b [4H]`` (the reference's leaves and inits), run
    by :func:`lstm_fused` on every device."""

    def __init__(self, hidden: int, w_init=init_lib.glorot_uniform,
                 r_init=init_lib.orthogonal()):
        super().__init__()
        self.hidden = hidden
        self.w_init = w_init
        self.r_init = r_init

    def init(self, gen, in_shape):
        t, d = in_shape
        h4 = 4 * self.hidden
        return ({"wx": self.w_init(gen, (d, h4)),
                 "wh": self.r_init(gen, (self.hidden, h4)),
                 "b": init_lib.zeros(gen, (h4,))}, (t, self.hidden))

    def forward(self, params, x):
        wx, wh, b = (params[k].to(x.dtype) for k in ("wx", "wh", "b"))
        return lstm_fused(x, wx, wh, b)


class Sequential(StatefulLayer):
    """Composes layers: params and state under the reference's keys
    ``f"{i:02d}_{layer.name}"`` (layers with none have no key), shapes
    inferred once; the dropout generator goes to every layer."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def keys(self):
        return [f"{i:02d}_{layer.name}" for i, layer in
                enumerate(self.layers)]

    def init_stateful(self, gen, in_shape):
        params, state, shape = {}, {}, tuple(in_shape)
        for key, layer in zip(self.keys(), self.layers):
            p, s, shape = layer.init_stateful(gen, shape)
            if p:
                params[key] = p
            if s:
                state[key] = s
        return params, state, shape

    def apply_stateful(self, params, state, x, train: bool = False,
                       gen=None):
        new_state = dict(state)
        for key, layer in zip(self.keys(), self.layers):
            x, s = layer.apply_stateful(params.get(key, {}),
                                        state.get(key, {}), x, train, gen)
            if s:
                new_state[key] = s
        return x, new_state
