"""Multi-head attention, learned positions, and the blockwise attention path.

Counterpart of ``theanompi_tpu/ops/attention.py`` (``MultiHeadAttention``
with its ``project_qkv``/``attend``/``project_out`` seams,
``PositionEmbedding``, ``resolve_attn_impl``) plus the single-device
``blockwise_attention`` of ``theanompi_tpu/parallel/ring_attention.py:63``,
the plain prefill path that ``attn_impl="blockwise"`` selects.  Ring
attention (sequence parallelism) comes with a later slice.

Under tensor parallelism (a bound layout with a model group, see
:mod:`theanompi_torch.parallel.tensor`) q, k and v are column-parallel and
o row-parallel: a rank holds ``heads / n_model`` heads, ``f`` is applied
once for the three projections (the reference's :166), and ``attend``
hands kernels 1-3 ``[B, T, heads / n_model, Dh]``.  Int8 serving weights
stay unsharded: the reference serves without tensor parallelism.
"""

from __future__ import annotations

import torch
from torch import nn

from theanompi_torch.ops import initializers as init_lib
from theanompi_torch.ops import quant
from theanompi_torch.ops.flash_attention import FlashAttention
from theanompi_torch.ops.layers import Layer
from theanompi_torch.parallel.tensor import (
    ColumnParallelDense,
    RowParallelDense,
    identity_fwd_psum_bwd,
)

_NEG_INF = -1e30

#: attention implementations, the reference's names: "pallas" selects the
#: port's hand-written flash kernel (kernel 1), "blockwise" the plain path
ATTN_IMPLS = ("auto", "pallas", "blockwise")


def resolve_attn_impl(impl: str, device) -> str:
    """The concrete path ``attend`` takes on ``device``: ``'pallas'``
    (kernel 1, through its wrapper) or ``'blockwise'``.  On the card
    ``'auto'`` is the kernel whatever the shape: the wrapper's own gate
    raises on a shape the kernel does not take.  Off the card ``'auto'``
    is the blockwise path, as the reference's is off the TPU."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {impl!r} not in {ATTN_IMPLS}")
    if impl == "auto":
        return ("pallas" if torch.device(device).type == "cuda"
                else "blockwise")
    return impl


def blockwise_attention(q, k, v, causal: bool = False):
    """Single-device attention over ``[B, T, H, D]`` in fp32 with one
    ``-1e30``-masked softmax (the ring's n = 1 case in the reference).
    Returns ``q.dtype``."""
    b, t, h, d = q.shape
    scale = d ** -0.5
    qf = q.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float()) * scale
    mask = None
    if causal:
        pos = torch.arange(t, device=q.device)
        mask = pos[:, None] >= torch.arange(k.shape[1], device=q.device)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / l.permute(0, 2, 1)[..., None]
    return out.to(q.dtype)


class MultiHeadAttention(Layer):
    """Causal/bidirectional MHA over ``[B, T, D]``; params ``q/k/v/o``, each
    a ``Dense`` ``{w [D, D], b [D]}`` (a rank's shards under tensor
    parallelism: ``[D, D / n_model]`` for q, k, v and ``[D / n_model, D]``
    for o)."""

    def __init__(self, dim: int, heads: int, causal: bool = True,
                 impl: str = "auto"):
        super().__init__()
        if impl not in ATTN_IMPLS:
            raise ValueError(f"MultiHeadAttention impl {impl!r} not in "
                             f"{ATTN_IMPLS}")
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by {heads} heads")
        self.dim = dim
        self.heads = heads
        self.causal = causal
        self.impl = impl
        w02 = init_lib.normal(0.02)
        self.proj = nn.ModuleDict({
            **{n: ColumnParallelDense(dim, input_synced=True, w_init=w02)
               for n in ("q", "k", "v")},
            "o": RowParallelDense(dim, w_init=w02)})

    def init(self, gen, in_shape):
        if in_shape[-1] != self.dim:
            raise ValueError(f"MHA dim {self.dim} != input {in_shape[-1]}")
        params = {n: self.proj[n].init(gen, in_shape)[0]
                  for n in ("q", "k", "v", "o")}
        return params, tuple(in_shape)

    def project_qkv(self, params, x):
        """``[B, T, D] -> 3 x [B, T, h, Dh]``, ``h`` the heads the weights
        hold (all of them, or a rank's ``heads / n_model``): one matmul
        against the concatenated weights; int8 weights (which cannot
        concatenate) take three int8 matmuls and a concat."""
        b, t, _ = x.shape
        head_dim = self.dim // self.heads
        ws = [params[n]["w"] for n in ("q", "k", "v")]
        if any(isinstance(w, quant.QuantizedTensor) for w in ws):
            qkv = torch.cat([quant.matmul_any(x, w) for w in ws], dim=-1)
        else:
            qkv = x @ torch.cat(ws, dim=1).to(x.dtype)
        if "b" in params["q"]:
            qkv = qkv + torch.cat([params[n]["b"] for n in ("q", "k", "v")]
                                  ).to(x.dtype)
        q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
        shape = (b, t, q.shape[-1] // head_dim, head_dim)
        return q.reshape(shape), k.reshape(shape), v.reshape(shape)

    def attend(self, q, k, v):
        """The attention core over ``[B, T, H, Dh]``: :class:`FlashAttention`
        (kernel 1 forward, kernels 2 and 3 backward, through their
        wrappers) or the blockwise path, which autograd differentiates, as
        :func:`resolve_attn_impl` decides.  Serving and training share it."""
        if resolve_attn_impl(self.impl, q.device) == "pallas":
            return FlashAttention.apply(q, k, v, self.causal)[0]
        return blockwise_attention(q, k, v, causal=self.causal)

    def project_out(self, params, out):
        """Output projection over the flattened heads ``[B, T, H*Dh]``."""
        return self.proj["o"](params["o"], out)

    def forward(self, params, x):
        b, t, _ = x.shape
        q, k, v = self.project_qkv(params, identity_fwd_psum_bwd(x))
        out = self.attend(q, k, v).reshape(b, t, -1)
        return self.project_out(params, out)


class PositionEmbedding(Layer):
    """Learned absolute positions ``pos [max_len, dim]``."""

    def __init__(self, max_len: int, dim: int):
        super().__init__()
        self.max_len = max_len
        self.dim = dim

    def init(self, gen, in_shape):
        t = in_shape[0]
        if t > self.max_len:
            raise ValueError(f"seq len {t} > max_len {self.max_len}")
        return ({"pos": init_lib.normal(0.02)(gen, (self.max_len, self.dim))},
                tuple(in_shape))

    def forward(self, params, x):
        t = x.shape[1]
        return x + params["pos"][:t].to(x.dtype)[None]
