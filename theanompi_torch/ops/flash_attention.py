"""Flash attention: forward (kernel 1), backward (kernels 2 and 3), plain
versions, and the autograd function that joins them.

Counterpart of ``theanompi_tpu/ops/pallas_attention.py`` over the stack's
``[B, T, H, D]`` layout.  :func:`flash_attention` returns ``(out, lse)``:
``out`` in the input dtype, ``lse`` fp32 ``[B, H, T]`` (the logsumexp per
query row).  :func:`flash_attention_bwd` takes the forward's ``(q, k, v,
out, lse)`` and ``d_out`` and returns ``(dq, dk, dv)``.  On the card they
launch ``kernels/csrc/flash_fwd.cu`` and ``kernels/csrc/flash_bwd.cu``; a
CPU tensor runs :func:`flash_attention_ref` / :func:`flash_attention_bwd_ref`.
:class:`FlashAttention` is the ``torch.autograd.Function`` (the reference's
``jax.custom_vjp`` around ``_flash``): kernel 1 forward, kernels 2 and 3
backward, ``lse`` not differentiable.

In bf16, kernels 1-3 run on the tensor cores with TMA loads: their
operands, and the backward's lse, must be 16-byte aligned.  In fp32,
kernels 1-3 run on the tensor cores too (three TF32 passes a product,
fp32-accurate) and load 16 bytes at a time: the forward's q, k and v and
the backward's q, k, v, d_out and lse must be 16-byte aligned in fp32 as
well.
"""

from __future__ import annotations

import torch

from theanompi_torch.kernels import Kernel, check_cuda, register, stream_ptr

FLASH_FWD = register(Kernel(
    "flash_fwd", "flash_fwd.cu",
    "theanompi_tpu/ops/pallas_attention.py:122 (_fwd_kernel)"))
FLASH_BWD_DQ = register(Kernel(
    "flash_bwd_dq", "flash_bwd.cu",
    "theanompi_tpu/ops/pallas_attention.py:228 (_bwd_dq_kernel)"))
FLASH_BWD_DKV = register(Kernel(
    "flash_bwd_dkv", "flash_bwd.cu",
    "theanompi_tpu/ops/pallas_attention.py:261 (_bwd_dkv_kernel)"))

_NEG_INF = -1e30
#: keys per tile of the kernel's online softmax, which the plain version
#: repeats (in bf16 the probabilities round against the running max of
#: each tile, so the tile size is part of the numerics)
BLOCK_K = 64


def flash_attention_supported(t: int, head_dim: int) -> bool:
    """Kernel 1's gate: ``T % 16 == 0`` (every prefill bucket) and head
    dim 32/64/128.  The reference's Mosaic gate (T a multiple of 128) does
    not apply on the card."""
    return t > 0 and t % 16 == 0 and head_dim in (32, 64, 128)


def flash_attention_ref(q, k, v, causal: bool = False):
    """The plain version of kernel 1: the same online softmax over
    ``BLOCK_K``-key tiles, for all queries at once.  The scale multiplies
    q in the input dtype; scores, running max and normalizer are fp32;
    probabilities round to the input dtype before the P.V product and the
    normalizer; masked scores are ``-1e30`` with their probabilities 0.
    -> (out ``[B, T, H, D]`` in the input dtype, lse ``[B, H, T]`` fp32).
    """
    b, t, h, d = q.shape
    dt = q.dtype
    scale = torch.tensor(d ** -0.5, dtype=dt)
    qs = (q * scale.to(q.device)).float().permute(0, 2, 1, 3)  # [B,H,T,D]
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    m = torch.full((b, h, t), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(t, device=q.device)
    for k0 in range(0, t, BLOCK_K):
        k1 = min(k0 + BLOCK_K, t)
        s = qs @ kf[:, :, k0:k1].transpose(-1, -2)          # [B,H,T,bk]
        mask = None
        if causal:
            mask = q_pos[:, None] >= torch.arange(k0, k1, device=q.device)
            s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if mask is not None:
            p = torch.where(mask, p, torch.zeros_like(p))
        p = p.to(dt).float()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vf[:, :, k0:k1]
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).to(dt).permute(0, 2, 1, 3).contiguous()
    return out, m + torch.log(l_safe)


def _check_aligned(name, *tensors):
    """The bf16 kernels read and write through TMA, and the fp32 kernels
    with 16-byte copies: both want 16-byte aligned base addresses."""
    for x in tensors:
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: data_ptr() of a tensor of shape "
                             f"{tuple(x.shape)} is not 16-byte aligned")


def _check_gate(name, q, *others):
    """Kernels 1-3 share one gate: ``T % 16 == 0``, head dim 32/64/128,
    fp32 or bf16, every ``[B, T, H, D]`` operand of q's shape and dtype."""
    b, t, h, d = q.shape
    if not flash_attention_supported(t, d):
        raise ValueError(f"{name}: unsupported T={t} D={d}; gate with "
                         f"flash_attention_supported()")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {q.dtype} not in (float32, "
                         f"bfloat16)")
    for x in others:
        if x.shape != q.shape:
            raise ValueError(f"{name}: operand shapes differ "
                             f"({tuple(x.shape)} vs {tuple(q.shape)})")
        if x.dtype != q.dtype:
            raise ValueError(f"{name}: operand dtypes differ ({x.dtype} vs "
                             f"{q.dtype})")


def flash_attention(q, k, v, causal: bool = False):
    """Flash attention forward over ``[B, T, H, D]``; -> (out, lse).  A
    CPU tensor runs the plain version; a CUDA tensor launches kernel 1 or
    raises (q, k and v must be 16-byte aligned: TMA in bf16, 16-byte
    copies in fp32)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    b, t, h, d = q.shape
    _check_gate("flash_attention", q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_cuda("flash_attention", q, k, v)
    bf16 = q.dtype == torch.bfloat16
    _check_aligned("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    FLASH_FWD.call(
        "flash_fwd", "ipppppiiiiifp", int(bf16), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, t, h,
        d, int(causal), float(d ** -0.5), stream_ptr(q))
    FLASH_FWD.launches += 1
    return out, lse


def _delta(out, d_out):
    """``rowsum(dO * O)`` in fp32, ``[B, H, T]`` — outside the kernels, as
    in the reference's ``_bwd_call``."""
    return (d_out.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd_ref(q, k, v, out, lse, d_out, causal: bool = False):
    """The plain version of kernels 2 and 3: the same recomputation over
    ``BLOCK_K``-key tiles, for all queries at once.  The scale multiplies
    q in the input dtype; scores, probabilities and ``dp`` are fp32; ``ds``
    rounds to the input dtype before both products it feeds; ``p`` rounds
    to ``d_out``'s dtype before ``pᵀ·dO``; ``dq`` sums the key tiles in
    order in fp32 and takes the scale once at the end.
    -> (dq, dk, dv), ``[B, T, H, D]`` in the input dtype."""
    b, t, h, d = q.shape
    dt = q.dtype
    dev = q.device
    scale = d ** -0.5
    qs = (q * torch.tensor(scale, dtype=dt, device=dev)).float()
    qs, kf, vf, dof = (x.float().permute(0, 2, 1, 3)
                       for x in (qs, k, v, d_out))          # [B,H,T,D]
    delta = _delta(out, d_out)
    dq = torch.zeros((b, h, t, d), dtype=torch.float32, device=dev)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    q_pos = torch.arange(t, device=dev)
    for k0 in range(0, t, BLOCK_K):
        k1 = min(k0 + BLOCK_K, t)
        kt, vt = kf[:, :, k0:k1], vf[:, :, k0:k1]
        p = torch.exp(qs @ kt.transpose(-1, -2) - lse[..., None])
        if causal:
            mask = q_pos[:, None] >= torch.arange(k0, k1, device=dev)
            p = torch.where(mask, p, torch.zeros_like(p))
        dp = dof @ vt.transpose(-1, -2)
        ds = (p * (dp - delta[..., None])).to(dt).float()
        dq += ds @ kt
        dk[:, :, k0:k1] = ds.transpose(-1, -2) @ qs
        dv[:, :, k0:k1] = p.to(d_out.dtype).float().transpose(-1, -2) @ dof

    def back(x):
        return x.to(dt).permute(0, 2, 1, 3).contiguous()

    return back(dq * scale), back(dk), back(dv)


def flash_attention_bwd(q, k, v, out, lse, d_out, causal: bool = False):
    """Flash attention backward over ``[B, T, H, D]`` from the forward's
    ``out`` and ``lse`` (``[B, H, T]`` fp32); -> (dq, dk, dv).  A CPU
    tensor runs the plain version; a CUDA tensor launches kernels 2 and 3
    or raises (kernel 1's gate)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, d_out, causal)
    b, t, h, d = q.shape
    _check_gate("flash_attention_bwd", q, k, v, out, d_out)
    if lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} is not [B, H, T] float32")
    q, k, v, d_out, lse = (x.contiguous() for x in (q, k, v, d_out, lse))
    delta = _delta(out, d_out)
    check_cuda("flash_attention_bwd", q, k, v, d_out, lse, delta)
    dtype = 0 if q.dtype == torch.float32 else 1
    # bf16: TMA; fp32: kernels 2 and 3's 16-byte cp.async copies (kernel
    # 3's of lse too)
    _check_aligned("flash_attention_bwd", q, k, v, d_out, lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    FLASH_BWD_DQ.call(
        "flash_bwd_dq", "ipppppppiiiiifp", dtype, *ptrs, dq.data_ptr(),
        b, t, h, d, int(causal), float(d ** -0.5), stream_ptr(q))
    FLASH_BWD_DQ.launches += 1
    FLASH_BWD_DKV.call(
        "flash_bwd_dkv", "ippppppppiiiiifp", dtype, *ptrs, dk.data_ptr(),
        dv.data_ptr(), b, t, h, d, int(causal), float(d ** -0.5),
        stream_ptr(q))
    FLASH_BWD_DKV.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``(out, lse) = FlashAttention.apply(q, k, v, causal)``: kernel 1
    forward, saving ``(q, k, v, out, lse)``; kernels 2 and 3 backward.
    ``lse`` is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, _d_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         d_out.to(out.dtype), ctx.causal)
        return dq, dk, dv, None
