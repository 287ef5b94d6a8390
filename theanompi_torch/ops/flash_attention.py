"""Flash attention forward (kernel 1) and its plain version.

Counterpart of the forward half of ``theanompi_tpu/ops/pallas_attention.py``
over the stack's ``[B, T, H, D]`` layout.  :func:`flash_attention` returns
``(out, lse)``: ``out`` in the input dtype, ``lse`` fp32 ``[B, H, T]`` (the
logsumexp per query row, which the backward slice will read).  On the card
it launches ``kernels/csrc/flash_fwd.cu``; a CPU tensor runs
:func:`flash_attention_ref`.  The backward kernels (the reference's
``_bwd_dq_kernel``/``_bwd_dkv_kernel``) come with the training slice.
"""

from __future__ import annotations

import torch

from theanompi_torch.kernels import Kernel, check_cuda, register, stream_ptr

FLASH_FWD = register(Kernel(
    "flash_fwd", "flash_fwd.cu",
    "theanompi_tpu/ops/pallas_attention.py:122 (_fwd_kernel)"))

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


def flash_attention(q, k, v, causal: bool = False):
    """Flash attention forward over ``[B, T, H, D]``; -> (out, lse).  A
    CPU tensor runs the plain version; a CUDA tensor launches kernel 1 or
    raises."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    b, t, h, d = q.shape
    if not flash_attention_supported(t, d):
        raise ValueError(f"flash_attention: unsupported T={t} D={d}; gate "
                         f"with flash_attention_supported()")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         f"(float32, bfloat16)")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention: q, k, v shapes differ")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v dtypes differ")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_cuda("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    FLASH_FWD.call(
        "flash_fwd", "ipppppiiiiifp",
        0 if q.dtype == torch.float32 else 1, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, t, h, d,
        int(causal), float(d ** -0.5), stream_ptr(q))
    FLASH_FWD.launches += 1
    return out, lse
