"""Paged decode attention (kernel 4) and its plain version.

Counterpart of ``theanompi_tpu/ops/pallas_paged_attention.py``: one query
per batch slot against one layer's paged KV pool.  The block table picks
the pool blocks of each slot; an online softmax in fp32 runs over them;
positions past ``positions[b]`` are masked with ``-1e30``.  On the card
:func:`paged_attend_decode` launches ``kernels/csrc/paged_decode.cu``,
which splits each slot's context into runs of whole pool blocks, one CTA
each, and merges the runs' partial softmax states in a fixed order; a CPU
tensor runs :func:`paged_attend_decode_ref`, which is also the serving
cache's fallback (``decode_kernel="off"``).
"""

from __future__ import annotations

import torch

from theanompi_torch.kernels import Kernel, check_cuda, register, stream_ptr

PAGED_DECODE = register(Kernel(
    "paged_decode", "paged_decode.cu",
    "theanompi_tpu/ops/pallas_paged_attention.py:54 (_decode_kernel)"))

_NEG_INF = -1e30
_SPLIT_TOKENS: dict = {}


def paged_decode_supported(heads: int, head_dim: int, block_size: int,
                           dtype=torch.float32) -> bool:
    """Kernel 4's gate: head_dim 32/64/128, block_size 8/16/32, fp32 or
    bf16.  Any head count.  (The reference's Mosaic gate — heads % 16 and
    head_dim % 128 in bf16 — does not apply on the card.)"""
    return (head_dim in (32, 64, 128) and block_size in (8, 16, 32)
            and dtype in (torch.float32, torch.bfloat16) and heads >= 1)


def paged_split_tokens(dtype, head_dim: int, block_size: int) -> int:
    """Kernel 4's tokens per split of a slot's context (whole pool
    blocks), from the kernel's own geometry; the wrapper sizes the split
    partials' workspace with it."""
    key = (dtype, head_dim, block_size)
    if key not in _SPLIT_TOKENS:
        _SPLIT_TOKENS[key] = PAGED_DECODE.query(
            "paged_decode_split_tokens", "iii",
            0 if dtype == torch.float32 else 1, head_dim, block_size)
    return _SPLIT_TOKENS[key]


def paged_attend_decode_ref(k_pool, v_pool, tables, block_size: int, q,
                            positions):
    """The plain version: the reference fallback's blockwise recurrence
    (``PagedKVCache.attend_decode``, multiply + reduce in fp32).  Walks
    the table only as far as the longest slot needs — every later block is
    fully masked for every slot, an exact no-op of the recurrence
    (correction ``exp(0) == 1``, probabilities underflow to 0).

    ``k_pool``/``v_pool`` ``[num_blocks, bs, H, Dh]``, ``tables`` ``[B,
    nb]`` int32, ``q`` ``[B, H, Dh]``, ``positions`` ``[B]`` -> ``[B, H,
    Dh]`` in ``q.dtype``."""
    b, h, d = q.shape
    bs = block_size
    positions = positions.to(torch.long)
    nb_used = min(int(positions.max().item()) // bs + 1, tables.shape[1])
    qf = q.float() * (d ** -0.5)
    m = torch.full((b, 1, h), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, 1, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    ar = torch.arange(bs, device=q.device)
    for j in range(nb_used):
        blk = tables[:, j].to(torch.long)
        k_j = k_pool[blk].float()                       # [B, bs, H, Dh]
        v_j = v_pool[blk].float()
        s = (k_j * qf[:, None, :, :]).sum(dim=-1)      # [B, bs, H]
        valid = (j * bs + ar)[None, :, None] <= positions[:, None, None]
        s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        corr = torch.exp(m - m_new)                     # [B, 1, H]
        p = torch.exp(s - m_new)                        # [B, bs, H]
        l = l * corr + p.sum(dim=1, keepdim=True)
        ctx = (p[..., None] * v_j).sum(dim=1)           # [B, H, Dh]
        acc = acc * corr.transpose(1, 2) + ctx
        m = m_new
    return (acc / l.transpose(1, 2)).to(q.dtype)


def paged_attend_decode(k_pool, v_pool, tables, block_size: int, q,
                        positions):
    """Paged decode attention over one layer's pools (shapes as
    :func:`paged_attend_decode_ref`).  A CPU tensor runs the plain
    version; a CUDA tensor launches kernel 4 or raises."""
    if q.device.type == "cpu":
        return paged_attend_decode_ref(k_pool, v_pool, tables, block_size,
                                       q, positions)
    b, h, d = q.shape
    if not paged_decode_supported(h, d, block_size, q.dtype):
        raise ValueError(
            f"paged_attend_decode: unsupported H={h} Dh={d} "
            f"block_size={block_size} {q.dtype}; gate with "
            f"paged_decode_supported()")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_attend_decode: pool dtype {k_pool.dtype} "
                         f"!= query dtype {q.dtype}")
    if k_pool.shape[1:] != (block_size, h, d) or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attend_decode: pool shape "
                         f"{tuple(k_pool.shape)} does not match "
                         f"[blocks, {block_size}, {h}, {d}]")
    if tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("paged_attend_decode: tables and positions must "
                         "be int32")
    if tables.shape[0] != b or positions.shape != (b,):
        raise ValueError("paged_attend_decode: tables/positions batch "
                         "does not match q")
    # the model hands over q[:, 0] of the split qkv projection, a strided
    # view; the kernel reads q, K and V rows with 16-byte loads
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    check_cuda("paged_attend_decode", k_pool, v_pool, tables, positions, q)
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attend_decode: pools must be 16-byte "
                         "aligned")
    nb = tables.shape[1]
    # the grid, and so the workspace, from the table's width alone: the
    # host reads no positions, and the call can be captured in a graph
    splits = -(-nb * block_size // paged_split_tokens(q.dtype, d,
                                                      block_size))
    ws = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                     device=q.device)
    out = torch.empty_like(q)
    PAGED_DECODE.call(
        "paged_decode", "ipppppppiiiiifp",
        0 if q.dtype == torch.float32 else 1, k_pool.data_ptr(),
        v_pool.data_ptr(), tables.data_ptr(), positions.data_ptr(),
        q.data_ptr(), out.data_ptr(), ws.data_ptr(), b, h, d, block_size,
        nb, float(d ** -0.5), stream_ptr(q))
    # one count per call: the split kernel and the merge of its partials
    PAGED_DECODE.launches += 1
    return out
