"""Paged KV cache: fixed-size blocks, per-slot block tables, a block pool.

Counterpart of ``theanompi_tpu/serving/kv_cache.py``.  One pool per model,
``[L, num_blocks, block_size, H, Dh]`` for K and V: a block id names the
same slot in every layer, so one block table per sequence serves the whole
stack.  Block 0 is the reserved null block: inactive slots and prefill
padding point their table entries at it, so the fixed-shape decode step
writes and reads unconditionally and the garbage lands where nothing
unmasked ever reads.

Unlike the reference (immutable arrays, a new cache per write), the writes
here go into the pools **in place**: ``write_prefill``/``write_decode``
mutate ``k``/``v`` and return nothing.  ``write_prefill`` scatters
duplicate null-block indices for the padding blocks of a prompt; which of
the duplicates lands is unspecified on CUDA, which is harmless only
because the null block is never read unmasked — keep that contract.

Decode attention has two implementations (``decode_impl``): ``"kernel"``
(kernel 4 through :func:`theanompi_torch.ops.paged_attention.
paged_attend_decode`) and ``"fallback"`` (its plain version, the
reference's blockwise recurrence).
"""

from __future__ import annotations

import torch

from theanompi_torch.ops.paged_attention import (
    paged_attend_decode,
    paged_attend_decode_ref,
)
from theanompi_torch.parallel.mesh import resolve_device

_NEG_INF = -1e30
DECODE_IMPLS = ("fallback", "kernel")


class PagedKVCache:
    """The device half of the cache: K/V pools and the slots' block
    tables.  Host bookkeeping (free blocks, slot -> request) lives in
    :class:`BlockPool` and the scheduler."""

    NULL_BLOCK = 0

    def __init__(self, k, v, block_tables, block_size: int,
                 decode_impl: str = "fallback"):
        if decode_impl not in DECODE_IMPLS:
            raise ValueError(f"unknown decode_impl {decode_impl!r}")
        self.k = k                        # [L, num_blocks, bs, H, Dh]
        self.v = v
        self.block_tables = block_tables  # [max_batch, max_blocks] int32
        self.block_size = int(block_size)
        self.decode_impl = decode_impl

    @property
    def n_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def max_context(self) -> int:
        return self.block_tables.shape[1] * self.block_size

    @classmethod
    def create(cls, n_layers: int, num_blocks: int, block_size: int,
               heads: int, head_dim: int, max_batch: int, max_context: int,
               dtype=torch.float32, device=None,
               decode_impl: str = "fallback") -> "PagedKVCache":
        """Zeroed pools and null tables on ``device`` (``None``: the card,
        raising without one)."""
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved null block)")
        device = resolve_device(device)
        max_blocks_per_seq = -(-max_context // block_size)
        shape = (n_layers, num_blocks, block_size, heads, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((max_batch, max_blocks_per_seq),
                               dtype=torch.int32, device=device),
                   block_size, decode_impl=decode_impl)

    # -- writes (in place) -------------------------------------------------
    def write_prefill(self, layer: int, k, v, table_row) -> None:
        """Write a whole prompt's K/V for one layer in place: ``k``/``v``
        ``[1, P_pad, H, Dh]`` with ``P_pad`` a multiple of ``block_size``,
        ``table_row`` ``[P_pad // block_size]`` block ids (padding entries
        name the null block)."""
        bs = self.block_size
        n = k.shape[1] // bs
        idx = table_row.to(device=self.k.device, dtype=torch.long)
        self.k[layer, idx] = k[0].reshape(n, bs, *k.shape[2:]).to(self.k.dtype)
        self.v[layer, idx] = v[0].reshape(n, bs, *v.shape[2:]).to(self.v.dtype)

    def write_decode(self, layer: int, k, v, positions) -> None:
        """Append one token's K/V per slot in place: ``k``/``v`` ``[B, H,
        Dh]`` at ``positions`` ``[B]`` (inactive slots write into the null
        block)."""
        pos = positions.long()
        blk = torch.gather(self.block_tables, 1,
                           (pos // self.block_size)[:, None])[:, 0].long()
        off = pos % self.block_size
        self.k[layer, blk, off] = k.to(self.k.dtype)
        self.v[layer, blk, off] = v.to(self.v.dtype)

    # -- paged attention (suffix prefill) ------------------------------------
    def attend_prefill(self, layer: int, q, table_row, prefix_len: int):
        """Masked attention of a suffix of queries over one sequence's
        full cached context: ``q`` ``[1, S_pad, H, Dh]`` starting at
        absolute position ``prefix_len``, ``table_row``
        ``[max_blocks_per_seq]`` -> ``[1, S_pad, H, Dh]``.  fp32 softmax,
        ``-1e30`` mask admitting positions ``<= prefix_len + s``."""
        scale = q.shape[-1] ** -0.5
        row = table_row.to(device=self.k.device, dtype=torch.long)
        kb = self.k[layer][row]
        vb = self.v[layer][row]
        t_max = kb.shape[0] * self.block_size
        kb = kb.reshape(t_max, *kb.shape[2:]).float()
        vb = vb.reshape(t_max, *vb.shape[2:]).float()
        qf = q[0].float() * scale                           # [S, H, Dh]
        s = torch.einsum("shd,thd->sht", qf, kb)
        pos_q = prefix_len + torch.arange(q.shape[1], device=q.device)
        valid = torch.arange(t_max, device=q.device)[None, :] <= pos_q[:, None]
        s = torch.where(valid[:, None, :], s, torch.full_like(s, _NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        p = p / p.sum(dim=-1, keepdim=True)
        ctx = torch.einsum("sht,thd->shd", p, vb)
        return ctx[None].to(q.dtype)

    # -- paged attention (decode) --------------------------------------------
    def attend_decode(self, layer: int, q, positions):
        """One query per slot over its cached context: ``q`` ``[B, H,
        Dh]``, ``positions`` ``[B]`` int32 (the query's own position,
        already written) -> ``[B, H, Dh]``.  Inactive slots (position 0,
        null table) attend over one garbage token: finite, never NaN."""
        fn = (paged_attend_decode if self.decode_impl == "kernel"
              else paged_attend_decode_ref)
        return fn(self.k[layer], self.v[layer], self.block_tables,
                  self.block_size, q, positions)


class BlockPool:
    """Host-side refcounted allocator over the pool's block ids.

    Block 0 (the null block) is never handed out.  ``alloc`` is
    all-or-nothing.  An ``alloc``'d block starts at refcount 1; ``acquire``
    bumps blocks a holder already owns (the prefix cache sharing them);
    ``free`` decrements and returns a block to the free list at zero.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() -> low ids
        self._free_set = set(self._free)
        self._refs: dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def ref(self, block: int) -> int:
        """Current holder count of ``block`` (0 = on the free list)."""
        return self._refs.get(block, 0)

    def alloc(self, n: int) -> list[int] | None:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._free_set.discard(b)
            self._refs[b] = 1
        return out

    def acquire(self, blocks) -> None:
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"acquiring block {b} outside pool "
                                 f"(1..{self.num_blocks - 1})")
            if self._refs.get(b, 0) < 1:
                raise ValueError(f"acquiring free block {b} (acquire only "
                                 f"bumps blocks a holder already owns)")
            self._refs[b] += 1

    def free(self, blocks) -> None:
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"freeing block {b} outside pool "
                                 f"(1..{self.num_blocks - 1})")
            if b in self._free_set or b not in self._refs:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)
                self._free_set.add(b)


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks a sequence of ``n_tokens`` occupies (ceil division)."""
    return -(-n_tokens // block_size)
