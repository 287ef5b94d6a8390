"""Prefix cache: a radix tree over full-block token chunks.

A copy of ``theanompi_tpu/serving/prefix_cache.py`` (pure Python; the
port imports nothing of the reference package).

Under a multi-turn / shared-system-prompt traffic mix most prefill FLOPs
recompute K/V the paged pool already holds.  SGLang's RadixAttention
(Zheng et al., 2024) showed the fix at the right granularity for a paged
cache (vLLM, Kwon et al., SOSP 2023): index FULL cache blocks by the exact
``block_size``-token chunk they hold, chained parent->child — a path from
the root spells a prompt prefix, and the nodes along it name the block ids
whose K/V that prefix already computed.

Design points, in the order they bite:

- **Chunk keys, chained on the parent.**  Each node's children are keyed
  by the exact ``block_size``-token tuple of the child block.  The "chunk
  hash chained on the parent" is literally the dict's tuple hashing scoped
  per parent node — collision-SAFE (tuple equality decides, never the
  hash), so a match can never hand a request someone else's K/V.
- **Full blocks only.**  A partially filled block is never shared: the
  last (partial) block of any sequence stays exclusively owned
  (copy-on-write by construction — decode appends land only in blocks the
  request alloc'd itself), so a hit is always a whole number of blocks and
  the suffix prefill starts at a block boundary.
- **Refcount discipline.**  The tree holds ONE pool reference per node
  (:meth:`insert` transfers the caller's ref, or releases it when the
  chunk is already cached); :meth:`match` ``acquire``\\ s the matched
  blocks into the requesting sequence, so an eviction of one holder never
  invalidates another (:class:`theanompi_torch.serving.kv_cache.BlockPool`).
- **LRU eviction of zero-ref leaves.**  When the pool runs dry the
  scheduler asks the tree to give blocks back; only LEAF nodes whose block
  the tree is the SOLE holder of (``pool.ref == 1``) are evictable, oldest
  ``last_use`` first — a parent becomes evictable once its children are
  gone, so the tree drains deepest-first.
- **Params-version stamp.**  Cached K/V is only valid under the weights
  that computed it: a live rollout (``engine.swap_params`` /
  ``restore_params``) bumps the engine's ``params_version``, and
  the scheduler invalidates the whole tree on mismatch.  Without the stamp
  the cache silently serves stale K/V across a weight swap.

Host-side and single-threaded like the scheduler that owns it; LRU ticks
come from a monotone counter, not the wall clock, so replays are
deterministic.
"""

from __future__ import annotations


class _Node:
    """One cached full block: the chunk that fills it, the block id the
    tree's reference pins, and the LRU stamp."""

    __slots__ = ("chunk", "block", "parent", "children", "last_use")

    def __init__(self, chunk, block, parent):
        self.chunk = chunk
        self.block = block
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.last_use = 0


class PrefixCache:
    """Radix tree mapping prompt prefixes to cached KV block ids.

    Owns one :class:`BlockPool` reference per cached block; all methods
    keep the pool and the tree consistent — no caller ever frees a block
    the tree still names.
    """

    def __init__(self, pool, block_size: int):
        self.pool = pool
        self.block_size = int(block_size)
        self._root = _Node(None, None, None)
        self._clock = 0  # monotone LRU tick (deterministic, not wall time)
        self.params_version: int | None = None
        self.n_nodes = 0

    # -- invalidation ---------------------------------------------------------
    def check_version(self, version: int) -> bool:
        """Stamp check against the engine's ``params_version``; on mismatch
        the WHOLE tree invalidates (cached K/V was computed under the old
        weights — silently wrong under the new ones).  -> True when an
        invalidation happened."""
        if self.params_version == version:
            return False
        stale = self.params_version is not None and self.n_nodes > 0
        if stale:
            self.invalidate()
        self.params_version = version
        return stale

    def invalidate(self) -> int:
        """Release every tree-held block back to the pool (refcount
        decrement — blocks live requests still hold stay live for them)
        and clear the tree.  -> number of nodes dropped."""
        dropped = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.pool.free([node.block])
            dropped += 1
        self._root.children.clear()
        self.n_nodes = 0
        return dropped

    # -- lookup ---------------------------------------------------------------
    def match(self, tokens) -> list[int]:
        """Longest cached full-block prefix of ``tokens``; -> the matched
        block ids IN SEQUENCE ORDER, each ``acquire``\\ d for the caller
        (the caller now co-owns them and must ``pool.free`` them like its
        own).  Capped so at least ONE token stays uncached — prefill must
        compute the last real position's logits to sample the next token.
        """
        bs = self.block_size
        max_blocks = max(len(tokens) - 1, 0) // bs
        node, nodes = self._root, []
        while len(nodes) < max_blocks:
            i = len(nodes) * bs
            child = node.children.get(tuple(tokens[i:i + bs]))
            if child is None:
                break
            nodes.append(child)
            node = child
        if not nodes:
            return []
        blocks = [n.block for n in nodes]
        self.pool.acquire(blocks)
        self._clock += 1
        for n in nodes:
            n.last_use = self._clock
        return blocks

    # -- insertion ------------------------------------------------------------
    def insert(self, tokens, blocks) -> int:
        """Offer a finished/evicted sequence's FULL blocks back to the
        tree: ``tokens`` (length a multiple of ``block_size``) are the
        cached positions, ``blocks`` the ids backing them in order.  The
        caller's reference on each block TRANSFERS to the tree when the
        chunk is new, and is released when the chunk is already cached
        (dedup — the tree keeps its existing copy).  -> new nodes added."""
        bs = self.block_size
        if len(tokens) != len(blocks) * bs:
            raise ValueError(
                f"insert: {len(tokens)} tokens != {len(blocks)} full "
                f"blocks x block_size {bs}")
        node, added = self._root, 0
        self._clock += 1
        for i, block in enumerate(blocks):
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, block, node)
                node.children[chunk] = child
                self.n_nodes += 1
                added += 1
            else:
                # chunk already cached: release the caller's ref on its
                # copy (the tree's copy — possibly the very same block id
                # the request acquired at admission — stays pinned)
                self.pool.free([block])
            child.last_use = self._clock
            node = child
        return added

    # -- eviction -------------------------------------------------------------
    def evict(self, n: int) -> int:
        """Free up to ``n`` blocks back to the pool, LRU leaves first, and
        ONLY leaves the tree is the sole holder of (``pool.ref == 1``) — a
        block a live request shares is never invalidated under it.  A
        freed leaf may expose its parent as the next candidate.  -> blocks
        actually freed."""
        freed = 0
        while freed < n:
            victim = None
            stack = list(self._root.children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                elif self.pool.ref(node.block) == 1 and (
                        victim is None or node.last_use < victim.last_use):
                    victim = node
            if victim is None:
                break
            del victim.parent.children[victim.chunk]
            self.pool.free([victim.block])
            self.n_nodes -= 1
            freed += 1
        return freed
