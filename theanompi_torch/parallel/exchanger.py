"""The gradient exchanger: mean-reduce a tree over the process group.

Counterpart of ``theanompi_tpu/parallel/exchanger.py``.  The reference's
strategies are pure functions traced inside ``shard_map`` over the
``data`` mesh axis; here each rank is a process, and a strategy issues
explicit collectives over the default process group (NCCL on cards, gloo
on CPU ranks):

- leaf-wise, one collective per floating leaf (:151-235): ``none`` (no
  exchange; replicas diverge), ``psum`` (``all_reduce`` sum, then / n),
  ``psum_bf16`` (bf16 on the wire, bf16 sums, as XLA reduces in the wire
  dtype; the mean in fp32), and ``ring``/``ring_bf16``, the explicit
  reduce-scatter then all-gather ring of ``_ring_allreduce`` :183 through
  ``batch_isend_irecv``, with the reference's chunk indices and order of
  adds, so fp32 results can be bit-equal to its;
- bucketed (:82-89, :556-573): the floating leaves packed into few flat
  buffers (:func:`_bucket_layout`, greedy, grouped by dtype, ``bucket_bytes``
  each), one collective a bucket: ``psum_bucket``, ``psum_bf16_bucket``,
  ``ring_bucket``, ``ring_bf16_bucket`` and ``ring_int8`` (:249-300), the
  ring with an int8 payload and one fp32 scale a hop, stochastically
  rounded from a per-rank, per-step, per-bucket stream; the owner's
  quantized chunk circulates verbatim in the all-gather, so every rank
  dequantizes the same bytes.

Trees are flattened in sorted-key order, the order ``jax.tree`` flattens
dicts in, so bucket layouts, ring chunks and sums match the reference's.
Non-float leaves pass through; at a world of 1 every strategy is the
identity (:521).  ``zero1`` (the sharded optimizer update) and
``overlap`` (collectives chained into backward) are ROADMAP queue 1 item
10 and raise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from theanompi_torch import dist as tdist
from theanompi_torch.models.data.base import derive_seed
from theanompi_torch.ops.quant import quantize_chunk

#: leaf-wise strategies: one collective per floating leaf
LEAFWISE_STRATEGIES = ("none", "psum", "psum_bf16", "ring", "ring_bf16")
#: bucketed strategies: fused flat buckets instead of one collective a leaf
BUCKETED_STRATEGIES = ("psum_bucket", "psum_bf16_bucket", "ring_bucket",
                       "ring_bf16_bucket", "ring_int8")
#: the reference's strategies that are not ported yet
NOT_PORTED_STRATEGIES = ("zero1",)

#: strategies that put float leaves on the wire in bf16 (2 bytes/elem)
_BF16_WIRE = ("psum_bf16", "ring_bf16", "psum_bf16_bucket",
              "ring_bf16_bucket")
#: strategies that put float leaves on the wire in int8 (1 byte/elem; the
#: per-chunk fp32 scales are left out of the accounting)
_INT8_WIRE = ("ring_int8",)

DEFAULT_BUCKET_BYTES = 4 * 2**20


def _inexact(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


def wire_itemsize(strategy: str, dtype: torch.dtype) -> int:
    """Bytes per element a leaf of ``dtype`` takes on the wire: the bf16
    strategies compress floating leaves to 2 bytes and ``ring_int8`` to 1,
    the others ship the leaf's dtype, ``none`` ships nothing."""
    if strategy == "none":
        return 0
    itemsize = dtype.itemsize
    if dtype.is_floating_point:
        if strategy in _BF16_WIRE:
            return min(itemsize, 2)
        if strategy in _INT8_WIRE:
            return min(itemsize, 1)
    return itemsize


def collective_wire_bytes(buffer_bytes: int, axis_size: int) -> int:
    """Bytes through each rank for one ring all-reduce of
    ``buffer_bytes``: ``2 (n - 1) / n`` of the buffer; none at n = 1."""
    if axis_size <= 1:
        return 0
    return int(2 * (axis_size - 1) * buffer_bytes // axis_size)


# -- trees in the reference's leaf order --------------------------------------

def flatten(tree) -> list:
    """The leaves of a nested dict in sorted-key order (``jax.tree``'s)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    return [tree]


def unflatten(tree, leaves: list):
    """A tree shaped like ``tree`` (keys in its order) holding ``leaves``,
    given in :func:`flatten`'s order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            sub = {k: build(t[k]) for k in sorted(t)}
            return {k: sub[k] for k in t}
        return next(it)

    return build(tree)


# -- point to point -----------------------------------------------------------

def _shift(send: torch.Tensor, n: int) -> torch.Tensor:
    """Send ``send`` to the next rank of the ring and -> what the previous
    rank sent (the reference's ``ppermute`` over ``i -> i + 1``)."""
    r = dist.get_rank()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, (r + 1) % n),
            dist.P2POp(dist.irecv, recv, (r - 1) % n)]):
        req.wait()
    return recv


def _ring_allreduce(x: torch.Tensor, n: int, wire_dtype=None):
    """Ring all-reduce (sum): reduce-scatter then all-gather, ``2 (n - 1)``
    hops of ``1 / n`` of the buffer each.  After reduce-scatter step
    ``s``, rank ``i`` holds the partial sum of chunk ``(i - s - 1) mod n``;
    after ``n - 1`` steps it owns chunk ``(i + 1) mod n`` complete."""
    if n == 1:
        return x
    shape, dtype, numel = x.shape, x.dtype, x.numel()
    flat = x.reshape(-1)
    pad = (-numel) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(n, -1)
    if wire_dtype is not None and dtype.is_floating_point:
        chunks = chunks.to(wire_dtype)
    else:
        chunks = chunks.clone()  # never write into the caller's tensor
    idx = dist.get_rank()
    for s in range(n - 1):
        recv = _shift(chunks[(idx - s) % n], n)
        tgt = (idx - s - 1) % n
        chunks[tgt] = chunks[tgt] + recv
    for s in range(n - 1):
        chunks[(idx - s) % n] = _shift(chunks[(idx + 1 - s) % n], n)
    out = chunks.float() if wire_dtype is not None else chunks
    return out.reshape(-1)[:numel].reshape(shape).to(dtype)


def _ring_allreduce_int8(x: torch.Tensor, n: int, seed: int):
    """Ring all-reduce with an int8 payload and one fp32 scale a hop, fp32
    sums; -> fp32.  Hop ``s`` of the reduce-scatter quantizes its partial
    sum from the stream ``derive_seed(seed, s)``; each completed chunk is
    quantized once by its owner (stream ``n - 1``) and circulates
    verbatim, so every rank dequantizes the same bytes."""
    if n == 1:
        return x.float()
    numel = x.numel()
    flat = x.reshape(-1).float()
    pad = (-numel) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(n, -1).clone()
    idx = dist.get_rank()

    def gen(s):
        g = torch.Generator(device=x.device)
        g.manual_seed(derive_seed(seed, s))
        return g

    for s in range(n - 1):
        q, scale = quantize_chunk(chunks[(idx - s) % n], gen(s))
        recv = _shift(q, n).float() * _shift(scale.reshape(1), n)
        tgt = (idx - s - 1) % n
        chunks[tgt] = chunks[tgt] + recv
    own = (idx + 1) % n
    q_own, s_own = quantize_chunk(chunks[own], gen(n - 1))
    qc = torch.zeros(chunks.shape, dtype=torch.int8, device=x.device)
    sc = torch.zeros((n,), dtype=torch.float32, device=x.device)
    qc[own], sc[own] = q_own, s_own
    for s in range(n - 1):
        src, dst = (idx + 1 - s) % n, (idx - s) % n
        qc[dst] = _shift(qc[src], n)
        sc[dst] = _shift(sc[src:src + 1], n)[0]
    out = qc.float() * sc[:, None]
    return out.reshape(-1)[:numel].reshape(x.shape)


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The group's sum of ``x`` in a new tensor."""
    out = x.clone()
    dist.all_reduce(out)
    return out


def _leaf_mean(strategy: str, x: torch.Tensor, n: int) -> torch.Tensor:
    """One floating leaf's mean over the group (leaf-wise strategies)."""
    if strategy == "psum":
        return _all_reduce(x) / n
    if strategy == "psum_bf16":
        summed = _all_reduce(x.to(torch.bfloat16))
        return (summed.float() / n).to(x.dtype)
    if strategy == "ring":
        return _ring_allreduce(x, n) / n
    if strategy == "ring_bf16":
        out = _ring_allreduce(x, n, wire_dtype=torch.bfloat16)
        return (out.float() / n).to(x.dtype)
    raise AssertionError(f"not a leaf-wise reduce strategy: {strategy}")


# -- bucket layout ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Bucket:
    """One fused flat buffer: which leaves it packs and where."""

    dtype: torch.dtype
    indices: tuple[int, ...]   # flat-leaf indices packed, in order
    sizes: tuple[int, ...]     # element count per packed leaf
    shapes: tuple[tuple, ...]  # original shape per packed leaf
    elems: int                 # payload elements (sum of sizes)
    padded: int                # elems rounded up to a multiple of n


def _bucket_layout(leaves, bucket_bytes: int, n: int) -> list[_Bucket]:
    """Greedy dtype-grouped buckets over the floating tensor leaves, in
    leaf order: a leaf is never split, one larger than ``bucket_bytes``
    gets a bucket of its own; each bucket is padded to a multiple of
    ``n`` so ring chunks divide evenly."""
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf, torch.Tensor) or not _inexact(leaf.dtype):
            continue
        groups.setdefault(leaf.dtype, []).append(
            (i, tuple(leaf.shape), leaf.numel()))
    buckets: list[_Bucket] = []
    for dtype, entries in groups.items():
        cap = max(1, int(bucket_bytes) // max(1, dtype.itemsize))
        cur: list = []
        cur_elems = 0
        for entry in entries:
            if cur and cur_elems + entry[2] > cap:
                buckets.append(_make_bucket(dtype, cur, cur_elems, n))
                cur, cur_elems = [], 0
            cur.append(entry)
            cur_elems += entry[2]
        if cur:
            buckets.append(_make_bucket(dtype, cur, cur_elems, n))
    return buckets


def _make_bucket(dtype, entries, elems, n) -> _Bucket:
    return _Bucket(dtype=dtype, indices=tuple(e[0] for e in entries),
                   shapes=tuple(e[1] for e in entries),
                   sizes=tuple(e[2] for e in entries), elems=elems,
                   padded=elems + (-elems) % max(1, n))


def _pack(leaves, bucket: _Bucket) -> torch.Tensor:
    parts = [leaves[i].reshape(-1) for i in bucket.indices]
    if bucket.padded > bucket.elems:
        parts.append(parts[0].new_zeros(bucket.padded - bucket.elems))
    return torch.cat(parts)


def _unpack(buf: torch.Tensor, bucket: _Bucket) -> dict:
    """-> {flat-leaf index: reduced tensor} for the leaves ``bucket``
    packs (views of ``buf``)."""
    out, off = {}, 0
    for i, size, shape in zip(bucket.indices, bucket.sizes, bucket.shapes):
        out[i] = buf[off:off + size].reshape(shape)
        off += size
    return out


def fused_pmean(tree):
    """Mean-reduce every floating leaf over the group with one collective
    per dtype (the trainer's metrics and model state); other leaves pass
    through, and at a world of 1 the tree comes back as it is."""
    n = tdist.world()
    if n == 1:
        return tree
    leaves = flatten(tree)
    out = list(leaves)
    for bucket in _bucket_layout(leaves, bucket_bytes=2**62, n=1):
        red = _all_reduce(_pack(leaves, bucket)) / n
        for i, arr in _unpack(red, bucket).items():
            out[i] = arr
    return unflatten(tree, out)


class Exchanger:
    """Averages a gradient tree across the ranks of the process group.

    ``strategy`` is the reference's plug point (leaf-wise or bucketed, see
    the module docstring); ``bucket_bytes`` caps a fused bucket (4 MiB by
    default, the ``exch_bucket_mb`` rule key)."""

    def __init__(self, strategy: str = "psum",
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 overlap: bool = False):
        if strategy in NOT_PORTED_STRATEGIES:
            raise NotImplementedError(
                f"exch_strategy {strategy!r} (the sharded optimizer update) "
                f"not yet ported (ROADMAP queue 1 item 10)")
        known = LEAFWISE_STRATEGIES + BUCKETED_STRATEGIES
        if strategy not in known:
            raise ValueError(f"unknown exchange strategy {strategy!r}; "
                             f"available: {sorted(known)}")
        if int(bucket_bytes) < 1:
            raise ValueError(
                f"bucket_bytes must be positive, got {bucket_bytes}")
        if overlap:
            raise NotImplementedError(
                "exch_overlap (collectives chained into backward) not yet "
                "ported (ROADMAP queue 1 item 10)")
        self.strategy = strategy
        self.bucket_bytes = int(bucket_bytes)

    @property
    def bucketed(self) -> bool:
        return self.strategy in BUCKETED_STRATEGIES

    def exchange(self, tree, seed: int = 0):
        """Mean-reduce every floating leaf of ``tree`` across the group;
        -> a new tree (the input is not written).  ``seed`` keys
        ``ring_int8``'s stochastic rounding (pass one per rank and step;
        bucket ``b``'s stream is ``derive_seed(seed, b)``); the other
        strategies ignore it."""
        n = tdist.world()
        if n == 1 or self.strategy == "none":
            return tree
        leaves = flatten(tree)
        out = list(leaves)
        if not self.bucketed:
            for i, x in enumerate(leaves):
                if isinstance(x, torch.Tensor) and _inexact(x.dtype):
                    out[i] = _leaf_mean(self.strategy, x, n)
            return unflatten(tree, out)
        for bi, bucket in enumerate(_bucket_layout(leaves, self.bucket_bytes,
                                                   n)):
            red = self._reduce_bucket(_pack(leaves, bucket), n,
                                      derive_seed(seed, bi))
            for i, arr in _unpack(red, bucket).items():
                out[i] = arr
        return unflatten(tree, out)

    def _reduce_bucket(self, buf: torch.Tensor, n: int, seed: int):
        s = self.strategy
        if s == "psum_bucket":
            dist.all_reduce(buf)  # buf is the fresh packed buffer
            return buf / n
        if s == "psum_bf16_bucket":
            summed = buf.to(torch.bfloat16)
            dist.all_reduce(summed)
            return (summed.float() / n).to(buf.dtype)
        if s == "ring_bucket":
            return _ring_allreduce(buf, n) / n
        if s == "ring_bf16_bucket":
            out = _ring_allreduce(buf, n, wire_dtype=torch.bfloat16)
            return (out.float() / n).to(buf.dtype)
        if s == "ring_int8":
            return (_ring_allreduce_int8(buf, n, seed) / n).to(buf.dtype)
        raise AssertionError(f"not a bucketed reduce strategy: {s}")

    # -- static accounting ----------------------------------------------------
    def layout(self, tree, axis_size: int) -> list[_Bucket]:
        """The bucket layout of ``tree``'s leaves at ``axis_size`` ranks."""
        return _bucket_layout(flatten(tree), self.bucket_bytes,
                              max(1, axis_size))

    def wire_bytes(self, tree, axis_size: int) -> int:
        """Bytes through each rank for one exchange of ``tree``: the
        floating leaves at the strategy's wire dtype, times the ring
        factor ``2 (n - 1) / n`` taken once over each dtype's element
        count.  Bucket padding and ``ring_int8``'s scales are left out,
        so ``psum_bf16*`` is exactly 1/2 and ``ring_int8`` 1/4 of ``psum``
        on the same tree."""
        if axis_size <= 1 or self.strategy == "none":
            return 0
        per_dtype: dict = {}
        for leaf in flatten(tree):
            if isinstance(leaf, torch.Tensor) and _inexact(leaf.dtype):
                per_dtype[leaf.dtype] = (per_dtype.get(leaf.dtype, 0)
                                         + leaf.numel())
        return sum(2 * (axis_size - 1) * elems // axis_size
                   * wire_itemsize(self.strategy, dtype)
                   for dtype, elems in per_dtype.items())

    def bucket_summary(self, tree, axis_size: int) -> dict | None:
        """Bucket count and bytes of ``tree`` (None for the leaf-wise
        strategies)."""
        if not self.bucketed:
            return None
        buckets = self.layout(tree, axis_size)
        return {"n_buckets": len(buckets), "bucket_bytes": self.bucket_bytes,
                "padded_bytes": sum(b.padded * b.dtype.itemsize
                                    for b in buckets)}

    def __repr__(self):
        return f"Exchanger(strategy={self.strategy!r})"
