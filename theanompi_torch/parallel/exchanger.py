"""The gradient exchanger: mean-reduce a tree over the process group.

Counterpart of ``theanompi_tpu/parallel/exchanger.py``.  The reference's
strategies are pure functions traced inside ``shard_map`` over the
``data`` mesh axis; here each rank is a process, and a strategy issues
explicit collectives over the data axis: the default process group (NCCL
on cards, gloo on CPU ranks), or under a sharded
:class:`~theanompi_torch.parallel.mesh.Layout` this rank's data group
(the ranks that hold the same shards):

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
identity (:521).

``zero1`` (:575-663) fuses the exchange into the optimizer update
(``fuses_update``): each grad bucket is reduce-scattered
(``reduce_scatter_tensor``, then / n), the update runs on this rank's
1/n shard of the bucket's params and optimizer state
(:func:`theanompi_torch.ops.opt.sharded_update`), and the updated shards
are all-gathered (``all_gather_into_tensor``).  The rank keeps only its
``padded // n`` slice of each bucket's optimizer state, where the
reference keeps global ``(padded,)`` buffers sharded over ``data``
(:meth:`Exchanger.zero1_init_opt_state`).

Overlap (the ``exch_overlap`` rule key)
---------------------------------------

The reference schedules one XLA program: ``exch_overlap`` chains the
buckets in reverse layout order with value-preserving ``select`` fences
(``theanompi_tpu/parallel/overlap.py:61-84``), so each bucket's collective can issue while backward still
computes the next bucket's grads.  The port runs eagerly, so it does what
PyTorch DDP does, by hand: :class:`BucketExchange` puts a hook on every
param leaf that backward differentiates (``Tensor.register_hook``); when
the last leaf of a bucket has its grad, the hook packs the bucket and
issues its collective (:meth:`Exchanger.start_bucket`): an asynchronous
all-reduce, or under ``zero1`` an asynchronous reduce-scatter.  After
backward the step waits on the buckets in the order they were issued;
under ``zero1`` each bucket is updated as its scatter lands and its
all-gather is issued at once, asynchronously too.

- **One issue order on every rank.**  Collectives pair up across ranks by
  the order they are issued in (NCCL hangs, gloo pairs the wrong buffers
  otherwise), so buckets go out strictly in reverse layout order, the
  order backward makes the last layers' grads in: a pointer walks that
  order, and bucket k goes out only when it is complete and every bucket
  before it in the order has gone out, never in the order the hooks
  happen to fire.  Sync-BN's backward all-reduces are issued from the
  same backward on the same group; autograd walks the same graph in the
  same order on every rank, so they interleave with the buckets' the same
  way on every rank.
- **Bit-equal to the fused exchange.**  The fused exchange is
  :class:`BucketExchange` too, fed every grad after backward and issuing
  in layout order: the same
  buckets go through the same collectives, whose results do not depend on
  when they were issued (``tests/test_torch_zero1_overlap.py`` holds
  ``psum_bucket``, ``ring_int8`` and ``zero1``, with sync-BN and with
  ``n_subb=2``).  ``ring_int8`` seeds bucket b's rounding from
  ``derive_seed(seed, b)``, its layout index, whatever the issue order.
- **``n_subb > 1``.**  The hooks are armed for the last micro-batch only,
  and form the fused path's ``(g_0 + ... + g_{k-1}) / n_subb`` from the
  sum of the earlier ones before packing.
- **On the card** hooks run on autograd's device thread; ``wait`` on a
  collective's work makes the waiting stream (the step's) wait for it
  before the update reads the buffer.
- **The rings** (``ring_bucket``, ``ring_bf16_bucket``, ``ring_int8``) are
  blocking ``batch_isend_irecv`` loops, so a hook runs its bucket's ring
  to the end, the same way on every rank.  Overlap buys them little: on
  gloo the host thread that drives backward waits for each ring; under
  NCCL the hops only wait on the stream, so kernels already queued keep
  the card busy while the host issues them.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from theanompi_torch.models.data.base import derive_seed
from theanompi_torch.ops.opt import sharded_update
from theanompi_torch.ops.quant import quantize_chunk
from theanompi_torch.parallel import mesh

#: leaf-wise strategies: one collective per floating leaf
LEAFWISE_STRATEGIES = ("none", "psum", "psum_bf16", "ring", "ring_bf16")
#: bucketed strategies: fused flat buckets instead of one collective a leaf
BUCKETED_STRATEGIES = ("psum_bucket", "psum_bf16_bucket", "ring_bucket",
                       "ring_bf16_bucket", "ring_int8", "zero1")

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
    """The leaves of nested dicts and lists in sorted-key order, lists in
    order (``jax.tree``'s)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def unflatten(tree, leaves: list):
    """A tree shaped like ``tree`` (keys in its order) holding ``leaves``,
    given in :func:`flatten`'s order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            sub = {k: build(t[k]) for k in sorted(t)}
            return {k: sub[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


# -- point to point -----------------------------------------------------------

def _shift(send: torch.Tensor, n: int) -> torch.Tensor:
    """Send ``send`` to the next rank of the ring and -> what the previous
    rank sent (the reference's ``ppermute`` over ``i -> i + 1``)."""
    r, group = mesh.data_index(), mesh.data_group()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, mesh.data_peer((r + 1) % n), group),
            dist.P2POp(dist.irecv, recv, mesh.data_peer((r - 1) % n),
                       group)]):
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
    idx = mesh.data_index()
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
    idx = mesh.data_index()

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
    """The data group's sum of ``x`` in a new tensor."""
    out = x.clone()
    dist.all_reduce(out, group=mesh.data_group())
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


def _fused_reduce(tree, mean: bool):
    n = mesh.data_size()
    if n == 1:
        return tree
    leaves = flatten(tree)
    out = list(leaves)
    for bucket in _bucket_layout(leaves, bucket_bytes=2**62, n=1):
        red = _all_reduce(_pack(leaves, bucket))
        if mean:
            red = red / n
        for i, arr in _unpack(red, bucket).items():
            out[i] = arr
    return unflatten(tree, out)


def fused_pmean(tree):
    """Mean-reduce every floating leaf over the group with one collective
    per dtype (the trainer's metrics and model state); other leaves pass
    through, and at a world of 1 the tree comes back as it is."""
    return _fused_reduce(tree, mean=True)


def fused_psum(tree):
    """:func:`fused_pmean`'s sum: every floating leaf summed over the
    group, one collective per dtype, each leaf in its own dtype (the async
    rules' exchanges)."""
    return _fused_reduce(tree, mean=False)


class _Pending:
    """One bucket's collective in flight: :meth:`result` waits for it
    (for an asynchronous collective, makes the caller's stream wait) and
    returns the bucket's reduced buffer."""

    __slots__ = ("work", "finish")

    def __init__(self, work, finish):
        self.work, self.finish = work, finish

    def result(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        return self.finish()


class BucketExchange:
    """One step's bucketed exchange: the buckets' collectives, each issued
    (:meth:`Exchanger.start_bucket`) once all its grads are in, in a fixed
    order: layout order (``reverse=False``, the fused exchange, fed every
    grad at once by :meth:`feed`) or reverse layout order (the overlapped
    exchange, fed by the hooks :meth:`arm` puts on backward's leaves).
    ``tree`` gives the layout (the params, or the grads: the same leaves);
    ``seed`` is the exchange's seed.  ``self[b]`` is bucket b's result,
    waited for (once)."""

    def __init__(self, exchanger, tree, seed: int = 0,
                 reverse: bool = False):
        self.exchanger = exchanger
        self.seed = seed
        self.buckets = exchanger.layout(tree, mesh.data_size())
        order = range(len(self.buckets))
        self.order = list(reversed(order) if reverse else order)
        self._owner = {i: b for b, bucket in enumerate(self.buckets)
                       for i in bucket.indices}
        self._missing = [len(b.indices) for b in self.buckets]
        self._grads: dict = {}
        self._issued = 0
        self._pending: dict = {}
        self._acc = None

    def accumulate(self, gsum, n_subb: int) -> None:
        """Form each grad as ``(gsum + g) / n_subb`` before packing: the
        last micro-batch's hooks, ``gsum`` the earlier ones' sum."""
        self._acc = (flatten(gsum), n_subb)

    def arm(self, leaves: list) -> None:
        """Hook each bucketed leaf of ``leaves`` (the tensors backward
        differentiates, in :func:`flatten`'s order of the params)."""
        for i, leaf in enumerate(leaves):
            if i in self._owner:
                leaf.register_hook(functools.partial(self._hook, i))

    def _hook(self, i: int, grad: torch.Tensor) -> None:
        self.put(i, grad)  # None: the grad itself is left as it is

    def put(self, i: int, grad: torch.Tensor) -> None:
        """Leaf ``i``'s grad is in: issue every bucket that is complete
        and next in the order."""
        if self._acc is not None:
            gsum, n_subb = self._acc
            grad = (gsum[i] + grad) / n_subb
        self._grads[i] = grad
        self._missing[self._owner[i]] -= 1
        while (self._issued < len(self.order)
               and self._missing[self.order[self._issued]] == 0):
            b = self.order[self._issued]
            bucket = self.buckets[b]
            buf = _pack(self._grads, bucket)
            for j in bucket.indices:
                del self._grads[j]
            self._pending[b] = self.exchanger.start_bucket(
                buf, derive_seed(self.seed, b))
            self._issued += 1

    def feed(self, leaves: list) -> "BucketExchange":
        """Every grad at once (``leaves`` in :func:`flatten`'s order)."""
        for i, grad in enumerate(leaves):
            if i in self._owner:
                self.put(i, grad)
        return self

    def __getitem__(self, b: int) -> torch.Tensor:
        if self._issued < len(self.order):
            never = self.order[self._issued:]
            raise RuntimeError(
                f"bucket(s) {never} never issued: "
                f"{sum(self._missing[k] for k in never)} leaf grad(s) did "
                f"not arrive")
        return self._pending.pop(b).result()


class Exchanger:
    """Averages a gradient tree across the ranks of the process group.

    ``strategy`` is the reference's plug point (leaf-wise or bucketed, see
    the module docstring); ``bucket_bytes`` caps a fused bucket (4 MiB by
    default, the ``exch_bucket_mb`` rule key); ``overlap`` (bucketed
    strategies only) has the trainer issue the buckets' collectives from
    backward (:class:`BucketExchange`).  ``zero1`` fuses
    the exchange into the update: the trainer calls
    :meth:`exchange_and_update` and keeps the optimizer state of
    :meth:`zero1_init_opt_state`."""

    def __init__(self, strategy: str = "psum",
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 overlap: bool = False):
        known = LEAFWISE_STRATEGIES + BUCKETED_STRATEGIES
        if strategy not in known:
            raise ValueError(f"unknown exchange strategy {strategy!r}; "
                             f"available: {sorted(known)}")
        if int(bucket_bytes) < 1:
            raise ValueError(
                f"bucket_bytes must be positive, got {bucket_bytes}")
        if overlap and strategy not in BUCKETED_STRATEGIES:
            raise ValueError(
                f"exch_overlap issues per-bucket collectives; strategy "
                f"{strategy!r} is not bucketed (one of "
                f"{BUCKETED_STRATEGIES})")
        self.strategy = strategy
        self.bucket_bytes = int(bucket_bytes)
        self.overlap = bool(overlap)

    @property
    def bucketed(self) -> bool:
        return self.strategy in BUCKETED_STRATEGIES

    @property
    def fuses_update(self) -> bool:
        """True for ``zero1``: the trainer calls :meth:`exchange_and_update`,
        not :meth:`exchange`."""
        return self.strategy == "zero1"

    def exchange(self, tree, seed: int = 0, inflight=None):
        """Mean-reduce every floating leaf of ``tree`` across the group;
        -> a new tree (the input is not written).  ``seed`` keys
        ``ring_int8``'s stochastic rounding (pass one per rank and step;
        bucket ``b``'s stream is ``derive_seed(seed, b)``); the other
        strategies ignore it.  ``inflight``: the step's
        :class:`BucketExchange` whose
        hooks issued the buckets' collectives during backward (None: issue
        them here)."""
        if self.fuses_update:
            raise ValueError(
                "zero1 fuses the exchange into the optimizer update; call "
                "exchange_and_update(grads, opt_state, params, lr, opt)")
        n = mesh.data_size()
        if n == 1 or self.strategy == "none":
            return tree
        leaves = flatten(tree)
        out = list(leaves)
        if not self.bucketed:
            for i, x in enumerate(leaves):
                if isinstance(x, torch.Tensor) and _inexact(x.dtype):
                    out[i] = _leaf_mean(self.strategy, x, n)
            return unflatten(tree, out)
        if inflight is None:
            inflight = BucketExchange(self, tree, seed).feed(leaves)
        for bi in inflight.order:
            for i, arr in _unpack(inflight[bi], inflight.buckets[bi]).items():
                out[i] = arr
        return unflatten(tree, out)

    def start_bucket(self, buf: torch.Tensor, seed: int) -> _Pending:
        """Issue the collective of one packed bucket (``buf``, a fresh
        buffer it may write); -> its :class:`_Pending`, whose result is
        the bucket's mean, or under ``zero1`` this rank's chunk of it
        (chunk r of ``buf.reshape(n, -1)``, as ``psum_scatter`` and
        ``dynamic_index_in_dim`` give it).  The all-reduces and the
        scatter are asynchronous; the rings run their point-to-point
        hops here, to the end.  At a world of 1 the result is ``buf``."""
        n, s, group = mesh.data_size(), self.strategy, mesh.data_group()
        if n == 1:
            return _Pending(None, lambda: buf)
        if s == "psum_bucket":
            work = dist.all_reduce(buf, group=group, async_op=True)
            return _Pending(work, lambda: buf / n)
        if s == "psum_bf16_bucket":
            summed = buf.to(torch.bfloat16)
            work = dist.all_reduce(summed, group=group, async_op=True)
            return _Pending(work, lambda: (summed.float() / n).to(buf.dtype))
        if s == "zero1":
            chunk = buf.new_empty(buf.numel() // n)
            work = dist.reduce_scatter_tensor(chunk, buf, group=group,
                                              async_op=True)
            return _Pending(work, lambda: chunk / n)
        if s == "ring_bucket":
            red = _ring_allreduce(buf, n) / n
        elif s == "ring_bf16_bucket":
            out = _ring_allreduce(buf, n, wire_dtype=torch.bfloat16)
            red = (out.float() / n).to(buf.dtype)
        elif s == "ring_int8":
            red = (_ring_allreduce_int8(buf, n, seed) / n).to(buf.dtype)
        else:
            raise AssertionError(f"not a bucketed strategy: {s}")
        return _Pending(None, lambda: red)

    # -- zero1: the exchange fused into the optimizer update ------------------
    def exchange_and_update(self, grads, opt_state, params, lr, opt,
                            seed: int = 0, inflight=None):
        """``zero1``'s step (after ``exchanger.py:575-648``): each grad
        bucket reduce-scattered (the mean), the update of this rank's
        shard of the bucket's params with ``opt_state`` (in
        :meth:`zero1_init_opt_state`'s layout) as the bucket lands, and
        the updated shard all-gathered (issued as soon as it is updated,
        asynchronously).  -> (new params, new opt state).  At a world of
        1 there is no collective: the update runs on the whole flat
        buckets.  Non-float param leaves pass through.  ``inflight`` as
        in :meth:`exchange`; ``seed`` is accepted for the signature's
        sake and unused."""
        if not self.fuses_update:
            raise ValueError(f"exchange_and_update is zero1's; strategy "
                             f"{self.strategy!r} calls exchange()")
        n, r = mesh.data_size(), mesh.data_index()
        p_leaves = flatten(params)
        if inflight is None:
            inflight = BucketExchange(self, params, seed).feed(
                flatten(grads))
        buckets = inflight.buckets
        p_shards = [_pack(p_leaves, b).reshape(n, -1)[r] for b in buckets]
        gathers = {}

        def release(bi, shard):
            if n == 1:
                gathers[bi] = _Pending(None, lambda: shard)
                return
            full = shard.new_empty(n * shard.numel())
            work = dist.all_gather_into_tensor(full, shard,
                                               group=mesh.data_group(),
                                               async_op=True)
            gathers[bi] = _Pending(work, lambda: full)

        _, new_opt_state = sharded_update(
            opt, inflight, opt_state, p_shards, lr,
            chain=(inflight.order, release),
            reduce=_all_reduce if n > 1 else None)
        out = list(p_leaves)
        for bi in inflight.order:
            for i, arr in _unpack(gathers.pop(bi).result(),
                                  buckets[bi]).items():
                out[i] = arr
        return unflatten(params, out), new_opt_state

    def zero1_layout(self, params, axis_size: int) -> list[_Bucket]:
        """``zero1``'s bucket layout of ``params`` at ``axis_size`` ranks."""
        return self.layout(params, axis_size)

    def zero1_init_opt_state(self, optimizer, params, axis_size: int):
        """``optimizer``'s state over this rank's ``padded // axis_size``
        slice of each flat bucket (the ZeRO-1 saving: 1/n of the state a
        rank), on the params' device.  ``convert.zero1_opt_state_from_jax``
        maps the reference's global buffers onto it."""
        n = max(1, axis_size)
        device = next(x for x in flatten(params)
                      if isinstance(x, torch.Tensor)).device
        return optimizer.init([
            torch.zeros(b.padded // n, dtype=b.dtype, device=device)
            for b in self.zero1_layout(params, n)])

    def zero1_gather_opt_state(self, opt_state: dict) -> dict | None:
        """Rank 0's ``zero1`` optimizer state with each bucket's
        ``padded // n`` slices gathered from every rank into the global
        ``(padded,)`` bucket (the port's element order; replicated
        entries as they are): what a checkpoint holds.  None on the other
        ranks, which allocate nothing.  A collective: every rank calls
        it.  Under NCCL the buckets land on rank 0's card; gloo gathers
        host tensors, so there each slice goes through its rank's host and
        rank 0 assembles the buckets in host memory.  At a world of 1 the
        state is global already."""
        n, r = mesh.data_size(), mesh.data_index()
        if n == 1:
            return opt_state
        on_host = dist.get_backend() == "gloo"

        def gather(shard):
            shard = (shard.cpu() if on_host else shard).contiguous()
            full = shard.new_empty(n * shard.numel()) if r == 0 else None
            dist.gather(shard, None if full is None
                        else list(full.view(n, -1)), dst=mesh.data_peer(0),
                        group=mesh.data_group())
            return full

        out = {k: [gather(s) for s in v] if isinstance(v, list) else v
               for k, v in opt_state.items()}
        return out if r == 0 else None

    def zero1_gathered_like(self, opt_state: dict) -> dict:
        """What :meth:`zero1_gather_opt_state` returns on rank 0, with no
        collective and no memory: meta tensors for buckets that land on
        the card (the shapes a checkpoint's pinned staging needs), none
        for buckets assembled on the host."""
        n = mesh.data_size()
        if n == 1:
            return opt_state
        if dist.get_backend() == "gloo":
            return {k: v for k, v in opt_state.items()
                    if not isinstance(v, list)}
        return {k: [torch.empty(n * s.numel(), dtype=s.dtype, device="meta")
                    for s in v] if isinstance(v, list) else v
                for k, v in opt_state.items()}

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
        on the same tree; ``zero1``'s reduce-scatter and all-gather move
        ``(n - 1) / n`` each, ``psum``'s total.  Overlap changes only when
        the collectives are issued, not what they move."""
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
        return (f"Exchanger(strategy={self.strategy!r}"
                + (", overlap=True)" if self.overlap else ")"))
