"""Precision policy, the device rule and the rank layout.

Counterpart of ``theanompi_tpu/parallel/mesh.py``'s ``Precision``/``FP32``/
``BF16``, ``make_mesh`` (:122) and ``replica_rng`` (:243).  The port runs
one process per GPU.  The reference's ``(data, pipe, model, seq)`` mesh is
a :class:`Layout` over the ranks of the process group of
:mod:`theanompi_torch.dist`, in the reference's axis order, so the ranks
of one model group are adjacent: rank ``r`` is data index ``r // n_model``
and model index ``r % n_model``.  :func:`make_layout` builds one
``torch.distributed`` sub-group per data group and per model group (every
rank creates every group, in the same order, as ``new_group`` requires).
``n_seq`` and ``n_pipe`` above 1 are refused (sequence and pipeline
parallelism, ROADMAP item 13b).

The layer code reaches the layout the way the reference's layers reach a
bound mesh axis: a trainer binds its layout (:meth:`Layout.bound`) around
what it runs, and :func:`current` is the bound one, or with none bound
the data-only layout over the whole group, where the model axis has size
1 and every collective over it is the identity (the reference's
``axis_bound``).  The data axis's accessors (:func:`data_size`,
:func:`data_index`, :func:`data_group`) are what the exchanger, sync-BN
and the trainer's means reduce over; :func:`replica_key` keys a per-rank
random stream by the data index only, so the ranks of one model group,
whose activations are one logical tensor, draw the same dropout masks.

The device rule every entry point follows: ``device=None`` means the
card (``cuda``; a rank of a process group takes its own,
``cuda:<local rank>``); with no CUDA available it raises rather than
quietly running on the CPU.  Only an explicit ``device="cpu"`` (what the
tests pass) runs on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from theanompi_torch import dist as tdist
from theanompi_torch.tree import tree_map


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` -> ``cuda`` (raises
    ``RuntimeError`` when CUDA is unavailable); anything else as given,
    with a CUDA request also checked.  In a process group of more than
    one rank, ``None`` and ``"cuda"`` name the rank's own card,
    ``cuda:<local rank>``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: theanompi_torch runs on the card unless "
                "the caller asks for device='cpu'")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is "
                           f"unavailable")
    if dev.type == "cuda" and dev.index is None and tdist.world() > 1:
        return torch.device("cuda", tdist.local_rank())
    return dev


@dataclasses.dataclass(frozen=True)
class Precision:
    """Mixed-precision policy: fp32 params, ``compute_dtype`` compute
    (the model casts its logits up to fp32 at the head)."""

    compute_dtype: torch.dtype = torch.bfloat16

    def cast_to_compute(self, tree):
        """Cast every floating tensor leaf (LayerNorm params included) to
        the compute dtype.  Non-tensor leaves — the int8
        ``QuantizedTensor``, whose fp32 scales must stay fp32 — pass
        through whole.  A leaf already in the compute dtype is returned
        as is (no copy)."""
        def cast(x):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                return x.to(self.compute_dtype)
            return x

        return tree_map(cast, tree)


#: Full precision everywhere — CPU tests and numerical parity.  On the
#: card, an fp32 convolution is whatever cuDNN runs under
#: ``torch.backends.cudnn.allow_tf32``, which PyTorch leaves on: TF32
#: (inputs rounded to 10-bit mantissas, fp32 sums) unless the caller turns
#: it off; the port's entry points leave the flag as they find it (fp32
#: matmuls follow ``torch.backends.cuda.matmul.allow_tf32``, off by
#: default).  ``chip_smoke.py`` turns both off, so its fp32 runs are
#: IEEE fp32.
FP32 = Precision(compute_dtype=torch.float32)
#: The serving default on the card.
BF16 = Precision()


# -- the rank layout ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place on the ``(data, model)`` grid and the groups of
    its two axes.  ``data_group`` None is the default group (at
    ``n_model`` 1 the data axis is the whole group); ``model_group`` None
    means no model axis (``n_model`` 1)."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: Any = None
    model_group: Any = None

    def replica_key(self) -> tuple:
        """The parts a per-replica random stream appends to its seed: the
        data index (the reference folds ``axis_index("data")``); none at
        one data worker, where a stream stays the one-process one."""
        return () if self.n_data == 1 else ("rank", self.data_index)

    @contextlib.contextmanager
    def bound(self):
        """Bind this layout for the block (:func:`current` returns it), in
        the whole process: autograd's device threads run the exchange's
        backward hooks, which must see the binding of the step that
        started them."""
        global _bound
        outer, _bound = _bound, self
        try:
            yield self
        finally:
            _bound = outer


#: the layout :meth:`Layout.bound` bound (None: none)
_bound: Layout | None = None
#: the sub-groups made for each model-axis size, with the default group
#: they were made in: ``{n_model: (world group, data groups, model groups)}``
_GROUPS: dict = {}


def make_layout(n_model: int = 1, n_seq: int = 1,
                n_pipe: int = 1) -> Layout:
    """This rank's :class:`Layout` with ``n_model`` ranks a model group
    over the process group (``world / n_model`` data workers).  Raises
    ``NotImplementedError`` for ``n_seq`` or ``n_pipe`` above 1 and
    ``ValueError`` where ``n_model`` does not divide the group."""
    for key, size in (("n_seq", n_seq), ("n_pipe", n_pipe)):
        if int(size or 1) > 1:
            raise NotImplementedError(
                f"{key}={size} not yet ported (sequence and pipeline "
                f"parallelism, ROADMAP queue 1 item 13b)")
    k = int(n_model or 1)
    world, rank = tdist.world(), tdist.rank()
    if k < 1 or world % k:
        raise ValueError(f"n_model={n_model} does not divide the "
                         f"{world} rank(s) of the process group")
    if k == 1:
        return Layout(world, 1, rank, 0)
    made = _GROUPS.get(k)
    if made is None or made[0] is not dist.group.WORLD:
        # every rank makes every group, in the same order
        made = (dist.group.WORLD,
                [dist.new_group(list(range(m, world, k))) for m in range(k)],
                [dist.new_group(list(range(d * k, (d + 1) * k)))
                 for d in range(world // k)])
        _GROUPS[k] = made
    d, m = divmod(rank, k)
    return Layout(world // k, k, d, m, made[1][m], made[2][d])


def current() -> Layout:
    """The bound layout, or the data-only layout over the whole group."""
    if _bound is not None:
        return _bound
    return Layout(tdist.world(), 1, tdist.rank(), 0)


def model_size() -> int:
    return current().n_model


def model_index() -> int:
    return current().model_index


def model_group():
    """The model axis's group (None at size 1: nothing to reduce)."""
    return current().model_group


def data_size() -> int:
    return current().n_data


def data_index() -> int:
    return current().data_index


def data_group():
    """The data axis's group (None: the default group)."""
    return current().data_group


def data_peer(i: int) -> int:
    """The global rank of data index ``i`` in this rank's data group."""
    group = data_group()
    return i if group is None else dist.get_global_rank(group, i)


def replica_key() -> tuple:
    """:meth:`Layout.replica_key` of the current layout."""
    return current().replica_key()
