"""Tensor parallelism: Megatron's column and row splits over the model
group, and the partition rules that place params.

Counterpart of ``theanompi_tpu/parallel/tensor.py``.  The scheme is the
standard pair:

- **column-parallel**: weight ``[D, F]`` cut on F: no communication in
  the forward; outputs (and bias) are feature-sharded;
- **row-parallel**: weight ``[F, D]`` cut on F: consumes feature-sharded
  inputs, produces partial sums, one all-reduce over the model group
  completes the matmul (the bias is added after it, once).

Megatron's ``f`` and ``g`` are two ``torch.autograd.Function`` s over the
model group (:func:`theanompi_torch.parallel.mesh.model_group`): ``g``
all-reduces forward and passes the cotangent through backward (the
output cotangent is replicated and is already each shard's partial's);
``f`` passes forward and all-reduces backward (each shard's input
cotangent is the partial from its feature slice).  With no model axis
(size 1, or no layout bound) both are the identity, so the same layer
code runs unsharded, as the reference's ``axis_bound`` makes it.

A port "spec" names the sharded dim of each param leaf (an int), or None
for a replicated leaf: the reference's ``PartitionSpec`` over ``model``
reduced to the one fact a rank needs.  Params are built whole on every
rank from the same generator (or converted from the reference) and then
cut (:func:`shard_tree`), as the reference's host builds full params and
places them; :func:`gather_tree` joins the shards back into the
reference's global layout (checkpoints, tests).

:data:`COLLECTIVES` counts the model group's collectives by kind where
each is issued (``f``, ``g``, the vocab-parallel loss's ``vp_max``,
``vp_sum`` and ``vp_rank``, the MoE's ``a2a``), as the kernels count
their launches.
"""

from __future__ import annotations

import collections
import re

import torch
import torch.distributed as dist

from theanompi_torch.ops import quant
from theanompi_torch.ops.layers import Dense
from theanompi_torch.parallel import mesh
from theanompi_torch.tree import tree_leaves_with_path, tree_map

#: the model group's collectives issued in this process, by kind
COLLECTIVES: collections.Counter = collections.Counter()


def all_reduce(x: torch.Tensor, group, kind: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group`` in a new tensor, counted as ``kind``."""
    COLLECTIVES[kind] += 1
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _G(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group, "g")

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce(ct, ctx.group, "f"), None


def psum_fwd_identity_bwd(x: torch.Tensor) -> torch.Tensor:
    """Megatron ``g``: all-reduce forward, pass-through backward."""
    group = mesh.model_group()
    return x if group is None else _G.apply(x, group)


def identity_fwd_psum_bwd(x: torch.Tensor) -> torch.Tensor:
    """Megatron ``f``: pass-through forward, all-reduce backward."""
    group = mesh.model_group()
    return x if group is None else _F.apply(x, group)


class ColumnParallelDense(Dense):
    """Feature-sharded ``Dense``: ``w`` cut on dim 1, ``b`` on dim 0.  The
    forward is communication-free; ``f`` all-reduces the input cotangent
    in backward, unless ``input_synced`` (the caller applied ``f`` once to
    an input several projections share).  ``init`` sees the global
    width."""

    def __init__(self, units: int, input_synced: bool = False, **kwargs):
        super().__init__(units, **kwargs)
        self.input_synced = input_synced

    @property
    def name(self) -> str:
        return "cpdense"

    def forward(self, params, x):
        if not self.input_synced:
            x = identity_fwd_psum_bwd(x)
        return super().forward(params, x)


class RowParallelDense(Dense):
    """Reduction-sharded ``Dense``: ``w`` cut on dim 0; ``g`` completes the
    sum, and the bias is added after it (before, it would count once a
    shard)."""

    @property
    def name(self) -> str:
        return "rpdense"

    def forward(self, params, x):
        y = psum_fwd_identity_bwd(quant.matmul_any(x, params["w"]))
        if self.use_bias:
            y = y + params["b"].to(x.dtype)
        return y


#: path regex -> the sharded dim; the first match wins.  Covers the
#: Sequential-named layers (``03_cpdense/w``) and the fixed keys of the
#: composite layers (attention ``q/k/v/o``, the MLP ``up/down``)
TP_RULES: tuple[tuple[str, int], ...] = (
    (r".*cpdense.*/w$", 1),
    (r".*cpdense.*/b$", 0),
    (r".*rpdense.*/w$", 0),
    (r".*/attn/[qkv]/w$", 1),
    (r".*/attn/[qkv]/b$", 0),
    (r".*/attn/o/w$", 0),
    (r".*/up/w$", 1),
    (r".*/up/b$", 0),
    (r".*/down/w$", 0),
)


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def specs_from_rules(params, rules=TP_RULES, default=None):
    """Each leaf's path (``"/"``-joined keys, e.g. ``"03__block/attn/q/w"``)
    matched against ``rules``; -> a tree of sharded dims (``default`` where
    none matches)."""
    specs: dict = {}
    for path, _ in tree_leaves_with_path(params):
        dim = next((d for pattern, d in rules
                    if re.fullmatch(pattern, _key(path))), default)
        node = specs
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = dim
    return specs


def check_divisible(params, specs, n_model: int) -> None:
    """Raise ``ValueError`` where a spec cuts a dim that ``n_model`` does
    not divide."""
    for (path, leaf), (_, dim) in zip(tree_leaves_with_path(params),
                                      tree_leaves_with_path(specs)):
        if dim is not None and leaf.shape[dim] % n_model:
            raise ValueError(
                f"param {_key(path)!r} dim {dim} ({leaf.shape[dim]}) not "
                f"divisible by mesh axis 'model' ({n_model})")


def sharded(specs) -> bool:
    """Whether any leaf of ``specs`` is cut."""
    return any(d is not None for _, d in tree_leaves_with_path(specs))


def shard_tree(tree, specs, index: int, n: int):
    """Shard ``index`` of ``n`` of each leaf of the full ``tree`` (its own
    contiguous tensor); replicated leaves as they are."""
    def cut(x, dim):
        if dim is None or n == 1:
            return x
        size = x.shape[dim] // n
        return x.narrow(dim, index * size, size).contiguous()

    return tree_map(cut, tree, specs)


def gather_tree(tree, specs, group, n: int):
    """The full tree from each rank's shards over ``group`` (a collective:
    every rank of the group calls it); replicated leaves as they are."""
    def join(x, dim):
        if dim is None or n == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    return tree_map(join, tree, specs)


def full_like(tree, specs, n: int, device=None):
    """Uninitialised full-shaped leaves of a sharded ``tree`` (on
    ``device``, or each leaf's own): the templates a restore of the global
    layout fills."""
    def grow(x, dim):
        shape = list(x.shape)
        if dim is not None:
            shape[dim] *= n
        return torch.empty(shape, dtype=x.dtype,
                           device=x.device if device is None else device)

    return tree_map(grow, tree, specs)
