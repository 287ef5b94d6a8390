"""Optimizers over param trees: SGD (plain, momentum, Nesterov), Adam and
RMSProp, with weight decay and global-norm clipping, and the sharded
update of ``zero1``.

Counterpart of ``theanompi_tpu/ops/opt.py``: an optimizer is an immutable
object with ``init(params) -> opt_state`` and ``update(grads, opt_state,
params, lr) -> (new_params, new_opt_state)``.  Both are pure, as in the
reference: ``update`` returns new trees and changes none it is given, so a
caller can keep the old params (the trainer replaces its own references
each step).  The caller runs it under ``torch.no_grad()``.

The global norm is sharding-aware (the reference's :39-78): given the
params' specs (each leaf's dim cut over the model group, or None), a cut
leaf's squared norm is summed over the model group and a replicated leaf
counted once, so clipping (``update(..., param_specs=)``) and a model's
L2 term see the norm of the whole tree under tensor parallelism.
"""

from __future__ import annotations

import dataclasses

import torch

from theanompi_torch.parallel import mesh
from theanompi_torch.parallel.tensor import psum_fwd_identity_bwd
from theanompi_torch.tree import tree_leaves_with_path, tree_map


def _sorted_leaves(tree) -> list:
    """Leaves in sorted-key order (lists in order), the order ``jax.tree``
    flattens in, so a sum over leaves rounds as the reference's does."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def global_sq_norm(grads, specs=None):
    """Global squared L2 norm of a tree, in fp32.  ``specs`` (a tree of
    sharded dims, None for a replicated leaf): under a model group the cut
    leaves' squares are summed over the group, through Megatron's ``g``
    (forward all-reduce, backward pass-through), so the norm is the whole
    tree's on every rank and an L2 term built on it has the one-process
    gradient."""
    leaves = _sorted_leaves(grads)
    if specs is None or mesh.model_group() is None:
        total = 0
        for g in leaves:
            total = total + g.float().square().sum()
        return total
    cut, whole = 0, 0
    for g, dim in zip(leaves, _sorted_leaves(specs)):
        sq = g.float().square().sum()
        if dim is None:
            whole = whole + sq
        else:
            cut = cut + sq
    if torch.is_tensor(cut):
        cut = psum_fwd_identity_bwd(cut)
    return cut + whole


def _clip_scale(sq, max_norm: float):
    """The factor that brings a tree of squared norm ``sq`` to a norm of
    at most ``max_norm``."""
    norm = torch.sqrt(sq)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float, specs=None):
    """Scale the whole tree so its global L2 norm (sharding-aware with
    ``specs``) is at most ``max_norm``."""
    scale = _clip_scale(global_sq_norm(grads, specs), max_norm)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


def _bucket_state(opt_state: dict, i: int) -> dict:
    """Bucket ``i``'s part of a ``zero1`` optimizer state: one-item lists
    of its buffers, the replicated entries (Adam's step ``t``) as they
    are."""
    return {k: [v[i]] if isinstance(v, list) else v
            for k, v in opt_state.items()}


def sharded_update(opt, grads, opt_state, params, lr, chain=None,
                   reduce=None):
    """``zero1``'s update (after ``theanompi_tpu/ops/opt.py:83-133``):
    ``opt.update``'s math on this rank's shard of each flat bucket.
    ``grads``, ``params`` and ``opt_state``'s lists hold one shard a
    bucket; -> (new param shards, new opt state).

    Weight decay and every update rule here are elementwise, so they apply
    to a shard as to the whole.  Clipping's global norm is the one
    cross-shard quantity: the shards partition the tree exactly (the
    padding is zeros), so the group's sum of the per-shard squared norms
    is the global squared norm.  ``reduce`` forms that sum, one scalar
    all-reduce, and returns it (the caller's, as the reference's caller
    passes ``axis_name``; None: one process, the shards are the whole).
    Clipping is done here and then turned off on the inner optimizer,
    never applied twice.

    Each bucket is updated on its own, bucket by bucket, in ``chain``'s
    order: ``chain`` (the exchanger's) is ``(order, release)``, the bucket
    indices in the order their scatters land (``grads[i]`` is read once
    each, in that order, and may wait for the collective) and
    ``release(i, new_shard)``, called as soon as bucket ``i`` is updated
    (the exchanger's all-gather).  Without it, layout order and no
    release.  The per-bucket updates are the whole-list update's
    elementwise ops, so the result does not depend on the order.  With
    ``grad_clip`` the norm needs every shard first, so all land before
    the first update."""
    order, release = chain if chain is not None else (
        range(len(params)), None)
    order = list(order)
    if opt.grad_clip:
        landed = {i: grads[i] for i in order}
        grads = [landed[i] for i in range(len(params))]
        sq = global_sq_norm(grads)
        if reduce is not None:
            sq = reduce(sq)
        scale = _clip_scale(sq, opt.grad_clip)
        grads = [(g * scale).to(g.dtype) for g in grads]
        opt = dataclasses.replace(opt, grad_clip=None)
    new_params = list(params)
    new_state = {k: list(v) if isinstance(v, list) else v
                 for k, v in opt_state.items()}
    for i in order:
        (p,), sub = opt.update([grads[i]], _bucket_state(opt_state, i),
                               [params[i]], lr)
        new_params[i] = p
        for k, v in sub.items():
            if isinstance(new_state[k], list):
                new_state[k][i] = v[0]
            else:
                new_state[k] = v
        if release is not None:
            release(i, p)
    return new_params, new_state


class Optimizer:
    #: defaults for the _preprocess contract; subclasses carry the fields
    grad_clip: float | None = None
    weight_decay: float = 0.0

    def init(self, params):
        raise NotImplementedError

    def update(self, grads, opt_state, params, lr, param_specs=None):
        """-> (new params, new opt state); ``param_specs`` makes
        clipping's norm the whole tree's under tensor parallelism."""
        raise NotImplementedError

    def _preprocess(self, grads, params, param_specs=None):
        """Clip, then weight decay, in that order (the reference's)."""
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip, param_specs)
        if self.weight_decay:
            wd = self.weight_decay
            grads = tree_map(lambda g, p: g + wd * p, grads, params)
        return grads


@dataclasses.dataclass(frozen=True)
class SGD(Optimizer):
    """Vanilla / momentum / Nesterov SGD with optional L2 weight decay.

    ``momentum=0`` is vanilla; ``nesterov=True`` is the reference's
    formulation (the lookahead applied to the update, not the gradient)."""

    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0
    grad_clip: float | None = None

    def init(self, params):
        if self.momentum == 0.0:
            return {}
        return {"velocity": tree_map(torch.zeros_like, params)}

    def update(self, grads, opt_state, params, lr, param_specs=None):
        grads = self._preprocess(grads, params, param_specs)
        if self.momentum == 0.0:
            return tree_map(lambda p, g: p - lr * g, params, grads), opt_state
        mom = self.momentum
        vel = tree_map(lambda v, g: mom * v - lr * g,
                       opt_state["velocity"], grads)
        step = (tree_map(lambda v, g: mom * v - lr * g, vel, grads)
                if self.nesterov else vel)
        return (tree_map(lambda p, s: p + s, params, step),
                {"velocity": vel})


@dataclasses.dataclass(frozen=True)
class Adam(Optimizer):
    """Adam (``opt.py:199-235``), with the replicated int32 step ``t``."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float | None = None

    def init(self, params):
        device = tree_leaves_with_path(params)[0][1].device
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(self, grads, opt_state, params, lr, param_specs=None):
        grads = self._preprocess(grads, params, param_specs)
        b1, b2, eps = self.b1, self.b2, self.eps
        t = opt_state["t"] + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, opt_state["m"],
                     grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                     opt_state["v"], grads)
        tf = t.float()
        scale = torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
        new_params = tree_map(
            lambda p, m_, v_: p - lr * scale * m_ / (torch.sqrt(v_) + eps),
            params, m, v)
        return new_params, {"m": m, "v": v, "t": t}


@dataclasses.dataclass(frozen=True)
class RMSProp(Optimizer):
    """RMSProp (``opt.py:238-262``)."""

    decay: float = 0.9
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float | None = None

    def init(self, params):
        return {"sq": tree_map(torch.zeros_like, params)}

    def update(self, grads, opt_state, params, lr, param_specs=None):
        grads = self._preprocess(grads, params, param_specs)
        decay, eps = self.decay, self.eps
        sq = tree_map(lambda s, g: decay * s + (1 - decay) * torch.square(g),
                      opt_state["sq"], grads)
        new_params = tree_map(
            lambda p, g, s: p - lr * g / (torch.sqrt(s) + eps),
            params, grads, sq)
        return new_params, {"sq": sq}
