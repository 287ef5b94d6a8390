"""Optimizers over param trees: SGD (plain, momentum, Nesterov) with
weight decay and global-norm clipping.

Counterpart of ``theanompi_tpu/ops/opt.py`` for one process: an optimizer
is an immutable object with ``init(params) -> opt_state`` and
``update(grads, opt_state, params, lr) -> (new_params, new_opt_state)``.
Both are pure, as in the reference: ``update`` returns new trees and
changes none it is given, so a caller can keep the old params (the trainer
replaces its own references each step).  The caller runs it under
``torch.no_grad()``.  Adam and RMSProp come with the GAN models, and the
sharding-aware norms with the sharding slice.
"""

from __future__ import annotations

import dataclasses

import torch

from theanompi_torch.tree import tree_map


def _sorted_leaves(tree) -> list:
    """Leaves in sorted-key order, the order ``jax.tree`` flattens dicts
    in, so a sum over leaves rounds as the reference's does."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def global_sq_norm(grads):
    """Global squared L2 norm of a gradient tree, in fp32."""
    total = 0
    for g in _sorted_leaves(grads):
        total = total + g.float().square().sum()
    return total


def clip_by_global_norm(grads, max_norm: float):
    """Scale the whole tree so its global L2 norm is at most ``max_norm``."""
    norm = torch.sqrt(global_sq_norm(grads))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


class Optimizer:
    #: defaults for the _preprocess contract; subclasses carry the fields
    grad_clip: float | None = None
    weight_decay: float = 0.0

    def init(self, params):
        raise NotImplementedError

    def update(self, grads, opt_state, params, lr):
        raise NotImplementedError

    def _preprocess(self, grads, params):
        """Clip, then weight decay, in that order (the reference's)."""
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip)
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

    def update(self, grads, opt_state, params, lr):
        grads = self._preprocess(grads, params)
        if self.momentum == 0.0:
            return tree_map(lambda p, g: p - lr * g, params, grads), opt_state
        mom = self.momentum
        vel = tree_map(lambda v, g: mom * v - lr * g,
                       opt_state["velocity"], grads)
        step = (tree_map(lambda v, g: mom * v - lr * g, vel, grads)
                if self.nesterov else vel)
        return (tree_map(lambda p, s: p + s, params, step),
                {"velocity": vel})
