"""EASGD: elastic averaging, one process a worker, and its plain-average
control, LocalSGD.

Counterpart of ``theanompi_tpu/parallel/easgd.py`` (``elastic_exchange``
:66, ``worker_drift`` :83, ``EASGDTrainer`` :99, ``LocalSGDTrainer`` :287,
the rules :306-331).  Each rank runs τ collective-free local steps on its
own worker, then one synchronous elastic round updates the workers and
the center together::

    diff_r  = p_r − center
    p_r    ← p_r − α·diff_r
    center ← center + α·Σ_r diff_r

through one all-reduce of the float leaves' ``p − c`` a dtype
(:func:`~theanompi_torch.parallel.exchanger.fused_psum`, each leaf in its
own dtype).  The center is replicated: every rank holds it and applies
the same sum, so it stays bit-equal across ranks.  α defaults to ``0.9 /
n`` (the EASGD paper's β = 0.9); the ``EASGD`` rule scales the LR by the
worker count (``Model.scale_lr``, the reference worker's hook) unless
``scale_lr=False``.  Validation evaluates the center, with the workers'
model state averaged.

The reference's straggler fault site (``easgd:worker_slow``) and its
``easgd.exchange`` telemetry come with the resilience and telemetry
slices; the exchange is timed in the recorder's ``comm`` segment.
"""

from __future__ import annotations

import torch

from theanompi_torch import dist as tdist
from theanompi_torch.parallel.exchanger import flatten, fused_psum
from theanompi_torch.parallel.stacked import AsyncRule, AsyncTrainer
from theanompi_torch.parallel.trainer import pmean_floats
from theanompi_torch.tree import tree_map


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def elastic_exchange(params, center, alpha: float):
    """One elastic round on this rank: -> (new params, new center); the
    float leaves' ``p − c`` summed over the ranks in one collective a
    dtype, other leaves left as they are."""
    with torch.no_grad():
        diff = tree_map(lambda p, c: p - c if _is_float(p) else p, params,
                        center)
        summed = fused_psum(diff)
        new_p = tree_map(
            lambda p, d: p - alpha * d if _is_float(p) else p, params, diff)
        new_c = tree_map(
            lambda c, s: c + alpha * s if _is_float(c) else c, center, summed)
    return new_p, new_c


def worker_drift(params, center) -> torch.Tensor:
    """This worker's relative divergence from the center, ``|p − c| /
    |c|`` over the float leaves, in fp32 (the reference's health
    signal)."""
    num = den = 0.0
    with torch.no_grad():
        for p, c in zip(flatten(params), flatten(center)):
            if not _is_float(p):
                continue
            d = p.float() - c.float()
            num = num + (d * d).sum()
            den = den + c.float().square().sum()
        return torch.sqrt(torch.as_tensor(num)) / torch.clamp(
            torch.sqrt(torch.as_tensor(den)), min=1e-12)


def _first_float(tree):
    return next(x for x in flatten(tree) if _is_float(x))


class EASGDTrainer(AsyncTrainer):
    """τ local steps a worker, then the elastic exchange."""

    def __init__(self, model, tau: int = 4, alpha: float | None = None,
                 **kwargs):
        super().__init__(model, **kwargs)
        self.tau = int(tau)
        # the configured value apart from the derived one: the
        # fingerprint stamps the configuration ("auto" when defaulted)
        self._alpha_cfg = alpha
        self.alpha = (float(alpha) if alpha is not None
                      else 0.9 / self.n_workers)
        self.center = None

    def init_state(self) -> None:
        """The workers' init; the center is that init too."""
        super().init_state()
        self.center = tree_map(torch.clone, self.params)

    def _exchange_pair(self, params, center):
        """The periodic exchange (LocalSGD overrides this one hook)."""
        return elastic_exchange(params, center, self.alpha)

    def _exchange(self):
        self.params, self.center = self._exchange_pair(self.params,
                                                       self.center)
        return _first_float(self.center)

    def post_step(self) -> None:
        if self.iteration % self.tau == 0:
            self._timed_exchange(self._exchange)

    def warmup_exchange(self) -> None:
        self._exchange()

    def eval_args(self) -> tuple:
        """The center, with the workers' model state averaged."""
        with torch.no_grad():
            return self.center, pmean_floats(self.state)

    def checkpoint_trees(self) -> dict:
        return {**super().checkpoint_trees(), "center": self.center}

    def _fingerprint_extra(self) -> dict:
        """The reference's stamp: ``rule`` is the stacked layout's tag,
        ``alpha`` the configured value ("auto" when defaulted)."""
        return {"rule": "easgd", "tau": self.tau,
                "alpha": ("auto" if self._alpha_cfg is None
                          else float(self._alpha_cfg))}


class LocalSGDTrainer(EASGDTrainer):
    """Periodic parameter averaging: τ local steps, then ``p_r ←
    mean_j(p_j)``; the center is kept equal to the average, so
    validation evaluates it as EASGD's does.  The control that tells the
    elastic coupling's failure from the τ-stale exchange's."""

    def _exchange_pair(self, params, center):
        with torch.no_grad():
            avg = pmean_floats(params)
        return avg, avg


class EASGD(AsyncRule):
    """The elastic-averaging rule.  Config: ``tau`` (4), ``alpha``
    (``0.9 / n``), ``scale_lr`` (True: the LR times the worker count
    above one worker)."""

    trainer_cls = EASGDTrainer
    scale_lr_default = True

    def make_trainer(self, model, device, recorder) -> EASGDTrainer:
        n = tdist.world()
        if n > 1 and self.config.get("scale_lr", self.scale_lr_default):
            model.scale_lr(n)
        return self.trainer_cls(
            model, tau=self.config.get("tau", 4),
            alpha=self.config.get("alpha"), device=device, recorder=recorder,
            **self.async_kwargs(), **self.trainer_kwargs())


class LocalSGD(EASGD):
    """The periodic-averaging rule (the EASGD control).  Config: ``tau``;
    ``scale_lr`` is off by default (its baseline is BSP)."""

    trainer_cls = LocalSGDTrainer
    scale_lr_default = False
