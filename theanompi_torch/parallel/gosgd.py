"""GOSGD: gossip data parallelism, one process a worker.

Counterpart of ``theanompi_tpu/parallel/gosgd.py`` (``gossip_merge`` :67,
``GOSGDTrainer`` :108 with ``_round_draws`` :154, the rule :328).  After
each local step, round ``i``'s draws — a Bernoulli push mask at
``p_push`` and a shift ``k`` in 1..n−1 — are a pure function of (seed,
i) (:func:`round_draws`: ``np.random.RandomState(derive_seed("gossip",
seed, i))``), computed alike on every rank, so a resume replays them with
no state of its own.  Pusher r sends half its consensus weight ``w_r / 2``
and ``w_r / 2 · p_r`` (fp32) to rank ``(r + k) mod n``; then every rank
merges ``p ← (kept_w · p + recv) / (kept_w + recv_w)``, also a rank that
received zeros (``(w · p) / w`` is not ``p`` bit for bit, and the
reference merges everywhere).  Σw = 1 holds by construction.  A round
with no pusher skips the collective.

The transport (:func:`gossip_transport`) is chosen by the group's backend
and the tensors' device, never as a fallback from a failure: NCCL, and
gloo on the CPU, send directly by the shift (``batch_isend_irecv``; the
reference takes ``k`` hops of a one-step ring, which delivers the same
bytes); gloo with CUDA tensors, which it cannot send or receive, takes
``all_gather_into_tensor`` of each rank's flat ``[1 + numel]`` fp32
outgoing buffer, and rank r reads row ``(r − k) mod n``.  Both deliver the
same bytes, so the merge is bit-equal either way.

Validation evaluates the weighted consensus ``Σ w_r p_r`` (one fp32
all-reduce) with the workers' model state averaged.  The
``gosgd:gossip_drop`` fault site and the ``gosgd.round`` telemetry come
with the resilience and telemetry slices.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from theanompi_torch import dist as tdist
from theanompi_torch.models.data.base import derive_seed
from theanompi_torch.parallel.exchanger import flatten, fused_psum, unflatten
from theanompi_torch.parallel.stacked import AsyncRule, AsyncTrainer
from theanompi_torch.parallel.trainer import pmean_floats
from theanompi_torch.tree import tree_map

TRANSPORTS = ("p2p", "all_gather")


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def round_draws(seed: int, iteration: int, n: int, p_push: float):
    """-> (push mask ``[n]`` fp32 of 0/1, shift in 1..n−1) of round
    ``iteration``, a pure function of its arguments (the reference's
    ``_round_draws``)."""
    rng = np.random.RandomState(derive_seed("gossip", seed, iteration))
    push = (rng.rand(n) < p_push).astype(np.float32)
    shift = int(rng.randint(1, n))
    return push, shift


def gossip_transport(device) -> str:
    """``"all_gather"`` for gloo ranks on CUDA tensors (gloo has no
    send/recv of them), else ``"p2p"``."""
    if dist.get_backend() == "gloo" and torch.device(device).type == "cuda":
        return "all_gather"
    return "p2p"


def _route(out: torch.Tensor, shift: int, transport: str) -> torch.Tensor:
    """Send ``out`` to rank ``(r + shift) mod n``; -> what rank ``(r −
    shift) mod n`` sent."""
    n, r = tdist.world(), tdist.rank()
    if transport == "p2p":
        recv = torch.empty_like(out)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out, (r + shift) % n),
                dist.P2POp(dist.irecv, recv, (r - shift) % n)]):
            req.wait()
        return recv
    if transport == "all_gather":
        rows = out.new_empty(n * out.numel())
        dist.all_gather_into_tensor(rows, out)
        return rows.view(n, -1)[(r - shift) % n]
    raise ValueError(f"gossip transport {transport!r}: one of {TRANSPORTS}")


def gossip_merge(params, weight: torch.Tensor, push, shift: int,
                 transport: str):
    """One gossip round on this rank: ``weight`` its scalar fp32
    consensus weight, ``push`` the round's mask (``[n]``, every rank's
    entry), ``shift`` its ring shift.  -> (merged params, new weight)."""
    with torch.no_grad():
        sent_w = float(push[tdist.rank()]) * weight * 0.5
        kept_w = weight - sent_w
        leaves = flatten(params)
        floats = [i for i, x in enumerate(leaves) if _is_float(x)]
        out = torch.cat([sent_w.reshape(1)] + [
            (sent_w * leaves[i].float()).reshape(-1) for i in floats])
        recv = _route(out, shift, transport)
        new_w = kept_w + recv[0]
        merged, off = list(leaves), 1
        for i in floats:
            x = leaves[i]
            got = recv[off:off + x.numel()].view(x.shape)
            merged[i] = ((kept_w * x.float() + got) / new_w).to(x.dtype)
            off += x.numel()
    return unflatten(params, merged), new_w


class GOSGDTrainer(AsyncTrainer):
    """Local steps and a randomized gossip round after each.  ``p_push``
    is a worker's chance of pushing in a round (``1 / max(n, 2)`` by
    default: one push a round expected)."""

    STACKED = AsyncTrainer.STACKED + ("weights",)

    def __init__(self, model, p_push: float | None = None, **kwargs):
        super().__init__(model, **kwargs)
        self._p_push_cfg = p_push
        self.p_push = (float(p_push) if p_push is not None
                       else 1.0 / max(self.n_workers, 2))
        self.weights = None
        self.transport = (gossip_transport(self.device)
                          if self.n_workers > 1 else None)

    def init_state(self) -> None:
        """The workers' init; each rank's weight 1/n."""
        super().init_state()
        self.weights = torch.full((), 1.0 / self.n_workers,
                                  dtype=torch.float32, device=self.device)

    def _gossip(self, push, shift: int):
        self.params, self.weights = gossip_merge(
            self.params, self.weights, push, shift, self.transport)
        return self.weights

    def post_step(self) -> None:
        if self.n_workers == 1:
            return
        push, shift = round_draws(self.seed, self.iteration,
                                  self.n_workers, self.p_push)
        if push.any():
            self._timed_exchange(lambda: self._gossip(push, shift))

    def warmup_exchange(self) -> None:
        """A round with no pusher: the merge runs as a no-op's arithmetic
        (the transport included)."""
        if self.n_workers > 1:
            self._gossip(np.zeros(self.n_workers, np.float32), 1)

    def eval_args(self) -> tuple:
        """The weighted consensus ``Σ w_r p_r`` (fp32, one all-reduce),
        with the workers' model state averaged."""
        with torch.no_grad():
            w = self.weights
            summed = fused_psum(tree_map(
                lambda x: w * x.float() if _is_float(x) else x, self.params))
            consensus = tree_map(
                lambda s, x: s.to(x.dtype) if _is_float(x) else x, summed,
                self.params)
            return consensus, pmean_floats(self.state)

    def checkpoint_trees(self) -> dict:
        return {**super().checkpoint_trees(), "weights": self.weights}

    def _fingerprint_extra(self) -> dict:
        return {"rule": "gosgd",
                "p_push": ("auto" if self._p_push_cfg is None
                           else float(self._p_push_cfg))}


class GOSGD(AsyncRule):
    """The gossip rule.  Config: ``p_push``."""

    trainer_cls = GOSGDTrainer

    def make_trainer(self, model, device, recorder) -> GOSGDTrainer:
        return GOSGDTrainer(model, p_push=self.config.get("p_push"),
                            device=device, recorder=recorder,
                            **self.async_kwargs(), **self.trainer_kwargs())
