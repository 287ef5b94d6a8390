"""The model contract: the interface the rules drive models through.

Counterpart of ``theanompi_tpu/models/contract.py`` (``Model`` :35 and
``SupervisedModel`` :124) for one process.  The
model owns what is trained: its config (``default_config`` merged with the caller's), the
precision policy (``precision``: ``"bf16"``, the default, or anything else
for fp32), ``batch_size``/``n_epochs``, its data (``build_data``, built at
first use, so a serving process never builds a training set), the
optimizer choice (``build_optimizer``: SGD from the config), the LR
schedule (``adjust_hyperp``), ``init_params`` and ``loss_fn``.  The
rule's trainer owns how steps run.

Every model carries state beside its params, as the reference's do:
``init_params(gen) -> (params, state)`` and ``loss_fn(params, state,
batch, gen, train) -> (loss, (new_state, metrics))``.  State is the
non-learned buffers (BatchNorm's running statistics), fp32, never cast
to the compute dtype; a model without any (``TransformerLM``) has ``{}``.
"""

from __future__ import annotations

from typing import Any

import torch

from theanompi_torch.ops.losses import softmax_cross_entropy, top_k_error
from theanompi_torch.ops.opt import SGD, global_sq_norm
from theanompi_torch.parallel.mesh import BF16, FP32, Precision


class Model:
    default_config: dict[str, Any] = {}

    def __init__(self, config: dict[str, Any] | None = None):
        self.config = {**self.default_config, **(config or {})}
        self.verbose = self.config.get("verbose", True)
        self.batch_size = self.config.get("batch_size", 128)
        self.n_epochs = self.config.get("n_epochs", 10)
        self.precision: Precision = (
            BF16 if self.config.get("precision", "bf16") == "bf16" else FP32)
        self.vocab = int(self.config.get("vocab", 256))
        self._data = None

    @property
    def data(self):
        """The dataset, built by :meth:`build_data` at first use."""
        if self._data is None:
            self._data = self.build_data()
        return self._data

    # -- construction hooks -------------------------------------------------
    def build_data(self):
        raise NotImplementedError

    def build_optimizer(self):
        return SGD(
            momentum=self.config.get("momentum", 0.9),
            weight_decay=self.config.get("weight_decay", 0.0),
            nesterov=self.config.get("nesterov", False),
            grad_clip=self.config.get("grad_clip"),
        )

    def init_opt_state(self, optimizer, params):
        """Optimizer-state layout (the GAN splits it per network)."""
        return optimizer.init(params)

    # -- what the trainer runs ----------------------------------------------
    def init_params(self, gen):
        """-> (fp32 param tree, state tree) on ``gen``'s device."""
        raise NotImplementedError

    def loss_fn(self, params, state, batch, gen, train: bool):
        """-> (loss, (new_state, metrics)).  ``gen`` is the dropout
        generator (None outside training); ``train=False`` returns the
        state unchanged."""
        raise NotImplementedError

    # -- schedule -----------------------------------------------------------
    def adjust_hyperp(self, epoch: int) -> float:
        """Learning rate for ``epoch``: the base LR with step decay at the
        configured epochs (the reference method name)."""
        lr = self.config.get("lr", 0.1)
        for e in self.config.get("lr_decay_epochs", ()):
            if epoch >= e:
                lr *= self.config.get("lr_decay_factor", 0.1)
        return lr

    def scale_lr(self, size: int) -> None:
        """Linear LR scaling with the worker count (the reference's EASGD
        hook, :115-117)."""
        self.config["lr"] = self.config.get("lr", 0.1) * size

    def cleanup(self) -> None:
        if self._data is not None:
            self._data.cleanup()


class SupervisedModel(Model):
    """Classification models: a net of :mod:`theanompi_torch.ops.layers`,
    softmax cross entropy and top-k error.

    Subclasses implement ``build_net() -> (net, in_shape)``, the net a
    stateful layer (``init_stateful``/``apply_stateful``) and ``in_shape``
    one example's ``(C, H, W)``.  Image batches are ``{"x": [B, H, W, C],
    "y": [B] int}``, NHWC as the data planes yield them; :meth:`prepare_x`
    turns ``x`` into the compute dtype and the NCHW view the layers take
    (token batches, integer ``x``, pass as they are).

    Auxiliary heads (GoogLeNet's): :meth:`apply_net` returns
    their logits beside the main ones in training, and ``loss_fn`` adds
    each head's cross entropy at ``aux_loss_weight`` before ``l2``; the
    models without heads return none, and their loss is unchanged."""

    #: weight on auxiliary-head losses (train-time only; GoogLeNet paper §5)
    aux_loss_weight = 0.3

    def __init__(self, config=None):
        super().__init__(config)
        self.net, self.in_shape = self.build_net()

    def build_net(self):
        raise NotImplementedError

    def init_params(self, gen):
        params, state, _ = self.net.init_stateful(gen, self.in_shape)
        return params, state

    def apply_net(self, params, state, x, train: bool, gen=None):
        """-> (logits, aux_logits, new_state): ``aux_logits`` a tuple of
        the auxiliary heads' logits (empty here; GoogLeNet's with
        ``aux=True`` in training)."""
        logits, new_state = self.net.apply_stateful(params, state, x, train,
                                                    gen)
        return logits, (), new_state

    def prepare_x(self, x):
        """A batch's ``x`` on the device, as the reference's
        ``prepare_x``: uint8 images (they cross to the card as bytes, 4x
        fewer than fp32) are cast to the compute dtype and normalized with
        the dataset's ``norm_stats`` (mean, 1/std) in it; other floating
        ``x`` is cast; integer ``x`` (tokens) stays as it is.  A 4-D
        (NHWC) image batch is then permuted to NCHW, a view in
        ``channels_last`` memory, the layout cuDNN's NHWC convolutions
        read."""
        if x.dtype == torch.uint8:
            stats = getattr(self.data, "norm_stats", None)
            x = x.to(self.precision.compute_dtype)
            if stats is not None:
                mean, inv_std = (torch.as_tensor(s, dtype=x.dtype,
                                                 device=x.device)
                                 for s in stats)
                x = (x - mean) * inv_std
        elif x.is_floating_point():
            x = x.to(self.precision.compute_dtype)
        if x.ndim == 4 and x.is_floating_point():
            x = x.permute(0, 3, 1, 2)
        return x

    def loss_fn(self, params, state, batch, gen, train: bool):
        """-> (loss, (new_state, metrics ``cost/error/error_top5``)); the
        loss adds the auxiliary heads' cross entropies at
        ``aux_loss_weight``, then ``l2 * |params|^2`` when the config sets
        ``l2``."""
        x = self.prepare_x(batch["x"])
        cp = self.precision.cast_to_compute(params)
        logits, aux_logits, new_state = self.apply_net(
            cp, state, x, train, gen)
        y = batch["y"]
        loss = softmax_cross_entropy(logits, y)
        for a in aux_logits:
            loss = loss + self.aux_loss_weight * softmax_cross_entropy(a, y)
        if self.config.get("l2", 0.0):
            loss = loss + self.config["l2"] * global_sq_norm(params)
        err5 = (top_k_error(logits, y, k=5) if logits.shape[-1] >= 5
                else torch.zeros((), device=logits.device))
        metrics = {"cost": loss.detach(),
                   "error": top_k_error(logits, y, k=1).detach(),
                   "error_top5": err5.detach()}
        return loss, (new_state, metrics)
