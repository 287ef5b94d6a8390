"""DCGAN and WGAN on CIFAR-10-shaped images: a generator of transposed
convolutions and a strided-convolution discriminator (critic), trained
by a two-optimizer step inside the BSP rule.

Counterpart of ``theanompi_tpu/models/dcgan.py`` (``DCGAN`` :31,
``_Reshape`` :258, ``WGAN`` :281), with its param and state trees
(``gen``, ``disc``, each a Sequential's; the optimizer state ``{"gen":
..., "disc": ...}``) and config.  DCGAN trains with Adam (``b1=0.5``),
WGAN (``wgan=True``) with RMSProp, the critic's weights clipped to
``[-clip, clip]`` after each update and the generator updated every
``n_critic``-th step.

The model owns its step (:meth:`DCGAN.make_custom_step`, the reference's
:169-251); the rule still owns the metrics' and the state's mean over the
ranks.  A step: the generator samples ``z1`` in training mode (its BN
state advances) and, with no graph kept, gives the fakes; the
discriminator's loss runs it on the reals, then on the fakes, each a
batch of its own for BN; its grads are exchanged (tag 0) and it is
updated at ``lr * disc_lr_scale`` (then clipped, under WGAN); the
generator's loss samples ``z2`` from the state after the first sample and
runs the updated discriminator from the state its own pass left (that
pass's new discriminator state is dropped); its grads are exchanged (tag
1) and it is updated (under WGAN, only at ``step % n_critic == 0``: at the
other steps the params and the optimizer state stay, and its backward and
exchange are not run, since their result would be dropped).  ``z`` is
drawn on the batch's device from a generator seeded by the run's seed,
the step and the rank; :meth:`DCGAN.gan_step` takes it as an argument,
which is how the tests feed both packages the same ``z``.
"""

from __future__ import annotations

import math

import torch

from theanompi_torch.models.contract import Model
from theanompi_torch.models.data.base import derive_seed
from theanompi_torch.models.data.cifar10 import Cifar10Data
from theanompi_torch.ops import layers as L
from theanompi_torch.ops.initializers import normal
from theanompi_torch.ops.losses import sigmoid_binary_cross_entropy
from theanompi_torch.ops.opt import Adam, RMSProp
from theanompi_torch.parallel.mesh import replica_key
from theanompi_torch.parallel.trainer import value_and_grads
from theanompi_torch.tree import tree_map


class _Reshape(L.Layer):
    """The generator's stem: a dense output to a spatial map.  The
    reference reshapes to NHWC ``(h, w, c)``; the port does the same and
    permutes to NCHW, so the dense columns, converted as they are, land
    on the reference's channels (the mirror of
    :class:`~theanompi_torch.ops.layers.Flatten`)."""

    def __init__(self, shape):
        super().__init__()
        self.target = tuple(shape)

    def init(self, gen, in_shape):
        if math.prod(in_shape) != math.prod(self.target):
            raise ValueError(f"cannot reshape {in_shape} -> {self.target}")
        h, w, c = self.target
        return {}, (c, h, w)

    def forward(self, params, x):
        return x.reshape(x.shape[0], *self.target).permute(0, 3, 1, 2)


class DCGAN(Model):
    """Generator/discriminator pair on CIFAR-10-shaped images."""

    default_config = {
        "batch_size": 64,
        "n_epochs": 25,
        "lr": 2e-4,
        "z_dim": 100,
        "gen_base": 128,    # channels at the 4x4 stage
        "disc_base": 64,
        "image_size": 32,
        "wgan": False,
        "clip": 0.01,       # WGAN critic weight clip
        "n_critic": 5,      # WGAN critic steps per generator step
        # two-timescale update rule (TTUR): the discriminator trains at
        # lr * disc_lr_scale
        "disc_lr_scale": 1.0,
        "augment": False,   # GAN training uses raw images
        "normalize": "tanh",  # reals in [-1,1], matching the tanh generator
    }

    def __init__(self, config=None):
        super().__init__(config)
        s = self.config["image_size"]
        if s % 8 != 0:
            raise ValueError(f"image_size must be divisible by 8, got {s}")
        self.gen, self.disc = self._build_pair()

    def build_data(self):
        return Cifar10Data(self.config)

    def build_optimizer(self):
        if self.config["wgan"]:
            return RMSProp()  # WGAN paper
        return Adam(b1=0.5)   # DCGAN paper

    def adjust_hyperp(self, epoch: int) -> float:
        return self.config.get("lr", 5e-5 if self.config["wgan"] else 2e-4)

    # -- nets ----------------------------------------------------------------
    def _build_pair(self):
        cfg = self.config
        gb, db = cfg["gen_base"], cfg["disc_base"]
        s4 = cfg["image_size"] // 8  # spatial size at the deepest stage
        w02 = normal(0.02)           # DCGAN-paper init
        gen = L.Sequential([
            L.Dense(s4 * s4 * gb * 2, w_init=w02),
            _Reshape((s4, s4, gb * 2)),
            L.BatchNorm(),
            L.Activation("relu"),
            L.ConvTranspose2D(gb, 4, stride=2, w_init=w02, use_bias=False),
            L.BatchNorm(),
            L.Activation("relu"),
            L.ConvTranspose2D(gb // 2, 4, stride=2, w_init=w02,
                              use_bias=False),
            L.BatchNorm(),
            L.Activation("relu"),
            L.ConvTranspose2D(3, 4, stride=2, w_init=w02),
            L.Activation("tanh"),
        ])
        disc = L.Sequential([
            L.Conv2D(db, 4, stride=2, w_init=w02),
            L.Activation("leaky_relu"),
            L.Conv2D(db * 2, 4, stride=2, w_init=w02, use_bias=False),
            L.BatchNorm(),
            L.Activation("leaky_relu"),
            L.Conv2D(db * 4, 4, stride=2, w_init=w02, use_bias=False),
            L.BatchNorm(),
            L.Activation("leaky_relu"),
            L.Flatten(),
            L.Dense(1, w_init=w02),
        ])
        return gen, disc

    # -- contract ------------------------------------------------------------
    def init_opt_state(self, optimizer, params):
        return {"gen": optimizer.init(params["gen"]),
                "disc": optimizer.init(params["disc"])}

    def init_params(self, gen):
        cfg = self.config
        s = cfg["image_size"]
        gp, gs, _ = self.gen.init_stateful(gen, (cfg["z_dim"],))
        dp, ds, _ = self.disc.init_stateful(gen, (3, s, s))
        return {"gen": gp, "disc": dp}, {"gen": gs, "disc": ds}

    def prepare_x(self, x):
        """The reals (NHWC, in [-1, 1]) in the compute dtype, as NCHW."""
        return x.to(self.precision.compute_dtype).permute(0, 3, 1, 2)

    def draw_z(self, n: int, device, seed: int):
        """``[n, z_dim]`` standard normal draws in the compute dtype."""
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        return torch.randn((n, self.config["z_dim"]), generator=g,
                           device=device).to(self.precision.compute_dtype)

    def _sample(self, gen_params, gen_state, z, train):
        return self.gen.apply_stateful(gen_params, gen_state, z, train)

    def _d_loss(self, disc_params, disc_state, real, fake, train):
        s_real, ns = self.disc.apply_stateful(disc_params, disc_state, real,
                                              train)
        s_fake, ns = self.disc.apply_stateful(disc_params, ns, fake, train)
        if self.config["wgan"]:
            # the critic maximizes the gap
            loss = s_fake.float().mean() - s_real.float().mean()
        else:
            loss = (sigmoid_binary_cross_entropy(s_real,
                                                 torch.ones_like(s_real))
                    + sigmoid_binary_cross_entropy(
                        s_fake, torch.zeros_like(s_fake)))
        return loss, ns

    def _g_loss(self, gen_params, states, disc_params, z, train):
        fake, new_gs = self._sample(gen_params, states["gen"], z, train)
        s_fake, new_ds = self.disc.apply_stateful(disc_params, states["disc"],
                                                  fake, train)
        if self.config["wgan"]:
            loss = -s_fake.float().mean()
        else:
            loss = sigmoid_binary_cross_entropy(s_fake,
                                                torch.ones_like(s_fake))
        return loss, (new_gs, new_ds)

    def eval_loss(self, params, state, real, z):
        """The discriminator's loss on (reals, the generator's fakes from
        ``z``), both nets in eval mode."""
        cp = self.precision.cast_to_compute(params)
        fake, _ = self._sample(cp["gen"], state["gen"], z, False)
        loss, _ = self._d_loss(cp["disc"], state["disc"], real, fake, False)
        return loss

    def loss_fn(self, params, state, batch, gen, train: bool):
        """Validation's loss: :meth:`eval_loss` with ``z`` drawn from seed
        0 (the trainer trains through :meth:`make_custom_step`)."""
        real = self.prepare_x(batch["x"])
        z = self.draw_z(real.shape[0], real.device, 0)
        loss = self.eval_loss(params, state, real, z)
        return loss, (state, {"cost": loss.detach()})

    # -- the two-optimizer step ----------------------------------------------
    def gan_step(self, optimizer, params, state, opt_state, real, z1, z2,
                 lr, step, exchange=None):
        """One step from ``real`` (NCHW, compute dtype) and the draws
        ``z1`` (the discriminator's fakes) and ``z2`` (the generator's) ->
        (new params, new state, new optimizer state, metrics).
        ``exchange(grads, tag)`` mean-reduces grads over the ranks (None:
        one process)."""
        cfg = self.config
        cast = self.precision.cast_to_compute
        exchange = exchange or (lambda g, tag: g)

        # discriminator/critic step, the generator frozen
        with torch.no_grad():
            fake, gen_state = self._sample(cast(params["gen"]), state["gen"],
                                           z1, True)
        d_loss, disc_state, d_grads = value_and_grads(
            lambda dp: self._d_loss(cast(dp), state["disc"], real, fake,
                                    True), params["disc"])
        with torch.no_grad():
            d_grads = exchange(d_grads, 0)
            new_disc, new_dopt = optimizer.update(
                d_grads, opt_state["disc"], params["disc"],
                lr * cfg["disc_lr_scale"])
            if cfg["wgan"]:
                c = cfg["clip"]
                new_disc = tree_map(lambda p: p.clamp(-c, c), new_disc)

        # generator step through the (frozen) updated discriminator
        states = {"gen": gen_state, "disc": disc_state}

        def g_obj(gp):
            loss, (gs, _) = self._g_loss(cast(gp), states, cast(new_disc),
                                         z2, True)
            return loss, gs

        if cfg["wgan"] and step % cfg["n_critic"] != 0:
            # the generator keeps its params and optimizer state
            with torch.no_grad():
                g_loss, gen_state2 = g_obj(params["gen"])
            new_gen, new_gopt = params["gen"], opt_state["gen"]
        else:
            g_loss, gen_state2, g_grads = value_and_grads(g_obj, params["gen"])
            with torch.no_grad():
                g_grads = exchange(g_grads, 1)
                new_gen, new_gopt = optimizer.update(
                    g_grads, opt_state["gen"], params["gen"], lr)
        d_loss, g_loss = d_loss.detach(), g_loss.detach()
        return ({"gen": new_gen, "disc": new_disc},
                {"gen": gen_state2, "disc": disc_state},
                {"gen": new_gopt, "disc": new_dopt},
                {"cost": d_loss + g_loss, "d_loss": d_loss, "g_loss": g_loss})

    def make_custom_step(self, optimizer, seed: int, exchanger=None):
        """The trainer's inner step: ``step(params, state, opt_state,
        batch, lr, step) -> (new params, new state, new optimizer state,
        metrics)``, ``z1`` and ``z2`` drawn for this step and rank, the
        grads exchanged by ``exchanger`` (tags 0 and 1 in the seed of its
        stochastic rounding)."""
        def inner(params, state, opt_state, batch, lr, step):
            key = (seed, step, *replica_key())
            real = self.prepare_x(batch["x"])
            b, dev = real.shape[0], real.device
            z1 = self.draw_z(b, dev, derive_seed("gan_z", *key, 1))
            z2 = self.draw_z(b, dev, derive_seed("gan_z", *key, 2))

            def exchange(grads, tag):
                if exchanger is None:
                    return grads
                return exchanger.exchange(
                    grads, seed=derive_seed("exchange", *key, tag))

            return self.gan_step(optimizer, params, state, opt_state, real,
                                 z1, z2, lr, step, exchange)

        return inner


class WGAN(DCGAN):
    """WGAN as its own class."""

    default_config = {**DCGAN.default_config, "wgan": True, "lr": 5e-5}
