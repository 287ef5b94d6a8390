"""The port's DCGAN/WGAN and the custom step against the reference's, on
the CPU, and the zoo through the launcher.

``tests/test_zoo.py``'s tiny GAN (image 32, ``gen_base`` 32, ``disc_base``
16, ``z_dim`` 16, batch 8, fp32; WGAN with ``n_critic`` 2).  The port's
trainer starts from the reference trainer's converted params, state and
optimizer state.  ``z`` comes from JAX keys on one side and a
``torch.Generator`` on the other, so both sides are fed the same draws,
made with numpy: the reference's ``jax.random.normal`` inside its
``dcgan`` module and the port's ``DCGAN.draw_z`` are patched in the test
to return them (each step draws ``z1`` for the discriminator's fakes, then
``z2`` for the generator's).

- DCGAN: one step through both trainers — losses, params, BN state and
  Adam's state after it; WGAN: two steps across the ``n_critic`` gate —
  the critic clipped, the generator updated at step 0 and kept (params and
  RMSProp state) at step 1, its BN state advanced at both;
- the validation loss with the same ``z``;
- the GAN's train state in the reference's checkpoint layout (its keys,
  ``opt_state::gen/...`` and ``opt_state::disc/...``, and values) and
  back;
- the launcher trains a tiny AlexNet and a tiny DCGAN on ``--device
  cpu``, refuses to run without CUDA when no device is asked for, and
  refuses ``n_subb``, ``zero1`` and overlap for the custom step (exit 78).

Tolerance: rtol 1e-5 / atol 1e-6 in fp32 unless a reason is written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import dcgan as RD
from theanompi_tpu.parallel.bsp import BSPTrainer as JaxBSPTrainer
from theanompi_tpu.parallel.mesh import make_mesh
from theanompi_tpu.utils.checkpoint import _leaf_key
from theanompi_tpu.utils.recorder import Recorder as JaxRecorder

from theanompi_torch.convert import (
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
    state_from_jax,
    state_to_jax,
    train_state_from_jax,
    train_state_to_jax,
)
from theanompi_torch.models import dcgan as TD
from theanompi_torch.parallel.bsp import BSPTrainer
from theanompi_torch.tree import tree_leaves_with_path, tree_map
from theanompi_torch.utils.recorder import Recorder

RTOL, ATOL = 1e-5, 1e-6
GAN = {"batch_size": 8, "n_train": 64, "n_val": 16, "image_size": 32,
       "gen_base": 32, "disc_base": 16, "z_dim": 16, "n_epochs": 1,
       "precision": "fp32"}
#: Adam's and RMSProp's first updates are ``lr * g / (|g| + eps)`` up to
#: a constant: each element moves by about ``lr`` whatever its size, so a
#: near-cancelled grad element (1 % apart between the packages' fp32 sums)
#: moves its param by 1 % of ``lr``.  The params are held to ``atol =
#: UPDATE_ATOL * lr`` (measured: 2.1e-6 at lr 2e-4, one element of 8192
#: in the generator's last kernel), and the optimizer states, linear in
#: the grads and their squares, at the grads' scale-relative ``SCALE`` (a
#: leaf's atol ``SCALE * max |leaf|``).
UPDATE_ATOL = 2e-2
SCALE = 1e-5
CASES = {"dcgan": (TD.DCGAN, RD.DCGAN, GAN, 2e-4, 1),
         "wgan": (TD.WGAN, RD.WGAN, {**GAN, "clip": 0.01, "n_critic": 2},
                  5e-5, 2)}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _SameZ:
    """Stands in for ``jax`` inside the reference's ``dcgan`` module:
    ``jax.random.normal`` returns the test's draws in turn, everything
    else is JAX's."""

    def __init__(self, zs):
        self.zs, self.i = zs, 0
        self.random = self

    def normal(self, key, shape, dtype=jnp.float32):
        z = self.zs[self.i % len(self.zs)]
        self.i += 1
        assert z.shape == tuple(shape)
        return jnp.asarray(z, dtype)

    def __getattr__(self, name):
        return getattr(jax.random if name in ("split", "fold_in", "PRNGKey")
                       else jax, name)


@pytest.fixture
def same_z(monkeypatch):
    """-> ``feed(zs)``: both packages draw ``zs`` in turn from now on."""
    def feed(zs):
        monkeypatch.setattr(RD, "jax", _SameZ(zs))
        it = {"i": 0}

        def draw(self, n, device, seed):
            z = zs[it["i"] % len(zs)]
            it["i"] += 1
            assert z.shape == (n, self.config["z_dim"])
            return torch.from_numpy(z).to(device)

        monkeypatch.setattr(TD.DCGAN, "draw_z", draw)

    return feed


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {"/".join(map(str, p)): np.asarray(x)
            for p, x in tree_leaves_with_path(tree)}


def _assert_tree(port, ref, what, scale=0.0, atol=ATOL):
    mine, want = _flat(port), _flat(_np(ref))
    assert mine.keys() == want.keys(), what
    for k, x in mine.items():
        tol = max(atol, scale * float(np.abs(want[k]).max()))
        np.testing.assert_allclose(x, want[k], rtol=RTOL, atol=tol,
                                   err_msg=f"{what} {k}")


def _trainers(name):
    """(reference trainer, port trainer from its converted state)."""
    cls, jcls, cfg, _, _ = CASES[name]
    jt = JaxBSPTrainer(jcls(dict(cfg)),
                       mesh=make_mesh(n_data=1, devices=jax.devices()[:1]),
                       recorder=JaxRecorder(verbose=False))
    jt.compile_iter_fns()
    jt.init_state()
    t = BSPTrainer(cls(dict(cfg)), device="cpu",
                   recorder=Recorder(verbose=False))
    t.compile_iter_fns()
    t.params = params_from_jax(_np(jt.params))
    t.state = state_from_jax(_np(jt.state))
    t.opt_state = opt_state_from_jax(_np(jt.opt_state))
    return jt, t


def _zs(cfg, n, seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(cfg["batch_size"], cfg["z_dim"]).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("name", list(CASES))
def test_gan_steps_with_the_same_z(name, same_z):
    cls, _, cfg, lr, steps = CASES[name]
    jt, t = _trainers(name)
    same_z(_zs(cfg, 2))
    batches = list(jt.model.data.train_batches(jt.global_batch, 0, seed=0))
    gen_before = None
    for i in range(steps):
        jm = jt.train_iter(batches[i], lr)
        tm = t.train_iter(batches[i], lr)
        for k in ("cost", "d_loss", "g_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} {k}")
        _assert_tree(params_to_jax(t.params), jt.params, f"params, step {i}",
                     atol=UPDATE_ATOL * lr)
        _assert_tree(state_to_jax(t.state), jt.state, f"state, step {i}")
        _assert_tree(opt_state_to_jax(t.opt_state), jt.opt_state,
                     f"optimizer state, step {i}", scale=SCALE)
        if name == "wgan":
            for _, p in tree_leaves_with_path(t.params["disc"]):
                assert float(p.abs().max()) <= 0.01
            if i == 1:
                # step 1 % n_critic != 0: the generator and its RMSProp
                # state stay, its BN state moves on
                for a, b in zip(_flat(t.params["gen"]).values(),
                                _flat(gen_before[0]).values()):
                    np.testing.assert_array_equal(a, b)
                for a, b in zip(_flat(t.opt_state["gen"]).values(),
                                _flat(gen_before[1]).values()):
                    np.testing.assert_array_equal(a, b)
                assert not np.array_equal(
                    _flat(t.state["gen"])["02_batchnorm/mean"],
                    _flat(gen_before[2])["02_batchnorm/mean"])
            gen_before = tree_map(torch.clone, [t.params["gen"],
                                                t.opt_state["gen"],
                                                t.state["gen"]])


def test_gan_validation_loss_with_the_same_z(same_z):
    _, jcls, cfg, _, _ = CASES["dcgan"]
    jt, t = _trainers("dcgan")
    same_z(_zs(cfg, 1, seed=3))
    batch = next(iter(jt.model.data.val_batches(cfg["batch_size"])))
    want, _ = jt.model.loss_fn(jt.params, jt.state,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               None, False)
    got = t.val_iter(batch)["cost"]
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_gan_train_state_in_the_references_layout(name):
    """The trainer's checkpoint trees (params, BN state, the two
    optimizer states) -> the reference's flat leaves, keyed and valued as
    the reference trainer's own, and back into the port's templates."""
    jt, t = _trainers(name)
    ref = {f"{tree}::{_leaf_key(p)}": np.asarray(x)
           for tree in ("params", "state", "opt_state")
           for p, x in jax.tree_util.tree_flatten_with_path(
               getattr(jt, tree))[0]}
    mine = train_state_to_jax(t.checkpoint_trees())
    assert mine.keys() == ref.keys()
    assert any(k.startswith("opt_state::gen/") for k in ref)
    assert any(k.startswith("opt_state::disc/") for k in ref)
    assert any("convtranspose2d" in k for k in ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
        assert mine[k].dtype == ref[k].dtype, k
    back = train_state_from_jax(ref, t.checkpoint_trees())
    for tree, got in back.items():
        want = getattr(t, tree)
        for (pa, a), (pb, b) in zip(tree_leaves_with_path(got),
                                    tree_leaves_with_path(want)):
            assert pa == pb
            assert torch.equal(a, b), pa


def _argv(modelfile, modelclass, cfg, *extra):
    argv = ["--modelfile", modelfile, "--modelclass", modelclass,
            "--rule-set", "print_freq=2", *extra]
    for k, v in cfg.items():
        argv += ["--set", f"{k}={v!r}"]
    return argv


TINY_ALEXNET = {"image_size": 64, "n_classes": 11, "batch_size": 4,
                "shard_size": 16, "n_train": 16, "n_val": 8, "n_epochs": 1,
                "precision": "fp32", "lr": 0.01}


def test_launcher_trains_tiny_alexnet_and_dcgan_on_cpu_only_when_asked(
        capsys, monkeypatch):
    from theanompi_torch.launcher import main as launch

    alex = _argv("theanompi_torch.models.alex_net", "AlexNet", TINY_ALEXNET)
    gan = _argv("theanompi_torch.models.dcgan", "DCGAN",
                {**GAN, "n_train": 32, "n_val": 8})
    for argv in (alex, gan):
        assert launch(["--device", "cpu", *argv]) == 0
        out = capsys.readouterr().out
        assert "iter 4:" in out and "tmlauncher: done. final val:" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (alex, gan):
        assert launch(argv) == 70
        assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("extra,words", [
    (["--set", "n_subb=2"], "n_subb=2 requires the standard grad step"),
    (["--rule-set", "exch_strategy=zero1"],
     "'zero1' requires the standard grad step"),
    (["--rule-set", "exch_overlap=true", "--rule-set",
      "exch_strategy=psum_bucket"],
     "exch_overlap requires the standard grad step")])
def test_custom_step_refusals_exit_78(extra, words, capsys):
    from theanompi_torch.launcher import main as launch

    argv = _argv("theanompi_torch.models.dcgan", "WGAN",
                 {**GAN, "n_train": 16, "n_val": 8}, *extra)
    assert launch(["--device", "cpu", *argv]) == 78
    err = capsys.readouterr().err
    assert words in err and "WGAN supplies make_custom_step" in err
