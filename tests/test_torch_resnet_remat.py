"""ResNet-50's ``remat="save_convs"`` on the CPU: the tiny ResNet-50 of
``tests/test_zoo.py`` (image 32, stages (1, 1, 1, 1), 9 classes, batch 4,
fp32).

- against ``remat="none"`` in the port, from the same weights and batch:
  the loss, every grad and the new BN state of one forward and backward,
  with the last BN scales live (``bn_scale_zero=False``, so every conv
  gets grads) and as built; bit-equal, since the recompute runs the same
  ops on the same inputs;
- two ``BSPTrainer`` steps: the params, the BN running state (moved once
  a step: the recompute's state is dropped) and the losses bit-equal to
  the ``none`` run's;
- against the reference's ``save_convs`` (``tests/test_zoo.py:184-215``'s
  two steps), from its init converted: the losses within rtol 1e-5, the
  params within rtol 1e-5 and an atol of 1e-4 of a leaf's largest value
  (``SCALE`` of ``tests/test_torch_convnets.py``: batch-4 BN over 1x1
  amplifies fp32 rounding, and the reference's own fp32 error against a
  float64 port run is as large), and not below 1e-5: the reference's
  ``save_convs`` is not its ``none`` path bit for bit (its recompute
  reorders reductions; ``tests/test_zoo.py`` holds its two paths at atol
  1e-5, ~3e-6 measured there), while the port's two paths are bit-equal
  (above) and its ``none`` path is held to the reference's, with a
  float64 witness, in ``tests/test_torch_convnets.py``.
"""

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.models.resnet50 import ResNet50 as JaxResNet50
from theanompi_tpu.parallel.bsp import BSPTrainer as JaxBSPTrainer
from theanompi_tpu.parallel.mesh import make_mesh
from theanompi_tpu.utils.recorder import Recorder as JaxRecorder

from theanompi_torch.convert import params_from_jax, params_to_jax
from theanompi_torch.convert import state_from_jax
from theanompi_torch.models.resnet50 import ResNet50
from theanompi_torch.parallel.bsp import BSPTrainer
from theanompi_torch.parallel.trainer import loss_and_grads
from theanompi_torch.tree import tree_leaves_with_path
from theanompi_torch.utils.recorder import Recorder

RTOL, SCALE = 1e-5, 1e-4
#: the reference's own save_convs against its none path
#: (``tests/test_zoo.py:216-218``)
REF_REMAT_ATOL = 1e-5
CFG = {"image_size": 32, "n_classes": 9, "stage_blocks": (1, 1, 1, 1),
       "batch_size": 4, "n_train": 32, "n_val": 16, "shard_size": 16,
       "n_epochs": 1, "precision": "fp32"}
LR = 0.05


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _leaves(tree):
    return {"/".join(map(str, p)): x for p, x in tree_leaves_with_path(tree)}


def _assert_bit_equal(a, b, what):
    a, b = _leaves(a), _leaves(b)
    assert a.keys() == b.keys() and a, what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what} {k}"


def _batch(model):
    b = next(iter(model.data.train_batches(CFG["batch_size"], 0, seed=0)))
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("live", [False, True])
def test_one_step_grads_and_state_equal_none(live):
    out = {}
    for remat in ("none", "save_convs"):
        model = ResNet50({**CFG, "remat": remat, "bn_scale_zero": not live})
        params, state = model.init_params(torch.Generator().manual_seed(1))
        out[remat] = loss_and_grads(model, params, state, _batch(model),
                                    None)
    (s0, m0, g0), (s1, m1, g1) = out["none"], out["save_convs"]
    assert torch.equal(m0["cost"], m1["cost"])
    _assert_bit_equal(g0, g1, "grads")
    _assert_bit_equal(s0, s1, "BN state")
    # every conv got a grad when the branches are live
    if live:
        assert all(float(g.abs().max()) > 0 for g in _leaves(g1).values())


def _port_steps(remat, init=None):
    t = BSPTrainer(ResNet50({**CFG, "remat": remat}), device="cpu",
                   recorder=Recorder(verbose=False))
    t.compile_iter_fns()
    t.init_state()
    if init is not None:
        t.params, t.state = init
        t.opt_state = t.model.init_opt_state(t.optimizer, t.params)
    state0 = t.state
    batches = list(t.model.data.train_batches(t.global_batch, 0, seed=0))
    costs = [float(t.train_iter(batches[i % len(batches)], LR)["cost"])
             for i in range(2)]
    return t, state0, costs


def test_two_trainer_steps_equal_none():
    (a, state0, ca), (b, _, cb) = _port_steps("none"), _port_steps(
        "save_convs")
    assert ca == cb
    _assert_bit_equal(a.params, b.params, "params")
    _assert_bit_equal(a.state, b.state, "BN state")
    # the running state moved (once a step, as the none path's)
    moved = [not torch.equal(x, _leaves(b.state)[k])
             for k, x in _leaves(state0).items()]
    assert any(moved)


def test_two_steps_against_the_reference_save_convs():
    """The reference's two steps under its ``jax.checkpoint`` policy."""
    model = JaxResNet50({**CFG, "remat": "save_convs"})
    jt = JaxBSPTrainer(model, mesh=make_mesh(n_data=1,
                                             devices=jax.devices()[:1]),
                       recorder=JaxRecorder(verbose=False))
    jt.compile_iter_fns()
    jt.init_state()
    init = (params_from_jax(jax.tree.map(np.asarray, jt.params)),
            state_from_jax(jax.tree.map(np.asarray, jt.state)))
    batches = list(model.data.train_batches(jt.global_batch, 0, seed=0))
    jcosts = [float(jt.train_iter(batches[i % len(batches)], LR)["cost"])
              for i in range(2)]
    t, _, costs = _port_steps("save_convs", init)
    np.testing.assert_allclose(costs, jcosts, rtol=RTOL)
    mine = _leaves(params_to_jax(t.params))
    want = {"/".join(map(str, p)): np.asarray(x) for p, x in
            tree_leaves_with_path(jax.tree.map(np.asarray, jt.params))}
    assert mine.keys() == want.keys()
    for k, w in want.items():
        atol = max(REF_REMAT_ATOL, SCALE * float(np.abs(w).max()))
        np.testing.assert_allclose(mine[k], w, rtol=RTOL, atol=atol,
                                   err_msg=k)
