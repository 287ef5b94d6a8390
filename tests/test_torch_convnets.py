"""The port's conv nets against the reference's, on the CPU.

The tiny ResNet-50 of ``tests/test_zoo.py`` (image 32, stages (1, 1, 1,
1), 9 classes, batch 4, fp32) with the plain 7x7 stem, the same with the
space-to-depth stem and live last BN scales (``bn_scale_zero=False``, so
the branches' convs get grads too), and the tiny Wide-ResNet of
``__graft_entry__._flagship(tiny=True)``.  For each, from the reference's
``init_params`` weights converted (``params_from_jax``/``state_from_jax``)
and the same batch:

- logits, loss, every grad leaf and the new BN state of one forward and
  backward against ``jax.value_and_grad`` of the reference's ``loss_fn``,
  and both sides' grads against a float64 run of the port;
- the port's ``BSPTrainer`` against the reference's one-device
  ``BSPTrainer``: params and state after one step, the losses of three
  steps, then validation on the running state;

and: ``n_subb=2`` against the reference's ``n_subb=2``; the space-to-depth
stem equals ``conv7`` on the same weights; the full-depth param count;
the converters' round trip (and the MoE LM's tree's); the launcher's
``--device cpu`` run.

Tolerance: rtol 1e-5 / atol 1e-6 in fp32 unless a reason is written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models.resnet50 import ResNet50 as JaxResNet50
from theanompi_tpu.models.wide_resnet import WideResNet as JaxWRN
from theanompi_tpu.parallel.bsp import BSPTrainer as JaxBSPTrainer
from theanompi_tpu.parallel.mesh import make_mesh
from theanompi_tpu.utils.recorder import Recorder as JaxRecorder

from theanompi_torch.convert import (
    params_from_jax,
    params_to_jax,
    state_from_jax,
    state_to_jax,
)
from theanompi_torch.models.resnet50 import ResNet50
from theanompi_torch.models.wide_resnet import WideResNet
from theanompi_torch.parallel.bsp import BSPTrainer
from theanompi_torch.parallel.mesh import Precision
from theanompi_torch.parallel.trainer import loss_and_grads
from theanompi_torch.tree import tree_leaves_with_path, tree_map
from theanompi_torch.utils.helper_funcs import to_device
from theanompi_torch.utils.recorder import Recorder

RTOL, ATOL = 1e-5, 1e-6
LR = 0.01
COMMON = {"batch_size": 4, "n_train": 32, "n_val": 16, "shard_size": 16,
          "n_epochs": 1, "precision": "fp32"}
RESNET = {**COMMON, "image_size": 32, "n_classes": 9,
          "stage_blocks": (1, 1, 1, 1)}
#: ``__graft_entry__._flagship(tiny=True)``'s config, with 4 train batches
#: (not 2) so that three steps run
WRN = {"depth": 10, "widen": 1, "batch_size": 8, "image_size": 16,
       "n_train": 32, "n_val": 8, "precision": "fp32"}
MODELS = {
    "resnet50": (ResNet50, JaxResNet50, RESNET),
    "resnet50-s2d-live": (ResNet50, JaxResNet50,
                          {**RESNET, "stem": "space_to_depth",
                           "bn_scale_zero": False}),
    "wrn": (WideResNet, JaxWRN, WRN),
}
#: Loosened for the tiny ResNets: ``|port - ref| <= RTOL |ref| + SCALE *
#: max |ref|`` per leaf.  Their last stage normalizes 4 values a channel
#: (batch 4 at 1x1), which amplifies fp32 rounding, and the reference's
#: own fp32 error is as large: the test holds both to a float64 run of the
#: port, and the port's fp32 grads measured the nearer.  Measured worst, port
#: against reference, of a leaf's largest value: 3.4e-5 (resnet50), 4.3e-4
#: (live branches); the tiny WRN (8 images, 4x4 at its last stage) holds
#: 1.8e-6.
SCALE = {"resnet50": 1e-4, "resnet50-s2d-live": 1e-3, "wrn": 1e-5}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _host(tree):
    return {k: v.detach().numpy() for k, v in tree.items()}


def _assert_tree(port, ref, what, convert=params_to_jax, scale=0.0):
    mine = {"/".join(p): x for p, x in tree_leaves_with_path(convert(port))}
    want = {"/".join(p): x for p, x in tree_leaves_with_path(_np(ref))}
    assert mine.keys() == want.keys(), what
    for k, x in mine.items():
        atol = max(ATOL, scale * float(np.abs(want[k]).max()))
        np.testing.assert_allclose(x, want[k], rtol=RTOL, atol=atol,
                                   err_msg=f"{what} {k}")


def _jax_trainer(cls, cfg):
    model = cls(dict(cfg))
    t = JaxBSPTrainer(model, mesh=make_mesh(n_data=1,
                                            devices=jax.devices()[:1]),
                      recorder=JaxRecorder(verbose=False))
    t.compile_iter_fns()
    t.init_state()
    return t


def _port_trainer(cls, cfg, jt):
    """The port's trainer on the CPU, from the reference trainer's
    (converted) params and state."""
    t = BSPTrainer(cls(dict(cfg)), device="cpu",
                   recorder=Recorder(verbose=False))
    t.compile_iter_fns()
    t.params = params_from_jax(_np(jt.params))
    t.state = state_from_jax(_np(jt.state))
    t.opt_state = t.model.init_opt_state(t.optimizer, t.params)
    return t


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_loss_grads_and_state(name):
    cls, jcls, cfg = MODELS[name]
    jm, tm = jcls(dict(cfg)), cls(dict(cfg))
    jp, js = jm.init_params(jax.random.PRNGKey(1))
    batch = next(iter(jm.data.train_batches(cfg["batch_size"], 0, seed=0)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def lossw(p):
        return jm.loss_fn(p, js, jb, None, train=True)

    (loss, (jstate, jmet)), jg = jax.jit(
        jax.value_and_grad(lossw, has_aux=True))(jp)
    logits, _, _ = jax.jit(lambda p, x: jm.apply_net(
        p, js, jm.prepare_x(x), train=True, rng=None))(jp, jb["x"])
    tp, ts = params_from_jax(_np(jp)), state_from_jax(_np(js))
    tb = to_device(batch, "cpu")
    with torch.no_grad():
        tlogits, _, _ = tm.apply_net(tp, ts, tm.prepare_x(tb["x"]), True)
    _assert_tree({"logits": tlogits}, {"logits": logits}, "logits",
                 convert=_host, scale=SCALE[name])
    tstate, tmet, tg = loss_and_grads(tm, tp, ts, tb, None)
    for k in ("cost", "error", "error_top5"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(float(tmet["cost"]), float(loss), rtol=RTOL)
    _assert_tree(tg, jg, "grad", scale=SCALE[name])
    _assert_tree(tstate, jstate, "state", convert=state_to_jax,
                 scale=SCALE[name])
    # the float64 witness: the port's fp32 grads within twice the
    # reference's fp32 distance from a float64 run of the port (the port's
    # measured nearer in all three)
    t64 = cls(dict(cfg))
    t64.precision = Precision(torch.float64)
    _, _, g64 = loss_and_grads(t64, tree_map(torch.Tensor.double, tp),
                               tree_map(torch.Tensor.double, ts), tb, None)

    def dist(tree):
        a = np.concatenate([x.ravel() for _, x in tree_leaves_with_path(
            _np(tree))]).astype(np.float64)
        b = np.concatenate([x.ravel() for _, x in tree_leaves_with_path(
            params_to_jax(g64))])
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert dist(params_to_jax(tg)) <= 2 * dist(jg), (
        dist(params_to_jax(tg)), dist(jg))


@pytest.mark.parametrize("name", ["resnet50", "wrn"])
def test_steps_and_validation_through_the_trainers(name):
    """One step's params and state, three steps' losses, then validation
    on the running state.  (Not the live-branch ResNet: batch-4 BN over
    1x1 makes its training chaotic, the port's fp32 and float64 losses
    0.1 apart by step 3.)"""
    cls, jcls, cfg = MODELS[name]
    jt = _jax_trainer(jcls, cfg)
    t = _port_trainer(cls, cfg, jt)
    batches = list(jt.model.data.train_batches(jt.global_batch, 0, seed=0))
    for i in range(3):
        jm = jt.train_iter(batches[i], LR)
        tmet = t.train_iter(batches[i], LR)
        np.testing.assert_allclose(float(tmet["cost"]), float(jm["cost"]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"step {i}")
        if i == 0:
            _assert_tree(t.params, jt.params, "params after one step")
            _assert_tree(t.state, jt.state, "state after one step",
                         convert=state_to_jax, scale=SCALE[name])
    jv, tv = jt.validate(0), t.validate(0)
    assert jv.keys() == tv.keys() == {"cost", "error", "error_top5"}
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"val {k}")


@pytest.mark.parametrize("name", ["resnet50", "wrn"])
def test_n_subb_2_against_the_references(name):
    """With BatchNorm a micro-batch's statistics are its own, so
    ``n_subb=2`` differs from the full batch; what holds is the port's
    ``n_subb=2`` against the reference's: the state threaded through the
    two micro-batches in order, the mean grads, the step."""
    cls, jcls, cfg = MODELS[name]
    # micro-batches of 4: the ResNet's 2-image micro-batches at batch 4
    # would normalize 2 values a channel at its 1x1 last stage
    cfg = {**cfg, "n_subb": 2, "batch_size": 8}
    jt = _jax_trainer(jcls, cfg)
    t = _port_trainer(cls, cfg, jt)
    batch = next(iter(jt.model.data.train_batches(jt.global_batch, 0,
                                                  seed=0)))
    jm = jt.train_iter(batch, LR)
    tmet = t.train_iter(batch, LR)
    np.testing.assert_allclose(float(tmet["cost"]), float(jm["cost"]),
                               rtol=RTOL, atol=ATOL)
    _assert_tree(t.params, jt.params, "params", scale=SCALE[name])
    _assert_tree(t.state, jt.state, "state", convert=state_to_jax,
                 scale=SCALE[name])


def test_space_to_depth_stem_equals_conv7():
    plain = ResNet50(dict(RESNET))
    s2d = ResNet50({**RESNET, "stem": "space_to_depth"})
    params, state = plain.init_params(torch.Generator().manual_seed(0))
    p2, s2 = s2d.init_params(torch.Generator().manual_seed(0))
    assert list(params) == ["00_conv2d", *list(params)[1:]]
    assert list(p2)[0] == "00__spacetodepthstem"
    p2 = {"00__spacetodepthstem": params["00_conv2d"],
          **{k: v for k, v in params.items() if k != "00_conv2d"}}
    batch = to_device(next(iter(plain.data.train_batches(4, 0))), "cpu")
    with torch.no_grad():
        x = plain.prepare_x(batch["x"])
        a, _, sa = plain.apply_net(params, state, x, True)
        b, _, sb = s2d.apply_net(p2, state, x, True)
    # the two stems sum in other orders: the tiny ResNet's scale (SCALE)
    _assert_tree({"logits": b}, _host({"logits": a}), "logits",
                 convert=_host, scale=SCALE["resnet50"])
    _assert_tree(sb, state_to_jax(sa), "state", convert=state_to_jax,
                 scale=SCALE["resnet50"])


def test_full_depth_param_count_and_refusals():
    """ResNet-50 at (3, 4, 6, 3) lands near the canonical 25.6 M params
    (``tests/test_zoo.py``'s bounds)."""
    model = ResNet50({**COMMON, "image_size": 64, "n_classes": 1000})
    params, state = model.init_params(torch.Generator().manual_seed(0))
    n = sum(x.numel() for _, x in tree_leaves_with_path(params))
    assert 24e6 < n < 27e6, n
    assert len(tree_leaves_with_path(state)) == 2 * 53  # 53 BNs
    # remat="save_convs" builds (its numerics: test_torch_resnet_remat.py)
    blocks = [b for b in ResNet50({**RESNET, "remat": "save_convs"})
              .net.layers if hasattr(b, "remat")]
    assert [b.remat for b in blocks] == ["save_convs"] * 4
    # sync-BN over the process group ("data") builds; another axis raises
    WideResNet({**WRN, "bn_axis": "data"})
    with pytest.raises(ValueError, match="one axis"):
        WideResNet({**WRN, "bn_axis": "model"})


@pytest.mark.parametrize("name", ["resnet50-s2d-live", "wrn"])
def test_convert_round_trip(name):
    cls, jcls, cfg = MODELS[name]
    jp, js = jcls(dict(cfg)).init_params(jax.random.PRNGKey(2))
    jp, js = _np(jp), _np(js)
    tp, ts = params_from_jax(jp), state_from_jax(js)
    mine_p, mine_s = cls(dict(cfg)).init_params(torch.Generator())
    shapes = {"/".join(p): tuple(x.shape)
              for p, x in tree_leaves_with_path(mine_p)}
    assert shapes == {"/".join(p): tuple(x.shape)
                      for p, x in tree_leaves_with_path(tp)}
    assert [p for p, _ in tree_leaves_with_path(mine_s)] == [
        p for p, _ in tree_leaves_with_path(ts)]
    for back, ref in ((params_to_jax(tp), jp), (state_to_jax(ts), js)):
        for (pa, a), (pb, b) in zip(tree_leaves_with_path(back),
                                    tree_leaves_with_path(ref)):
            assert pa == pb
            np.testing.assert_array_equal(a, b)
    # the MoE LM's tree (its blocks' stacked experts and moe/aux state)
    # round-trips too; a key no port layer carries still raises
    from theanompi_tpu.models.transformer_lm import MoETransformerLM as JaxMoE

    from theanompi_torch.models.transformer_lm import MoETransformerLM

    moe = {"seq_len": 8, "vocab": 16, "dim": 8, "heads": 2, "n_layers": 1,
           "n_experts": 4}
    jp, js = _np(JaxMoE(dict(moe)).init_params(jax.random.PRNGKey(0)))
    tp, ts = params_from_jax(jp), state_from_jax(js)
    mine_p, mine_s = MoETransformerLM(dict(moe)).init_params(
        torch.Generator())
    assert {"/".join(p): tuple(x.shape)
            for p, x in tree_leaves_with_path(mine_p)} == {
        "/".join(p): tuple(x.shape) for p, x in tree_leaves_with_path(tp)}
    assert [p for p, _ in tree_leaves_with_path(mine_s)] == [
        p for p, _ in tree_leaves_with_path(ts)] == [
        ("02__moeblock", "moe", "aux")]
    for back, ref in ((params_to_jax(tp), jp), (state_to_jax(ts), js)):
        for (pa, a), (pb, b) in zip(tree_leaves_with_path(back),
                                    tree_leaves_with_path(ref)):
            assert pa == pb
            np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="no port layer"):
        params_from_jax({"00_nosuchlayer": {}})


def test_launcher_trains_tiny_resnet50_on_cpu_only_when_asked(
        capsys, monkeypatch):
    from theanompi_torch.launcher import main as launch

    argv = ["--modelfile", "theanompi_torch.models.resnet50",
            "--modelclass", "ResNet50", "--rule-set", "print_freq=4",
            "--set", "lr=0.01"]
    for k, v in RESNET.items():
        argv += ["--set", f"{k}={v!r}"]
    assert launch(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert "iter 8:" in out and "tmlauncher: done. final val:" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launch(argv) == 70
    assert "no CUDA device" in capsys.readouterr().err
