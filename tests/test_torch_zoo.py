"""The port's zoo (AlexNet, VGG-16/11, GoogLeNet, the PTB LSTM) against
the reference's, on the CPU.

Tiny configs after ``tests/test_zoo.py``'s (images 32-64, a few classes,
batch 4, fp32, dropout 0), the LSTM at ``test_lstm_one_step``'s widths.
For each:

- the converter's round trip of the reference's param and state trees
  (``params_to_jax(params_from_jax(p)) == p`` leaf for leaf; the port's
  own init has the same keys and shapes);
- from the port's weights (``init_params`` from a seeded generator,
  converted to the reference's layout) and the same batch: logits, loss,
  metrics, every grad leaf and the new BN state of one forward and
  backward against ``jax.value_and_grad`` of the reference's
  ``loss_fn``; then one step through the port's ``BSPTrainer`` against
  the reference's optimizer update from the reference's grads: params and
  state after it.  GoogLeNet with ``aux=True`` adds its heads' losses in
  training (its aux heads' hard-coded ``Dropout(0.7)`` is set to 0 on both
  sides by patching ``_aux_head`` in the test) and drops them in eval;
  the LSTM reports perplexity.

Tolerance: rtol 1e-5 / atol 1e-6 in fp32, the grads' atol scale-relative
(``SCALE``, below).  Each model's init seed (``SEED``) is one whose
forward puts no ReLU input on opposite sides of 0 in the two packages:
at a kink the two fp32 sums (which differ by ~1e-7 relative) can take
opposite signs, and one such flip moves a grad leaf by percents (measured:
one pre-activation of GoogLeNet's inception 3b at 2.1e-7 in the reference
and -3.4e-7 in the port moved the 3a/3b grads 1.4 %; a float64 run sided
with the reference there, with the port at another seed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import googlenet as RG
from theanompi_tpu.models.alex_net import AlexNet as JAlexNet
from theanompi_tpu.models.googlenet import GoogLeNet as JGoogLeNet
from theanompi_tpu.models.lstm import LSTM as JLSTM
from theanompi_tpu.models.vggnet_16 import VGGNet_11_Shallow as JVGG11
from theanompi_tpu.models.vggnet_16 import VGGNet_16 as JVGG16
from theanompi_tpu.ops import layers as RL
from theanompi_tpu.ops import losses as RLoss
from theanompi_tpu.parallel.mesh import Precision as JPrecision

from theanompi_torch.convert import (
    params_from_jax,
    params_to_jax,
    state_from_jax,
    state_to_jax,
)
from theanompi_torch.models import googlenet as TG
from theanompi_torch.models.alex_net import AlexNet
from theanompi_torch.models.googlenet import GoogLeNet
from theanompi_torch.models.lstm import LSTM
from theanompi_torch.models.vggnet_16 import VGGNet_11_Shallow, VGGNet_16
from theanompi_torch.ops import layers as L
from theanompi_torch.parallel.bsp import BSPTrainer
from theanompi_torch.parallel.mesh import Precision
from theanompi_torch.parallel.trainer import loss_and_grads
from theanompi_torch.tree import tree_leaves_with_path, tree_map
from theanompi_torch.utils.helper_funcs import to_device
from theanompi_torch.utils.recorder import Recorder

RTOL, ATOL = 1e-5, 1e-6
LR = 0.01
COMMON = {"batch_size": 4, "n_train": 32, "n_val": 16, "shard_size": 16,
          "n_epochs": 1, "precision": "fp32", "dropout": 0.0}
GNET = {**COMMON, "image_size": 64, "n_classes": 13, "lrn": True}
MODELS = {
    "alexnet": (AlexNet, JAlexNet,
                {**COMMON, "image_size": 64, "n_classes": 11, "lrn": True}),
    "alexnet-grouped": (AlexNet, JAlexNet,
                        {**COMMON, "image_size": 64, "n_classes": 11,
                         "grouped": True}),
    "vgg16": (VGGNet_16, JVGG16,
              {**COMMON, "image_size": 32, "n_classes": 7, "fc_width": 64}),
    "vgg11-bn": (VGGNet_11_Shallow, JVGG11,
                 {**COMMON, "image_size": 32, "n_classes": 7,
                  "fc_width": 64, "bn": True}),
    "googlenet": (GoogLeNet, JGoogLeNet, GNET),
    "googlenet-aux": (GoogLeNet, JGoogLeNet, {**GNET, "aux": True}),
    "googlenet-bn": (GoogLeNet, JGoogLeNet,
                     {**GNET, "bn": True, "batch_size": 8}),
    "lstm": (LSTM, JLSTM, {**COMMON, "batch_size": 8, "n_train": 64,
                           "n_val": 32, "seq_len": 12, "vocab": 50,
                           "hidden": 32, "embed_dim": 32, "n_layers": 2}),
}
#: the port's init seed of each model (see the module doc: kink-free)
SEED = {"alexnet": 0, "alexnet-grouped": 0, "vgg16": 0, "vgg11-bn": 0,
        "googlenet": 0, "googlenet-aux": 0, "googlenet-bn": 0, "lstm": 0}
#: a grad (and update) leaf's atol is ``max(ATOL, SCALE * max |ref
#: leaf|)``: the grads are sums over the whole batch and net, and deep
#: nets' leaves carry fp32 rounding of their largest terms (measured
#: worst: 2.7e-6 of a leaf's largest value).  VGG-11 with BN normalizes 4
#: values a channel at its 1x1 last stage (batch 4), which amplifies fp32
#: rounding as in ``tests/test_torch_convnets.py``'s tiny ResNets
#: (measured: 1.05e-5 of a leaf's largest value).  BN-GoogLeNet sits on
#: kinks: BN centres every pre-activation on 0, so fp32 rounding puts some
#: on the other side of a ReLU or a max-pool tie than exact arithmetic
#: does (measured at this batch: 7 ReLU inputs within 2.4e-5 of 0 change
#: sign and 17 max-pool argmaxes move between the port's fp32 and float64
#: runs; none in the other models), and each such flip moves the grads of
#: the layers below it by percents, differently in each package (measured:
#: 0.40 of a leaf's largest value between the two fp32 runs).  Its direct
#: comparison is therefore at 0.5, and the loss and state, which see no
#: flip, at 1e-4.  Both BN cases are held to the float64 witness
#: (``WITNESS``): the reference and the port, both in float64, agree to
#: ``F64`` (measured 6.8e-13 of a leaf's largest value), and the port's fp32
#: grads are no farther from the reference's float64 grads than the
#: reference's own fp32 grads are.
SCALE = {name: 1e-5 for name in MODELS}
SCALE["vgg11-bn"] = 1e-4
SCALE["googlenet-bn"] = 0.5
#: (loss rtol, state scale) where the default does not hold: see SCALE
FWD_TOL = {"googlenet-bn": (1e-4, 1e-4)}
#: the models held to the float64 witness, and its rtol and leaf scale
WITNESS = ("vgg11-bn", "googlenet-bn")
F64 = 1e-10


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _aux_dropout_off(monkeypatch):
    """GoogLeNet's aux heads hard-code ``Dropout(0.7)``: 0 on both sides,
    so train-mode parity compares the same function."""
    ref_head, port_head = RG.GoogLeNet._aux_head, TG.GoogLeNet._aux_head

    def ref(self):
        return RL.Sequential(tuple(
            RL.Dropout(0.0) if isinstance(x, RL.Dropout) else x
            for x in ref_head(self).layers))

    def port(self):
        return L.Sequential([L.Dropout(0.0) if isinstance(x, L.Dropout)
                             else x for x in port_head(self).layers])

    monkeypatch.setattr(RG.GoogLeNet, "_aux_head", ref)
    monkeypatch.setattr(TG.GoogLeNet, "_aux_head", port)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {"/".join(map(str, p)): np.asarray(x)
            for p, x in tree_leaves_with_path(tree)}


def _assert_tree(port, ref, what, scale=0.0, rtol=RTOL, atol=ATOL):
    """``port`` in the reference's layout (numpy) against ``ref``."""
    mine, want = _flat(port), _flat(_np(ref))
    assert mine.keys() == want.keys(), what
    for k, x in mine.items():
        tol = max(atol, scale * float(np.abs(want[k]).max()))
        np.testing.assert_allclose(x, want[k], rtol=rtol, atol=tol,
                                   err_msg=f"{what} {k}")


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: the reference's
    layers and losses cast to ``jnp.float32`` by name (BN's statistics,
    LRN, the cross entropy), so patched in for their ``jnp`` they run
    wholly in float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _reference_in_float64(monkeypatch, jcls, cfg, tp, ts, batch):
    """The reference's ``loss_fn`` and grads in float64 (``jax_enable_x64``)
    from the port's weights: -> (loss, new state, grads), numpy."""
    with monkeypatch.context() as m, jax.enable_x64(True):
        m.setattr(RL, "jnp", _Float64Numpy())
        m.setattr(RLoss, "jnp", _Float64Numpy())
        jm = jcls(dict(cfg))
        jm.precision = JPrecision(jnp.float64, jnp.float64, jnp.float64)
        p, s = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
                for t in (params_to_jax(tp), state_to_jax(ts)))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, (state, _)), grads = jax.jit(jax.value_and_grad(
            lambda p: jm.loss_fn(p, s, jb, None, train=True),
            has_aux=True))(p)
        return float(loss), _np(state), _np(grads)


def _dist(a, b) -> float:
    """Relative L2 distance of two trees in the reference's layout."""
    fa, fb = _flat(a), _flat(b)
    u = np.concatenate([fa[k].ravel() for k in sorted(fb)]).astype(
        np.float64)
    v = np.concatenate([fb[k].ravel() for k in sorted(fb)]).astype(
        np.float64)
    return float(np.linalg.norm(u - v) / np.linalg.norm(v))


@pytest.mark.parametrize("name", [n for n in MODELS if n != "googlenet-bn"])
def test_convert_round_trip(name):
    """The reference's trees (its init's structure, seeded values)
    through the converter and back, leaf for leaf; the port's init has
    the same keys and shapes."""
    cls, jcls, cfg = MODELS[name]
    shapes = jax.eval_shape(jcls(dict(cfg)).init_params,
                            jax.random.PRNGKey(0))
    r = np.random.RandomState(1)
    jp, js = jax.tree.map(lambda s: r.randn(*s.shape).astype(np.float32),
                          shapes)
    tp, ts = params_from_jax(jp), state_from_jax(js)
    mine_p, mine_s = cls(dict(cfg)).init_params(torch.Generator())
    assert {k: v.shape for k, v in _flat(mine_p).items()} == {
        k: v.shape for k, v in _flat(tp).items()}
    assert _flat(mine_s).keys() == _flat(ts).keys()
    for back, ref in ((params_to_jax(tp), jp), (state_to_jax(ts), js)):
        got, want = _flat(back), _flat(ref)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if name == "lstm":
        # the LSTM's leaves convert now, 2-D as they are
        assert tuple(tp["02_lstm"]["wx"].shape) == jp["02_lstm"]["wx"].shape
    with pytest.raises(KeyError, match="no port layer"):
        params_from_jax({"00_moeffn": {}})


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_grads_and_one_step_against_the_reference(name,
                                                         monkeypatch):
    cls, jcls, cfg = MODELS[name]
    jm, tm = jcls(dict(cfg)), cls(dict(cfg))
    tp, ts = tm.init_params(torch.Generator().manual_seed(SEED[name]))
    jp, js = params_to_jax(tp), state_to_jax(ts)
    batch = next(iter(jm.data.train_batches(cfg["batch_size"], 0, seed=0)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = to_device(batch, "cpu")
    loss_rtol, state_scale = FWD_TOL.get(name, (RTOL, SCALE[name]))

    def lossw(p):
        return jm.loss_fn(p, js, jb, None, train=True)

    (loss, (jstate, jmet)), jg = jax.jit(
        jax.value_and_grad(lossw, has_aux=True))(jp)
    logits = jax.jit(lambda p, x: jm.apply_net(
        p, js, jm.prepare_x(x), train=False, rng=None)[0])(jp, jb["x"])
    with torch.no_grad():
        tlogits = tm.apply_net(tp, ts, tm.prepare_x(tb["x"]), False)[0]
    _assert_tree({"logits": tlogits.numpy()}, {"logits": logits}, "logits",
                 scale=state_scale)
    tstate, tmet, tg = loss_and_grads(tm, tp, ts, tb, None)
    assert tmet.keys() == jmet.keys()
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=loss_rtol, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(float(tmet["cost"]), float(loss),
                               rtol=loss_rtol)
    if name == "lstm":
        np.testing.assert_allclose(float(tmet["perplexity"]),
                                   np.exp(float(tmet["cost"])), rtol=RTOL)
    _assert_tree(params_to_jax(tg), jg, "grad", scale=SCALE[name])
    _assert_tree(state_to_jax(tstate), jstate, "state", scale=state_scale)
    if name in WITNESS:
        # the float64 witness (SCALE's reason): the two packages in
        # float64, then each fp32 run's distance from the reference's
        rloss, rstate, rg = _reference_in_float64(
            monkeypatch, jcls, cfg, tp, ts, batch)
        t64 = cls(dict(cfg))
        t64.precision = Precision(torch.float64)
        s64, m64, g64 = loss_and_grads(
            t64, tree_map(torch.Tensor.double, tp),
            tree_map(torch.Tensor.double, ts), tb, None)
        np.testing.assert_allclose(float(m64["cost"]), rloss, rtol=F64)
        _assert_tree(state_to_jax(s64), rstate, "float64 state", scale=F64,
                     rtol=F64, atol=0.0)
        _assert_tree(params_to_jax(g64), rg, "float64 grad", scale=F64,
                     rtol=F64, atol=0.0)
        assert _dist(params_to_jax(tg), rg) <= _dist(jg, rg)
    if name == "googlenet-aux":
        # the heads' losses join in training only
        eval_loss, _ = jax.jit(lambda p: jm.loss_fn(p, js, jb, None,
                                                   train=False))(jp)
        with torch.no_grad():
            teval, _ = tm.loss_fn(tp, ts, tb, None, train=False)
        np.testing.assert_allclose(float(teval), float(eval_loss), rtol=RTOL)
        assert float(tmet["cost"]) > float(teval)

    # one step: the port's trainer against the reference's update
    jopt = jm.build_optimizer()
    jnew, _ = jopt.update(jg, jopt.init(jp), jp, LR)
    t = BSPTrainer(cls(dict(cfg)), device="cpu",
                   recorder=Recorder(verbose=False))
    t.compile_iter_fns()
    t.params, t.state = tp, ts
    t.opt_state = t.model.init_opt_state(t.optimizer, t.params)
    met = t.train_iter(batch, LR)
    np.testing.assert_allclose(float(met["cost"]), float(loss),
                               rtol=loss_rtol)
    # the update (the params before it are the same on both sides)
    _assert_tree(params_to_jax(tree_map(torch.sub, t.params, tp)),
                 jax.tree.map(lambda a, b: np.asarray(a) - b, jnew, jp),
                 "update of one step", scale=SCALE[name])
    _assert_tree(state_to_jax(t.state), jstate, "state after one step",
                 scale=state_scale)


def test_full_width_param_counts():
    """AlexNet at 224²/1000 near the canonical 61 M params; ``grouped``
    drops exactly the halved fan-in of conv2/4/5 (``tests/test_zoo.py``'s
    numbers)."""
    cfg = {**COMMON, "image_size": 224, "n_classes": 1000}

    def count(model):
        params, _ = model.init_params(torch.Generator())
        return sum(x.numel() for _, x in tree_leaves_with_path(params))

    plain = count(AlexNet(cfg))
    assert 55e6 < plain < 65e6, plain
    assert plain - count(AlexNet({**cfg, "grouped": True})) == 1_413_120
