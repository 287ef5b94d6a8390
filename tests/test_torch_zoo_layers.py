"""The zoo's layers and loss against the reference's, on the CPU.

The same numpy inputs and weights, made from a seed, go through
``theanompi_tpu.ops`` (NHWC, HWIO kernels) and ``theanompi_torch.ops``
(NCHW, OIHW kernels; 4-D leaves transposed by the converter's rule,
activations permuted at the boundary):

- ``LRN`` (window 3 and 5): output and the input's grad;
- ``ConvTranspose2D``: k=4 s=2 ``"SAME"`` with and without bias, with
  ``C_in != C_out`` and ``C_in == C_out`` (where a layout that swapped in
  and out would still run), k=3 s=2 ``"VALID"`` on an odd size, and k=3
  s=2 ``"SAME"`` (uneven pads): output shape and values, and the grads of
  input, kernel and bias;
- ``LSTM``: output over T and the grads of ``wx``, ``wh``, ``b`` and the
  input; the fused path (ATen's LSTM, what the card runs) against the
  plain loop;
- ``sigmoid_binary_cross_entropy``; the GAN generator's NHWC reshape;
  the new initializers.

Tolerance: rtol 1e-5 / atol 1e-6 in fp32 unless a reason is written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import dcgan as RDCGAN
from theanompi_tpu.ops import layers as RL
from theanompi_tpu.ops.losses import (
    sigmoid_binary_cross_entropy as ref_bce,
)

from theanompi_torch.models.dcgan import _Reshape
from theanompi_torch.ops import initializers as init_lib
from theanompi_torch.ops import layers as L
from theanompi_torch.ops.losses import sigmoid_binary_cross_entropy

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(a, b, what):
    np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("size", [3, 5])
def test_lrn_output_and_grad(size):
    r = np.random.RandomState(size)
    # relu'd activations at the scale AlexNet's first conv gives
    x = np.maximum(r.randn(2, 6, 5, 12) * 20, 0).astype(np.float32)
    g = r.randn(2, 6, 5, 12).astype(np.float32)
    layer = RL.LRN(size=size)
    y, vjp = jax.vjp(lambda a: layer.apply({}, {}, a)[0], jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(g))
    xt = _nchw(x).requires_grad_()
    yt = L.LRN(size=size)({}, xt)
    (gt,) = torch.autograd.grad(yt, xt, _nchw(g))
    _close(_nhwc(yt), y, "output")
    _close(_nhwc(gt), gx, "input grad")


CONV_T = {
    "same-k4-cin3-cout5-bias": dict(cin=3, cout=5, kernel=4, stride=2,
                                    padding="SAME", hw=4, use_bias=True),
    "same-k4-cin4-cout4-nobias": dict(cin=4, cout=4, kernel=4, stride=2,
                                      padding="SAME", hw=5,
                                      use_bias=False),
    "same-k4-cin6-cout2-nobias": dict(cin=6, cout=2, kernel=4, stride=2,
                                      padding="SAME", hw=4,
                                      use_bias=False),
    "valid-k3-s2-odd": dict(cin=3, cout=4, kernel=3, stride=2,
                            padding="VALID", hw=5, use_bias=True),
    # lax pads the dilated input (2, 1): the layer's uneven-pad path
    "same-k3-s2-uneven": dict(cin=2, cout=3, kernel=3, stride=2,
                              padding="SAME", hw=5, use_bias=True),
}


@pytest.mark.parametrize("name", list(CONV_T))
def test_conv_transpose_matches_reference(name):
    c = CONV_T[name]
    r = np.random.RandomState(len(name))
    x = r.randn(2, c["hw"], c["hw"], c["cin"]).astype(np.float32)
    kw = dict(kernel=c["kernel"], stride=c["stride"], padding=c["padding"],
              use_bias=c["use_bias"])
    ref = RL.ConvTranspose2D(c["cout"], **kw)
    params, _, out_shape = ref.init(jax.random.PRNGKey(0),
                                    (c["hw"], c["hw"], c["cin"]))
    params = {k: (r.randn(*v.shape) * 0.5).astype(np.float32)
              for k, v in params.items()}
    y, vjp = jax.vjp(lambda p, a: ref.apply(p, {}, a)[0],
                     jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    g = r.randn(*y.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(g))

    port = L.ConvTranspose2D(c["cout"], **kw)
    tparams, tshape = port.init(torch.Generator(),
                                (c["cin"], c["hw"], c["hw"]))
    assert tshape == (out_shape[2], *out_shape[:2])
    tp = {"w": torch.from_numpy(params["w"].transpose(3, 2, 0, 1).copy())}
    if c["use_bias"]:
        tp["b"] = torch.from_numpy(params["b"])
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in tparams.items()}
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    xt = _nchw(x).requires_grad_()
    yt = port(tp, xt)
    grads = torch.autograd.grad(yt, [xt, *tp.values()], _nchw(g))
    _close(_nhwc(yt), y, "output")
    _close(_nhwc(grads[0]), gx, "input grad")
    _close(grads[1].numpy().transpose(2, 3, 1, 0), gp["w"], "kernel grad")
    if c["use_bias"]:
        _close(grads[2].numpy(), gp["b"], "bias grad")


def _lstm_case(seed=0, b=3, t=7, d=5, h=6):
    r = np.random.RandomState(seed)
    x = r.randn(b, t, d).astype(np.float32)
    params = {"wx": (r.randn(d, 4 * h) * 0.4).astype(np.float32),
              "wh": (r.randn(h, 4 * h) * 0.4).astype(np.float32),
              "b": (r.randn(4 * h) * 0.3).astype(np.float32)}
    g = r.randn(b, t, h).astype(np.float32)
    return x, params, g


def test_lstm_output_and_grads_over_t():
    x, params, g = _lstm_case()
    layer = RL.LSTM(hidden=6)
    y, vjp = jax.vjp(lambda p, a: layer.apply(p, {}, a)[0],
                     jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    port = L.LSTM(hidden=6)
    shapes = {k: tuple(v.shape) for k, v in port.init(
        torch.Generator(), (7, 5))[0].items()}
    assert shapes == {k: v.shape for k, v in params.items()}
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    yt = port(tp, xt)
    grads = torch.autograd.grad(yt, [xt, *tp.values()], torch.from_numpy(g))
    _close(yt.detach().numpy(), y, "output")
    _close(grads[0].numpy(), gx, "input grad")
    for k, gt in zip(tp, grads[1:]):
        _close(gt.numpy(), gp[k], f"{k} grad")


def test_lstm_fused_matches_the_loop():
    """ATen's LSTM with the reference's leaves (transposed, the forget
    bias built in the layer) is the plain loop's recurrence: the gate
    order and the bias split the layer relies on."""
    x, params, g = _lstm_case(seed=1, b=4, t=9, d=7, h=5)
    outs = []
    for fn in (L.lstm_loop, L.lstm_fused):
        tp = [torch.from_numpy(params[k]).requires_grad_()
              for k in ("wx", "wh", "b")]
        xt = torch.from_numpy(x).requires_grad_()
        y = fn(xt, *tp)
        outs.append([y.detach()] + list(torch.autograd.grad(
            y, [xt, *tp], torch.from_numpy(g))))
    for what, a, b in zip(("output", "x", "wx", "wh", "b"), *outs):
        _close(b.numpy(), a.numpy(), what)


def test_sigmoid_binary_cross_entropy():
    r = np.random.RandomState(3)
    logits = (r.randn(16, 1) * 4).astype(np.float32)
    for targets in (np.ones_like(logits), np.zeros_like(logits),
                    r.rand(16, 1).astype(np.float32)):
        want = float(ref_bce(jnp.asarray(logits), jnp.asarray(targets)))
        got = float(sigmoid_binary_cross_entropy(torch.from_numpy(logits),
                                                 torch.from_numpy(targets)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_generator_reshape_is_the_references_nhwc():
    """Dense output -> spatial map: the port's ``_Reshape`` gives the
    reference's NHWC map in NCHW, so converted Dense columns land on the
    same channels."""
    r = np.random.RandomState(4)
    x = r.randn(2, 4 * 4 * 6).astype(np.float32)
    ref, _ = RDCGAN._Reshape((4, 4, 6)).apply({}, {}, jnp.asarray(x))
    layer = _Reshape((4, 4, 6))
    assert layer.init(torch.Generator(), (96,)) == ({}, (6, 4, 4))
    np.testing.assert_array_equal(_nhwc(layer({}, torch.from_numpy(x))),
                                  np.asarray(ref))
    with pytest.raises(ValueError, match="cannot reshape"):
        layer.init(torch.Generator(), (95,))


def test_initializers_of_the_lstm_and_embedding():
    gen = torch.Generator().manual_seed(0)
    u = init_lib.uniform(0.1)(gen, (200, 50))
    assert u.abs().max() <= 0.1 and u.std() > 0.05
    w = init_lib.glorot_uniform(gen, (30, 120))
    limit = (6.0 / 150) ** 0.5
    assert w.abs().max() <= limit and w.abs().max() > 0.9 * limit
    for shape in ((8, 32), (32, 8)):
        q = init_lib.orthogonal()(gen, shape)
        small = min(shape)
        gram = q.T @ q if shape[0] > shape[1] else q @ q.T
        np.testing.assert_allclose(gram.numpy(), np.eye(small), atol=1e-5)
    with pytest.raises(ValueError, match="2 dims"):
        init_lib.orthogonal()(gen, (5,))
