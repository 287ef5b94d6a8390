"""The port's conv-net layers against the reference's, on the CPU.

The same numpy inputs and weights, made from a seed, go through
``theanompi_tpu.ops.layers`` (NHWC, HWIO kernels) and
``theanompi_torch.ops.layers`` (NCHW, OIHW kernels; kernels transposed,
activations permuted at the boundary):

- ``Conv2D`` with ``"SAME"`` at stride 1 and 2 on even and odd sizes
  (asymmetric pads included), ``"VALID"``, int and pair padding, groups
  2, dilation 2, with and without bias;
- ``MaxPool``/``AvgPool`` with ``"SAME"``, ``"VALID"`` and int padding at
  stride 2 on even and odd sizes; ``GlobalAvgPool``, ``Flatten`` and every
  ``Activation``;
- ``BatchNorm`` in train (output and new state) and eval, and in bf16
  against the port's own fp32;
- grads against ``jax.grad`` for conv, BN and both pools;
- ``Sequential``'s keys, output and state; the OIHW fans of the
  initializers.

Tolerance: rtol 1e-5 / atol 1e-6 in fp32 unless a reason is written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.ops import layers as RL

from theanompi_torch.ops import initializers as init_lib
from theanompi_torch.ops import layers as L

RTOL, ATOL = 1e-5, 1e-6
KEY = jax.random.PRNGKey(0)


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


def _random_like(tree, seed):
    """The reference's param tree with seeded gaussian values (its
    initializers leave biases at zero, which would test nothing)."""
    r = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: r.randn(*a.shape).astype(np.float32) * 0.5, tree)


def _port_params(ref):
    """A reference layer's params -> the port's (HWIO -> OIHW)."""
    return {k: torch.from_numpy(np.array(
        np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v))
        for k, v in ref.items()}


CONV_CASES = {
    "same-s1-even": dict(kernel=3, stride=1, padding="SAME", hw=8),
    "same-s2-even": dict(kernel=3, stride=2, padding="SAME", hw=8),
    "same-s2-odd": dict(kernel=3, stride=2, padding="SAME", hw=9),
    "same-k4-s1-odd": dict(kernel=4, stride=1, padding="SAME", hw=7),
    "valid-s2": dict(kernel=3, stride=2, padding="VALID", hw=9),
    "int-pad": dict(kernel=5, stride=1, padding=2, hw=8),
    "pairs": dict(kernel=3, stride=2, padding=((1, 0), (2, 1)), hw=8),
    "groups2-nobias": dict(kernel=3, stride=1, padding="SAME", hw=8,
                           groups=2, use_bias=False),
    "dilation2": dict(kernel=3, stride=1, padding="SAME", hw=9, dilation=2),
}


def _conv_pair(case):
    cfg = dict(CONV_CASES[case])
    hw = cfg.pop("hw")
    ref = RL.Conv2D(6, **cfg)
    mine = L.Conv2D(6, **cfg)
    c = 4
    rp, _, rshape = ref.init(KEY, (hw, hw, c))
    rp = _random_like(rp, 1)
    x = np.random.RandomState(2).randn(2, hw, hw, c).astype(np.float32)
    return ref, mine, rp, rshape, x, (c, hw, hw)


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_reference(case):
    ref, mine, rp, rshape, x, in_shape = _conv_pair(case)
    y_ref, _ = ref.apply(rp, {}, jnp.asarray(x))
    tp, tshape = mine.init(torch.Generator().manual_seed(0), in_shape)
    assert tshape == (rshape[2], rshape[0], rshape[1])
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in _port_params(rp).items()}
    y = mine(_port_params(rp), _nchw(x))
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_ref), rtol=RTOL,
                               atol=ATOL)


POOLS = [(kind, padding, hw) for kind in ("MaxPool", "AvgPool")
         for padding in ("SAME", "VALID", 1) for hw in (8, 9)]


def test_pools_match_reference():
    x = np.random.RandomState(3).randn(2, 9, 9, 5).astype(np.float32)
    for kind, padding, hw in POOLS:
        ref = getattr(RL, kind)(3, stride=2, padding=padding)
        mine = getattr(L, kind)(3, stride=2, padding=padding)
        xi = x[:, :hw, :hw]
        y_ref, _ = ref.apply({}, {}, jnp.asarray(xi))
        _, _, rshape = ref.init(KEY, xi.shape[1:])
        _, tshape = mine.init(None, (5, hw, hw))
        assert tshape == (rshape[2], rshape[0], rshape[1]), (kind, padding)
        np.testing.assert_allclose(_nhwc(mine({}, _nchw(xi))),
                                   np.asarray(y_ref), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{kind} {padding} {hw}")


def test_global_pool_flatten_and_every_activation():
    x = np.random.RandomState(4).randn(3, 5, 7, 4).astype(np.float32)
    for ref, mine in ((RL.GlobalAvgPool(), L.GlobalAvgPool()),
                      (RL.Flatten(), L.Flatten())):
        y_ref, _ = ref.apply({}, {}, jnp.asarray(x))
        assert mine.init(None, (4, 5, 7))[1] == ref.init(KEY, (5, 7, 4))[2]
        np.testing.assert_allclose(mine({}, _nchw(x)).numpy(),
                                   np.asarray(y_ref), rtol=RTOL, atol=ATOL)
    assert set(L.ACTIVATIONS) == set(RL.ACTIVATIONS)
    for kind in RL.ACTIVATIONS:
        y_ref, _ = RL.Activation(kind).apply({}, {}, jnp.asarray(x))
        np.testing.assert_allclose(
            L.Activation(kind)({}, torch.from_numpy(x)).numpy(),
            np.asarray(y_ref), rtol=RTOL, atol=ATOL, err_msg=kind)
    with pytest.raises(ValueError, match="activation"):
        L.Activation("swish")


def _bn_inputs(seed=5):
    r = np.random.RandomState(seed)
    x = (r.randn(4, 6, 6, 8) * 2 - 0.5).astype(np.float32)
    params = {"scale": r.randn(8).astype(np.float32),
              "bias": r.randn(8).astype(np.float32)}
    state = {"mean": r.randn(8).astype(np.float32),
             "var": r.rand(8).astype(np.float32) + 0.5}
    return x, params, state


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_batchnorm_train_and_eval_match_reference():
    x, params, state = _bn_inputs()
    ref, mine = RL.BatchNorm(), L.BatchNorm()
    _, rstate, _ = ref.init(KEY, (6, 6, 8))
    tp, tstate, tshape = mine.init_stateful(torch.Generator(), (8, 6, 6))
    assert tshape == (8, 6, 6)
    for k in ("mean", "var"):
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(rstate[k]))
    for train in (True, False):
        y_ref, s_ref = ref.apply(params, state, jnp.asarray(x), train=train)
        y, s = mine.apply_stateful(_t(params), _t(state), _nchw(x), train)
        np.testing.assert_allclose(_nhwc(y), np.asarray(y_ref), rtol=RTOL,
                                   atol=ATOL, err_msg=f"train={train}")
        for k in ("mean", "var"):
            np.testing.assert_allclose(s[k].numpy(), np.asarray(s_ref[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
            assert not s[k].requires_grad
    # sync-BN at one process: the mean over a group of one, bit for bit
    sync = L.BatchNorm(axis_name="data")
    y, s = mine.apply_stateful(_t(params), _t(state), _nchw(x), True)
    ys, ss = sync.apply_stateful(_t(params), _t(state), _nchw(x), True)
    assert torch.equal(y, ys) and all(torch.equal(s[k], ss[k]) for k in s)
    with pytest.raises(ValueError, match="one axis"):
        L.BatchNorm(axis_name="model")
    with pytest.raises(TypeError, match="carries state"):
        mine(_t(params), _nchw(x))


def _grad_case(name):
    """-> (reference fn of (x, params), port fn of (x, params), x, params),
    the port fn taking NCHW and the port's param layout."""
    r = np.random.RandomState(6)
    if name == "conv":
        ref, mine, rp, _, x, _ = _conv_pair("same-s2-odd")
        return (lambda xx, p: ref.apply(p, {}, xx)[0],
                lambda xx, p: mine(p, xx), x, rp)
    if name == "batchnorm":
        x, params, state = _bn_inputs(7)
        return (lambda xx, p: RL.BatchNorm().apply(p, state, xx,
                                                   train=True)[0],
                lambda xx, p: L.BatchNorm().apply_stateful(
                    p, _t(state), xx, True)[0], x, params)
    x = r.randn(2, 9, 9, 3).astype(np.float32)
    kind = {"maxpool": "MaxPool", "avgpool": "AvgPool"}[name]
    ref = getattr(RL, kind)(3, stride=2, padding="SAME")
    mine = getattr(L, kind)(3, stride=2, padding="SAME")
    return (lambda xx, p: ref.apply({}, {}, xx)[0],
            lambda xx, p: mine({}, xx), x, {})


@pytest.mark.parametrize("name", ["conv", "batchnorm", "maxpool", "avgpool"])
def test_grads_match_jax_grad(name):
    ref_fn, fn, x, params = _grad_case(name)
    y_ref = np.asarray(ref_fn(jnp.asarray(x), params))
    g = np.random.RandomState(8).randn(*y_ref.shape).astype(np.float32)

    def loss(xx, p):
        return jnp.sum(ref_fn(xx, p) * g)

    gx_ref, gp_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), params)
    xt = _nchw(x).detach().requires_grad_()
    pt = {k: v.requires_grad_() for k, v in _port_params(params).items()}
    (fn(xt, pt) * _nchw(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx_ref),
                               rtol=RTOL, atol=ATOL, err_msg="dx")
    mine = {k: v.grad for k, v in pt.items()}
    for k, v in _port_params({k: np.asarray(v) for k, v in
                              gp_ref.items()}).items():
        np.testing.assert_allclose(mine[k].numpy(), v.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{k}")


def test_batchnorm_bf16_tracks_the_ports_fp32():
    """The mirror of ``tests/test_layers.py``'s bf16 BN check, against the
    port's own fp32 on the same bf16-representable input, with its
    budget: a few bf16 ulps (2^-8) through the fold and the affine,
    measured against ``|y| + std(y)``."""
    bn = L.BatchNorm()
    r = np.random.RandomState(1)
    x32 = _nchw((r.randn(32, 8, 8, 16) * 2 - 0.5).astype(np.float32))
    params, state, _ = bn.init_stateful(torch.Generator(), (16, 8, 8))
    x16 = x32.to(torch.bfloat16)
    y32, s32 = bn.apply_stateful(params, state, x16.float(), True)
    y16, s16 = bn.apply_stateful(params, state, x16, True)
    assert y16.dtype == torch.bfloat16
    err = (y16.float() - y32).abs()
    denom = y32.abs() + y32.std()
    assert float((err / denom).max()) < 0.02, float((err / denom).max())
    # the statistics are fp32 either way: the same numbers
    for k in ("mean", "var"):
        assert s16[k].dtype == torch.float32
        np.testing.assert_allclose(s16[k].numpy(), s32[k].numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_sequential_keys_output_and_state():
    def layers(mod):
        return [mod.Conv2D(4, 3, stride=2), mod.BatchNorm(),
                mod.Activation("relu"), mod.MaxPool(2), mod.Flatten(),
                mod.Dense(5)]

    ref = RL.Sequential(tuple(layers(RL)))
    mine = L.Sequential(layers(L))
    rp, rs, rshape = ref.init(KEY, (9, 9, 3))
    rp = jax.tree.map(np.asarray, rp)
    rp["00_conv2d"] = _random_like(rp["00_conv2d"], 9)
    rs = jax.tree.map(np.asarray, rs)
    tp, ts, tshape = mine.init_stateful(torch.Generator().manual_seed(0),
                                        (3, 9, 9))
    assert tshape == rshape == (5,)
    assert list(tp) == list(rp) == ["00_conv2d", "01_batchnorm", "05_dense"]
    assert list(ts) == list(rs) == ["01_batchnorm"]
    x = np.random.RandomState(10).randn(3, 9, 9, 3).astype(np.float32)
    y_ref, s_ref = ref.apply(rp, rs, jnp.asarray(x), train=True)
    port = {k: _port_params(v) for k, v in rp.items()}
    y, s = mine.apply_stateful(port, {"01_batchnorm": _t(rs["01_batchnorm"])},
                               _nchw(x), True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=RTOL, atol=ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(s["01_batchnorm"][k].numpy(),
                                   np.asarray(s_ref["01_batchnorm"][k]),
                                   rtol=RTOL, atol=ATOL)


def test_fans_read_oihw_and_he_normal_scale():
    assert init_lib._fans((64, 3, 7, 7)) == (3 * 49, 64 * 49)
    assert init_lib._fans((512, 1000)) == (512, 1000)
    w = init_lib.he_normal(torch.Generator().manual_seed(0), (256, 64, 3, 3))
    np.testing.assert_allclose(float(w.std()), np.sqrt(2.0 / (64 * 9)),
                               rtol=0.02)
