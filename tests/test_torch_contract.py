"""The model contract's ``SupervisedModel.prepare_x`` against the
reference's, on the CPU.

The reference (``theanompi_tpu/models/contract.py:163``) casts uint8 and
floating ``x`` to the compute dtype and keeps integer ``x`` (tokens) as
it is.  A ``SupervisedModel`` over int32 token batches (embedding, flatten,
dense, 7 classes; fp32) on both sides, from the reference's
``init_params`` weights (``params_from_jax``): the loss, the metrics and
every grad leaf, rtol 1e-5 / atol 1e-6.  And the port's ``prepare_x`` on
each kind of ``x``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models.contract import SupervisedModel as JaxSupervised
from theanompi_tpu.ops import layers as JL

from theanompi_torch.convert import params_from_jax, params_to_jax
from theanompi_torch.models.contract import SupervisedModel
from theanompi_torch.ops import layers as L
from theanompi_torch.parallel.trainer import loss_and_grads
from theanompi_torch.tree import tree_leaves_with_path

VOCAB, T, DIM, CLASSES, B = 11, 6, 8, 7, 5
CFG = {"precision": "fp32"}


class _JaxTokens(JaxSupervised):
    def build_data(self):
        return None  # the batch is the test's

    def build_net(self):
        return JL.Sequential(layers=(JL.Embedding(VOCAB, DIM), JL.Flatten(),
                                     JL.Dense(CLASSES))), (T,)


class _Tokens(SupervisedModel):
    def build_data(self):
        return None

    def build_net(self):
        return L.Sequential([L.Embedding(VOCAB, DIM), L.Flatten(),
                             L.Dense(CLASSES)]), (T,)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_int_token_batches_against_the_reference():
    rng = np.random.RandomState(0)
    batch = {"x": rng.randint(0, VOCAB, (B, T)).astype(np.int32),
             "y": rng.randint(0, CLASSES, (B,)).astype(np.int32)}
    jm, tm = _JaxTokens(dict(CFG)), _Tokens(dict(CFG))
    jp, js = jm.init_params(jax.random.PRNGKey(0))

    def lossw(p):
        return jm.loss_fn(p, js, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, None, train=True)

    (loss, (_, jmet)), jg = jax.value_and_grad(lossw, has_aux=True)(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert tm.prepare_x(tb["x"]).dtype == torch.int32
    _, tmet, tg = loss_and_grads(tm, tp, {}, tb, None)
    for k in ("cost", "error", "error_top5"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(tmet["cost"]), float(loss), rtol=1e-5)
    want = {"/".join(p): np.asarray(x) for p, x in tree_leaves_with_path(
        jax.tree.map(np.asarray, jg))}
    mine = {"/".join(p): x for p, x in tree_leaves_with_path(
        params_to_jax(tg))}
    assert mine.keys() == want.keys()
    for k, x in mine.items():
        np.testing.assert_allclose(x, want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_prepare_x_keeps_ints_and_permutes_only_image_batches():
    m = _Tokens({"precision": "bf16"})
    tok = torch.arange(12, dtype=torch.int64).reshape(2, 6)
    assert m.prepare_x(tok) is tok
    flat = torch.ones(2, 6, dtype=torch.float32)
    assert m.prepare_x(flat).dtype == torch.bfloat16
    assert m.prepare_x(flat).shape == (2, 6)
    img = torch.rand(2, 4, 5, 3)
    out = m.prepare_x(img)
    assert out.shape == (2, 3, 4, 5) and out.dtype == torch.bfloat16
    # uint8 images: cast and normalized with the data's (mean, 1/std),
    # then permuted
    m._data = type("D", (), {"norm_stats": (np.full(3, 2.0, np.float32),
                                            np.full(3, 0.5, np.float32))})()
    u8 = torch.full((2, 4, 5, 3), 10, dtype=torch.uint8)
    out = m.prepare_x(u8)
    assert out.shape == (2, 3, 4, 5) and out.dtype == torch.bfloat16
    assert torch.all(out == 4.0)
