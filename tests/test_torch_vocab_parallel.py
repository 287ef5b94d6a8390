"""The vocab-parallel fused LM loss at 4 gloo ranks against the full one
and the reference's, on the CPU.

``fused_lm_xent_vp`` on each rank's quarter of the head's columns (one
module-scoped spawn of ``rank_jobs.tp_layer_cases``) against
``fused_lm_xent`` on the whole head in this process and the reference's
``fused_lm_xent_vp`` under ``shard_map`` on a 1x4 ``model`` mesh: the
loss, top-1 and top-5 errors, ``dh`` (summed over the group) and each
rank's ``dw`` and ``db``.  Cases: random scores over three chunks with
padding; ties (every column repeated across the shards, so a gold score
ties with columns of every rank and counts against the model); labels on
the shards' first and last columns.  fp32, rtol 1e-5 / atol 1e-6; the
grads against a floor of 1e-6 of their largest (sums over the ranks'
partials in another order).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from theanompi_tpu.ops.losses import fused_lm_xent_vp as jax_vp
from theanompi_tpu.parallel.mesh import make_mesh, shard_map

from theanompi_torch import dist as tdist
from theanompi_torch.ops.losses import fused_lm_xent, fused_lm_xent_vp
from theanompi_torch.parallel.rank_jobs import run_all

N = 4
RTOL, ATOL = 1e-5, 1e-6
D, V, CHUNK = 8, 64, 16
CASES = ("random", "ties", "edges")


def _inputs(case):
    rng = np.random.RandomState(CASES.index(case))
    n = 40  # three chunks of 16, the last padded
    h = rng.randn(n, D).astype(np.float32)
    w = (0.5 * rng.randn(D, V)).astype(np.float32)
    b = (0.1 * rng.randn(V)).astype(np.float32)
    y = rng.randint(0, V, size=n)
    if case == "ties":
        # column j repeats column j mod 8: each score is shared by eight
        # columns, two on every rank
        w = w[:, np.arange(V) % 8]
        b = np.zeros(V, np.float32)
    if case == "edges":
        v = V // N
        y = np.array([r * v + e for r in range(N) for e in (0, v - 1)]
                     * 5)[:n]
    return {"vp/h": h, "vp/w": w, "vp/b": b, "vp/y": y.astype(np.int64),
            "vp/chunk": np.int64(CHUNK)}


def _full(x):
    """The port's fused_lm_xent on the whole head -> (loss, e1, e5), and
    the grads of the loss against h, w, b."""
    t = {k: torch.tensor(x[f"vp/{k}"], requires_grad=True)
         for k in ("h", "w", "b")}
    loss, e1, e5 = fused_lm_xent(t["h"], t["w"], t["b"],
                                 torch.tensor(x["vp/y"]), chunk_tokens=CHUNK)
    grads = torch.autograd.grad(loss, list(t.values()))
    return ([float(loss.detach()), float(e1), float(e5)],
            {k: g.numpy() for k, g in zip(t, grads)})


def _reference(x):
    """The reference's vocab-parallel loss and its grads on a 1x4 mesh."""
    mesh = make_mesh(n_data=1, n_model=N, devices=jax.devices()[:N])

    def both(h, w, b, y):
        def loss(h, w, b):
            return jax_vp(h, w, b, y, "model", chunk_tokens=CHUNK)

        out = loss(h, w, b)
        return out, jax.grad(lambda *a: loss(*a)[0], argnums=(0, 1, 2))(
            h, w, b)

    f = jax.jit(shard_map(both, mesh,
                          in_specs=(P(), P(None, "model"), P("model"), P()),
                          out_specs=((P(), P(), P()),
                                     (P(), P(None, "model"), P("model")))))
    out, grads = f(x["vp/h"], x["vp/w"], x["vp/b"], x["vp/y"])
    return ([float(v) for v in out],
            {k: np.asarray(g) for k, g in zip(("h", "w", "b"), grads)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("vp")
    calls, inputs = [], {}
    for case in CASES:
        inputs[case] = _inputs(case)
        (d / case).mkdir()
        np.savez(d / case / "in.npz", **inputs[case])
        calls.append(("tp_layer_cases", (str(d / case / "in.npz"),
                                         str(d / case), ("vp",))))
    tdist.spawn(run_all, N, "gloo", "cpu", (calls,), timeout_s=600)
    out = {}
    for case in CASES:
        ranks = [dict(np.load(d / case / f"vp-r{r}.npz")) for r in range(N)]
        out[case] = (inputs[case], ranks, _full(inputs[case]),
                     _reference(inputs[case]))
    return out


def _rank_cols(a, r, axis):
    v = V // N
    return np.take(a, range(r * v, (r + 1) * v), axis=axis)


@pytest.mark.parametrize("case", CASES)
def test_loss_and_errors_equal_the_full_heads(runs, case):
    _, ranks, (full, _), (ref, _) = runs[case]
    for r, got in enumerate(ranks):
        mine = [float(got[k]) for k in ("loss", "e1", "e5")]
        np.testing.assert_allclose(mine, full, rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {r} against the full loss")
        np.testing.assert_allclose(mine, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {r} against the reference")
        # the error rates are counts over 40 tokens: equal, not close
        assert mine[1:] == full[1:]


@pytest.mark.parametrize("case", CASES)
def test_grads_equal_the_full_heads(runs, case):
    _, ranks, (_, full), (_, ref) = runs[case]
    for r, got in enumerate(ranks):
        for k, axis in (("h", None), ("w", 1), ("b", 0)):
            for name, want in (("full", full[k]), ("reference", ref[k])):
                want = want if axis is None else _rank_cols(want, r, axis)
                floor = 1e-6 * float(np.abs(want).max())
                np.testing.assert_allclose(
                    got[f"d_{k}"], want, rtol=RTOL, atol=max(ATOL, floor),
                    err_msg=f"rank {r} d{k} against the {name}")


def test_ties_count_against_the_model(runs):
    """Eight columns share every score: the gold label's rank counts its
    equals on every shard, so every token errs at top-1 and top-5."""
    _, ranks, (full, _), _ = runs["ties"]
    assert full[1] == full[2] == 1.0
    assert all(float(g["e1"]) == float(g["e5"]) == 1.0 for g in ranks)


def test_without_a_model_group_it_is_the_full_loss():
    x = _inputs("random")
    args = [torch.tensor(x[f"vp/{k}"]) for k in ("h", "w", "b", "y")]
    a = fused_lm_xent_vp(*args, chunk_tokens=CHUNK)
    b = fused_lm_xent(*args, chunk_tokens=CHUNK)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
