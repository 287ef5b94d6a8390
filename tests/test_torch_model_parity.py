"""The port's ``TransformerLM`` serving path against the reference, fp32.

Weights: the reference's ``init_params`` tree converted by
``params_from_jax``; inputs: numpy from a seed, fed to both.  Compared:
full-sequence logits, prefill logits and the K/V written into the paged
pools, several decode steps, and a partial prefill over a cached prefix.

Tolerance: rtol 1e-5 / atol 1e-6 throughout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanompi_tpu.models.transformer_lm import TransformerLM as JaxLM
from theanompi_tpu.serving.kv_cache import PagedKVCache as JaxCache

from theanompi_torch.convert import params_from_jax
from theanompi_torch.models.transformer_lm import TransformerLM
from theanompi_torch.serving.kv_cache import PagedKVCache
from theanompi_torch.tree import tree_leaves_with_path

from conftest import SERVING_TINY

RTOL, ATOL = 1e-5, 1e-6
BS = 4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    jm = JaxLM(dict(SERVING_TINY))
    jp, _ = jm.init_params(jax.random.PRNGKey(3))
    tm = TransformerLM(dict(SERVING_TINY))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


def _caches(jm, n_blocks=12, batch=2):
    cfg = jm.config
    kw = dict(n_layers=cfg["n_layers"], num_blocks=n_blocks, block_size=BS,
              heads=cfg["heads"], head_dim=cfg["dim"] // cfg["heads"],
              max_batch=batch, max_context=cfg["seq_len"])
    return JaxCache.create(**kw), PagedKVCache.create(**kw, device="cpu")


def test_param_trees_line_up(pair):
    _, jp, tm, tp = pair
    mine, _ = tm.init_params(torch.Generator().manual_seed(0))

    def flat(t):
        return {"/".join(p): tuple(x.shape)
                for p, x in tree_leaves_with_path(t)}

    assert flat(mine) == flat(tp)
    assert all(x.dtype == torch.float32
               for _, x in tree_leaves_with_path(tp))


def test_apply_logits(pair):
    jm, jp, tm, tp = pair
    toks = np.random.RandomState(0).randint(0, 61, (2, 32)).astype(np.int32)
    ref = np.asarray(jm.apply_logits(jp, {}, jnp.asarray(toks)))
    got = tm.apply_logits(tp, torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_prefill_logits_pools_and_decode_steps(pair):
    jm, jp, tm, tp = pair
    jc, tc = _caches(jm)
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, 61, 7)
    p_pad = 8
    toks = np.zeros((1, p_pad), np.int32)
    toks[0, :7] = prompt
    row = np.asarray([3, 5], np.int32)
    j_logits, jc = jm.apply_prefill(jp, {}, jc, jnp.asarray(row),
                                    jnp.asarray(toks))
    t_logits, _ = tm.apply_prefill(tp, tc, torch.from_numpy(row),
                                   torch.from_numpy(toks).long())
    np.testing.assert_allclose(t_logits.numpy()[0, :7],
                               np.asarray(j_logits)[0, :7],
                               rtol=RTOL, atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(tc, name).numpy()[:, row],
                                   np.asarray(getattr(jc, name))[:, row],
                                   rtol=RTOL, atol=ATOL)
    # decode: slot 0 continues the prompt, slot 1 is inactive (null table)
    nb = tc.block_tables.shape[1]
    tables = np.zeros((2, nb), np.int32)
    tables[0, :2] = row
    tables[0, 2] = 7  # the next block, for positions 8..11
    tok = int(np.asarray(j_logits)[0, 6].argmax())
    for step in range(5):
        pos = np.asarray([7 + step, 0], np.int32)
        tokens = np.asarray([tok, 0], np.int32)
        jc = jc.with_tables(jnp.asarray(tables))
        jl, jc = jm.apply_decode(jp, {}, jc, jnp.asarray(pos),
                                 jnp.asarray(tokens))
        tc.block_tables = torch.from_numpy(tables)
        tl, _ = tm.apply_decode(tp, tc, torch.from_numpy(pos),
                                torch.from_numpy(tokens).long())
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                   rtol=RTOL, atol=ATOL)
        assert np.isfinite(tl.numpy()).all()
        tok = int(np.asarray(jl)[0].argmax())
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(tc, name).numpy()[:, [3, 5, 7]],
                                   np.asarray(getattr(jc, name))[:, [3, 5, 7]],
                                   rtol=RTOL, atol=ATOL)


def test_prefill_partial_over_cached_prefix(pair):
    jm, jp, tm, tp = pair
    jc, tc = _caches(jm)
    rng = np.random.RandomState(2)
    prompt = rng.randint(0, 61, 11)
    # cache the first two blocks with a full prefill of the 8-token prefix
    pre = prompt[:8].astype(np.int32)[None]
    row = np.asarray([2, 4, 6], np.int32)
    _, jc = jm.apply_prefill(jp, {}, jc, jnp.asarray(row[:2]),
                             jnp.asarray(pre))
    tm.apply_prefill(tp, tc, torch.from_numpy(row[:2]),
                     torch.from_numpy(pre).long())
    # then the 3-token suffix, padded to one block, over the full row
    suffix = np.zeros((1, 4), np.int32)
    suffix[0, :3] = prompt[8:]
    full_row = np.zeros(tc.block_tables.shape[1], np.int32)
    full_row[:3] = row
    suffix_row = row[2:]
    jl, jc = jm.apply_prefill_partial(
        jp, {}, jc, jnp.asarray(suffix_row), jnp.asarray(full_row),
        jnp.asarray(suffix), 8)
    tl, _ = tm.apply_prefill_partial(
        tp, tc, torch.from_numpy(suffix_row), torch.from_numpy(full_row),
        torch.from_numpy(suffix).long(), 8)
    np.testing.assert_allclose(tl.numpy()[0, :3], np.asarray(jl)[0, :3],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tc.k.numpy()[:, 6], np.asarray(jc.k)[:, 6],
                               rtol=RTOL, atol=ATOL)
