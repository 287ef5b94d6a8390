"""Losses and error metrics, and the fused chunked LM cross entropy.

Counterpart of ``theanompi_tpu/ops/losses.py``: ``softmax_cross_entropy``,
``sigmoid_binary_cross_entropy`` (the GAN's), ``top_k_error`` (ties
count against the model: ``>=``), and
``fused_lm_xent``, the LM head matmul fused into a softmax cross entropy
that streams the ``[N, V]`` scores in token chunks and never stores them.
Its forward keeps only the per-token logsumexp; its backward recomputes
each chunk's scores from ``(h, w, b, lse)`` (the reference's custom VJP,
``losses.py:121-163``, here a ``torch.autograd.Function``).
``fused_lm_xent_vp`` is the same function over a vocab-parallel head
(Megatron's parallel cross entropy, the reference's :216-235): each rank
holds ``V / n_model`` of the head's columns, and per chunk three small
all-reduces over the model group assemble the softmax (:70-98): a MAX
for the row max, one SUM of ``(sum e, gold)`` where only the shard that
owns the label adds its gold logit, and one SUM of the tie-aware rank
count.  Its backward offsets the labels to local ids and sums ``dh`` over
the group (:129-157).  One implementation serves both, so the two cannot
diverge.

Scores, ``dh`` and the ``dw``/``db`` accumulators are fp32, as the
reference's ``preferred_element_type=float32`` products make them: the
port upcasts the operands to fp32 before each product (products of bf16
values are exact in fp32, so this is the reference's arithmetic up to sum
order).  A bf16 ``torch.matmul`` would round the scores to bf16, which at
V = 32768 loses most of the lse's digits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from theanompi_torch.parallel import mesh
from theanompi_torch.parallel.tensor import all_reduce


def _wide(x):
    """``x`` in fp32, or as it is where it is wider (a float64 check)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def softmax_cross_entropy(logits, labels):
    """Mean cross entropy over int class ids ``labels`` (``[B]`` or
    ``[B, T]``), computed in fp32 or wider whatever the logits' dtype."""
    logits = _wide(logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def sigmoid_binary_cross_entropy(logits, targets):
    """Mean binary cross entropy on raw logits, in fp32 or wider:
    ``max(l, 0) - l t + log1p(exp(-|l|))``."""
    logits = _wide(logits)
    targets = targets.to(logits.dtype)
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def top_k_error(logits, labels, k: int = 1):
    """Fraction of examples whose label is NOT in the top-k predictions;
    ties score against the model (the label's own logit is excluded by the
    ``- 1``)."""
    gold = logits.gather(-1, labels.long()[..., None])
    rank = (logits >= gold).sum(dim=-1) - 1
    return (rank >= k).float().mean()


def _chunk_and_pad(h, labels, v: int, chunk_tokens: int | None):
    """Flatten, pick the chunk, zero-pad, mask: -> (h3 ``[nc, C, D]``,
    y2 ``[nc, C]`` int64, mask2 ``[nc, C]`` bool, n).  The chunk is
    ``max(256, min(2048, 256 MiB / (4 V)))`` tokens unless given."""
    d = h.shape[-1]
    h2 = h.reshape(-1, d)
    y1 = labels.reshape(-1).long()
    n = h2.shape[0]
    if chunk_tokens is None:
        chunk_tokens = max(256, min(2048, (256 << 20) // max(4 * v, 1)))
    c = max(8, min(n, chunk_tokens))
    nc = -(-n // c)
    pad = nc * c - n
    if pad:
        h2 = torch.cat([h2, h2.new_zeros((pad, d))])
        y1 = torch.cat([y1, y1.new_zeros((pad,))])
    mask = torch.arange(nc * c, device=h.device) < n
    return h2.reshape(nc, c, d), y1.reshape(nc, c), mask.reshape(nc, c), n


def _chunk_scores(hc, wf, bf):
    """One chunk's fp32 scores ``[C, V]`` from the fp32 head ``wf``/``bf``
    (operands upcast, see module doc)."""
    return hc.float() @ wf + bf


def _chunk_stats(s, yc, group, lo: int):
    """-> (lse, gold, rank) of one chunk's scores ``s``.  ``group`` None:
    ``s`` holds the full vocab.  Else ``s`` holds this rank's columns
    ``[lo, lo + V_local)`` and the three all-reduces assemble the
    softmax."""
    if group is None:
        m = s.amax(dim=-1)
        lse = m + torch.log(torch.exp(s - m[:, None]).sum(dim=-1))
        gold = s.gather(1, yc[:, None])[:, 0]
        # >= rank: ties score against the model (top_k_error's rule)
        return lse, gold, (s >= gold[:, None]).sum(dim=-1) - 1
    v = s.shape[-1]
    m = all_reduce(s.amax(dim=-1), group, "vp_max", dist.ReduceOp.MAX)
    e = torch.exp(s - m[:, None])
    y_loc = yc - lo
    mine = (y_loc >= 0) & (y_loc < v)
    gold_loc = s.gather(1, y_loc.clamp(0, v - 1)[:, None])[:, 0]
    gold_loc = torch.where(mine, gold_loc, torch.zeros_like(gold_loc))
    l, gold = all_reduce(torch.stack([e.sum(dim=-1), gold_loc]), group,
                         "vp_sum")
    rank = all_reduce((s >= gold[:, None]).sum(dim=-1), group, "vp_rank")
    return m + torch.log(l), gold, rank - 1


class _LMXent(torch.autograd.Function):
    """-> (loss, top-1 error, top-5 error) over padded chunks; only the
    loss is differentiable (the errors are step functions).  ``group``:
    the model group of a vocab-parallel head (None: the full head)."""

    @staticmethod
    def forward(ctx, h3, w, b, y2, mask2, n, group):
        ls = torch.zeros((), dtype=torch.float32, device=h3.device)
        c1, c5 = ls.clone(), ls.clone()
        lses = []
        wf, bf = w.float(), b.float()
        lo = 0 if group is None else mesh.model_index() * w.shape[-1]
        for hc, yc, mc in zip(h3, y2, mask2):
            lse, gold, rank = _chunk_stats(_chunk_scores(hc, wf, bf), yc,
                                           group, lo)
            mf = mc.float()
            ls = ls + ((lse - gold) * mf).sum()
            c1 = c1 + ((rank >= 1).float() * mf).sum()
            c5 = c5 + ((rank >= 5).float() * mf).sum()
            lses.append(lse)
        ctx.save_for_backward(h3, w, b, y2, mask2, torch.stack(lses))
        ctx.n, ctx.group, ctx.lo = n, group, lo
        e1, e5 = c1 / n, c5 / n
        ctx.mark_non_differentiable(e1, e5)
        return ls / n, e1, e5

    @staticmethod
    def backward(ctx, g_loss, _g1, _g5):
        h3, w, b, y2, mask2, lse2 = ctx.saved_tensors
        g = g_loss.float() / ctx.n
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
        wf, bf = w.float(), b.float()
        dh = []
        v = w.shape[-1]
        for hc, yc, mc, lsec in zip(h3, y2, mask2, lse2):
            p = torch.exp(_chunk_scores(hc, wf, bf) - lsec[:, None])
            # p - onehot(y), the labels offset to this rank's columns (one
            # out of them matches none)
            y_loc = yc - ctx.lo
            mine = ((y_loc >= 0) & (y_loc < v)).float()
            p.scatter_add_(1, y_loc.clamp(0, v - 1)[:, None], -mine[:, None])
            dl = p * (g * mc.float())[:, None]
            dlc = dl.to(hc.dtype).float()            # the compute dtype
            dhc = dlc @ wf.t()
            if ctx.group is not None:
                # h is replicated over the vocab shards; each rank's dh is
                # the partial from its columns
                dhc = all_reduce(dhc, ctx.group, "vp_dh")
            dh.append(dhc.to(hc.dtype))
            dw += hc.float().t() @ dlc
            db += dl.sum(dim=0)
        return (torch.stack(dh), dw.to(w.dtype), db.to(b.dtype), None, None,
                None, None)


def _fused(h, w, b, labels, chunk_tokens, group):
    v = w.shape[-1]
    h3, y2, mask2, n = _chunk_and_pad(h, labels, v, chunk_tokens)
    if b is None:
        b = torch.zeros((v,), dtype=torch.float32, device=w.device)
    return _LMXent.apply(h3, w, b, y2, mask2, n, group)


def fused_lm_xent(h, w, b, labels, chunk_tokens: int | None = None):
    """Fused LM-head softmax cross entropy -> ``(loss, top1_err,
    top5_err)``.  ``h``: trunk output ``[..., D]``; ``w``: head weight
    ``[D, V]``; ``b``: head bias ``[V]`` or None; ``labels``: int ids over
    ``h``'s leading dims.  Tokens that do not fill the last chunk are
    zero-padded and masked."""
    return _fused(h, w, b, labels, chunk_tokens, None)


def fused_lm_xent_vp(h, w_local, b_local, labels,
                     chunk_tokens: int | None = None):
    """The vocab-parallel fused loss -> ``(loss, top1_err, top5_err)``:
    ``w_local`` ``[D, V / n_model]`` and ``b_local`` are this rank's
    columns of the head (rank m of the model group holds ``[m V / n_model,
    (m + 1) V / n_model)``); ``h`` and ``labels`` are replicated over the
    group.  The same chunking, masking and tie rule as
    :func:`fused_lm_xent` on the gathered head; no rank holds more than
    ``[chunk, V / n_model]`` scores.  With no model group it is
    :func:`fused_lm_xent`."""
    return _fused(h, w_local, b_local, labels, chunk_tokens,
                  mesh.model_group())
