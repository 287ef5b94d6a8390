"""Losses and error metrics, and the fused chunked LM cross entropy.

Counterpart of ``theanompi_tpu/ops/losses.py``: ``softmax_cross_entropy``,
``sigmoid_binary_cross_entropy`` (the GAN's), ``top_k_error`` (ties
count against the model: ``>=``), and
``fused_lm_xent``, the LM head matmul fused into a softmax cross entropy
that streams the ``[N, V]`` scores in token chunks and never stores them.
Its forward keeps only the per-token logsumexp; its backward recomputes
each chunk's scores from ``(h, w, b, lse)`` (the reference's custom VJP,
``losses.py:121-163``, here a ``torch.autograd.Function``).  The
vocab-parallel ``fused_lm_xent_vp`` comes with the sharding slice.

Scores, ``dh`` and the ``dw``/``db`` accumulators are fp32, as the
reference's ``preferred_element_type=float32`` products make them: the
port upcasts the operands to fp32 before each product (products of bf16
values are exact in fp32, so this is the reference's arithmetic up to sum
order).  A bf16 ``torch.matmul`` would round the scores to bf16, which at
V = 32768 loses most of the lse's digits.
"""

from __future__ import annotations

import torch


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


class _LMXent(torch.autograd.Function):
    """-> (loss, top-1 error, top-5 error) over padded chunks; only the
    loss is differentiable (the errors are step functions)."""

    @staticmethod
    def forward(ctx, h3, w, b, y2, mask2, n):
        ls = torch.zeros((), dtype=torch.float32, device=h3.device)
        c1, c5 = ls.clone(), ls.clone()
        lses = []
        wf, bf = w.float(), b.float()
        for hc, yc, mc in zip(h3, y2, mask2):
            s = _chunk_scores(hc, wf, bf)
            m = s.amax(dim=-1)
            lse = m + torch.log(torch.exp(s - m[:, None]).sum(dim=-1))
            gold = s.gather(1, yc[:, None])[:, 0]
            rank = (s >= gold[:, None]).sum(dim=-1) - 1
            mf = mc.float()
            ls = ls + ((lse - gold) * mf).sum()
            c1 = c1 + ((rank >= 1).float() * mf).sum()
            c5 = c5 + ((rank >= 5).float() * mf).sum()
            lses.append(lse)
        ctx.save_for_backward(h3, w, b, y2, mask2, torch.stack(lses))
        ctx.n = n
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
        for hc, yc, mc, lsec in zip(h3, y2, mask2, lse2):
            p = torch.exp(_chunk_scores(hc, wf, bf) - lsec[:, None])
            rows = torch.arange(p.shape[0], device=p.device)
            p[rows, yc] -= 1.0                       # p - onehot(y)
            dl = p * (g * mc.float())[:, None]
            dlc = dl.to(hc.dtype).float()            # the compute dtype
            dh.append((dlc @ wf.t()).to(hc.dtype))
            dw += hc.float().t() @ dlc
            db += dl.sum(dim=0)
        return (torch.stack(dh), dw.to(w.dtype), db.to(b.dtype), None, None,
                None)


def fused_lm_xent(h, w, b, labels, chunk_tokens: int | None = None):
    """Fused LM-head softmax cross entropy -> ``(loss, top1_err,
    top5_err)``.  ``h``: trunk output ``[..., D]``; ``w``: head weight
    ``[D, V]``; ``b``: head bias ``[V]`` or None; ``labels``: int ids over
    ``h``'s leading dims.  Tokens that do not fill the last chunk are
    zero-padded and masked."""
    v = w.shape[-1]
    h3, y2, mask2, n = _chunk_and_pad(h, labels, v, chunk_tokens)
    if b is None:
        b = torch.zeros((v,), dtype=torch.float32, device=w.device)
    return _LMXent.apply(h3, w, b, y2, mask2, n)
