"""The switch-routed mixture-of-experts FFN, experts sharded over the model
group (expert parallelism).

Counterpart of ``theanompi_tpu/ops/moe.py`` (``MoEFFN``).  Expert
parallelism reuses the ``model`` axis: a layer uses tensor or expert
parallelism, and the two share the group.

- Routing is top-1 (Fedus et al. 2021) in fp32: gate logits, softmax,
  the argmax expert, its probability the combine weight.
- The Switch load-balance loss ``E * sum_e f_e * P_e`` rides in the
  layer's state under ``aux``; ``f`` and ``P`` are averaged over the model
  group before the product (:144-153), so it is the one-process model's.
  ``P``'s mean is ``g`` over ``ep``: its backward hands each rank ``1 /
  ep`` of the replicated cotangent, the one-process gradient.  The
  reference's ``pmean`` under ``shard_map(check_vma=False)`` transposes
  to a sum, so its aux gradient is ``ep`` times that (ROADMAP queue 3).
- Capacity is per rank chunk, ``ceil(chunk * capacity_factor / E)``
  (:156): each rank routes its ``tokens / ep`` chunk, and a token past its
  expert's slots is dropped (it contributes zero; the residual carries
  it).  With ``capacity_factor >= n_experts`` nothing can drop and expert
  parallelism is exactly the one-process model.
- Tokens are sliced with Megatron-``f`` pins on the tokens and on the
  gate weight (:113-131), and ``g`` rebuilds the full output from the
  ranks' padded chunks (:202-205).
- The expert-major slabs go to the ranks that hold their experts and come
  back by ``all_to_all_single`` over the model group (:166-200); the
  local experts run as one batched product over the stacked weights
  (``torch.bmm``).

Dispatch is by index, not by the reference's dense ``[N, E, C]`` one-hot
einsum: the positions come from the same cumsum, and the tokens are
copied into their slots and gathered back by index (a dropped token's
slot lies past the slabs and reads back zero).  The gather picks the
values the einsum sums with zeros, so fp32 results are equal, memory
stays O(N D) (the dense form at the bench transformer's 32,768 tokens
would take 5.4 GB a layer), and no host sync sizes the kept set.

The all-to-all's transport is the group's backend (:func:`a2a_transport`):
NCCL on the card, gloo elsewhere; gloo carries ``all_to_all_single`` of
CUDA tensors too (through the host; ranks sharing one card run so).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from theanompi_torch.ops import initializers as init_lib
from theanompi_torch.ops.layers import StatefulLayer
from theanompi_torch.parallel import mesh
from theanompi_torch.parallel.tensor import (
    COLLECTIVES,
    all_reduce,
    identity_fwd_psum_bwd,
    psum_fwd_identity_bwd,
)


def a2a_transport(device, group) -> str:
    """How the all-to-all moves a tensor on ``device`` over ``group``:
    ``"nccl"`` (card to card), ``"gloo"`` (host tensors) or ``"gloo, CUDA
    tensors through the host"`` (gloo ranks on the card)."""
    backend = dist.get_backend(group)
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "gloo, CUDA tensors through the host"
    return backend


def _a2a(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """Chunk ``p`` of ``x``'s dim 0 to rank ``p`` of ``group``; -> the
    chunks received, in source-rank order."""
    COLLECTIVES[kind] += 1
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


#: the tokens this process routed in training forwards and those dropped
#: (a device tensor, read at the caller's sync), since the caller last
#: zeroed them (the smoke's dropped share)
DROPS: dict = {"routed": 0, "dropped": 0}


class _AllToAll(torch.autograd.Function):
    """The all-to-all of equal dim-0 chunks, which is its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group, "a2a")

    @staticmethod
    def backward(ctx, ct):
        return _a2a(ct, ctx.group, "a2a_bwd"), None


class MoEFFN(StatefulLayer):
    """Switch-routed expert FFN over ``[B, T, D]``.  ``n_experts`` is
    global: under expert parallelism a rank holds ``n_experts / ep``, the
    stacked leading dim of every expert leaf (``up_w [E, D, H]``, ``up_b
    [E, H]``, ``down_w [E, H, D]``, ``down_b [E, D]``) cut over the model
    group; the gate ``{"w": [D, E]}`` is replicated."""

    def __init__(self, dim: int, n_experts: int, hidden_mult: int = 4,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.dim = dim
        self.n_experts = n_experts
        self.hidden_mult = hidden_mult
        self.capacity_factor = capacity_factor

    def init_stateful(self, gen, in_shape):
        d = in_shape[-1]
        if d != self.dim:
            raise ValueError(f"MoEFFN dim {self.dim} != input {d}")
        e, h = self.n_experts, self.hidden_mult * d
        w02 = init_lib.normal(0.02)
        params = {"gate": {"w": w02(gen, (d, e))},
                  "up_w": w02(gen, (e, d, h)),
                  "up_b": torch.zeros((e, h), device=gen.device),
                  "down_w": w02(gen, (e, h, d)),
                  "down_b": torch.zeros((e, d), device=gen.device)}
        return params, {"aux": torch.zeros((), device=gen.device)}, \
            tuple(in_shape)

    def capacity(self, chunk: int) -> int:
        """Slots an expert has for a chunk of ``chunk`` tokens (:156)."""
        return int(max(1, -(-chunk * self.capacity_factor // self.n_experts)))

    def route(self, xt, gate_w):
        """-> (probs ``[N, E]``, the one-hot expert choice ``[N, E]``, the
        expert ``[N]``, the gate prob ``[N]``, the token's position within
        its expert ``[N]``), all from fp32 scores."""
        probs = torch.softmax(xt.float() @ gate_w.float(), dim=-1)
        expert = probs.argmax(dim=-1)
        onehot = F.one_hot(expert, self.n_experts).float()
        pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1).long() - 1
        gate = probs.gather(1, expert[:, None])[:, 0]
        return probs, onehot, expert, gate, pos

    def apply_stateful(self, params, state, x, train: bool = False,
                       gen=None):
        b, t, d = x.shape
        n_tok, e = b * t, self.n_experts
        ep, group = mesh.model_size(), mesh.model_group()
        xt = x.reshape(n_tok, d)
        gate_w = params["gate"]["w"]
        if ep > 1:
            if n_tok % ep:
                raise ValueError(f"tokens {n_tok} not divisible by ep={ep}")
            if e % ep:
                raise ValueError(f"{e} experts not divisible by ep={ep}")
            chunk, me = n_tok // ep, mesh.model_index()
            # each rank routes its chunk: f repairs the sliced cotangents
            xt = identity_fwd_psum_bwd(xt)[me * chunk:(me + 1) * chunk]
            gate_w = identity_fwd_psum_bwd(gate_w)
        else:
            chunk = n_tok
        probs, onehot, expert, gate, pos = self.route(xt, gate_w)

        # the Switch aux loss over the global token set: f and P averaged
        # over the ranks (equal chunks) before the product
        f, p_mean = onehot.mean(dim=0), probs.mean(dim=0)
        if ep > 1:
            f = all_reduce(f, group, "aux") / ep
            p_mean = psum_fwd_identity_bwd(p_mean) / ep
        aux = e * (f * p_mean).sum()

        # token n's slot: expert * cap + position, or past the slabs (row
        # e * cap + n, one a token so the indices stay unique) if dropped
        cap = self.capacity(chunk)
        if train:
            DROPS["routed"] += chunk
            DROPS["dropped"] = DROPS["dropped"] + (pos >= cap).sum()
        rows = torch.arange(chunk, device=xt.device)
        slot = torch.where(pos < cap, expert * cap + pos, e * cap + rows)
        xf = xt.float()
        slabs = xf.new_zeros(e * cap + chunk, d).index_copy(0, slot, xf)
        slabs = slabs[:e * cap]

        if ep > 1:
            # expert-major: rank p gets this chunk's tokens for its experts
            slabs = _AllToAll.apply(slabs.reshape(ep, -1, d), group)
            slabs = slabs.reshape(ep, e // ep, cap, d).transpose(0, 1)
        experts = slabs.reshape(e // ep, ep * cap, d)
        hid = torch.bmm(experts, params["up_w"].float()) \
            + params["up_b"].float()[:, None, :]
        hid = F.gelu(hid, approximate="tanh")
        out = torch.bmm(hid, params["down_w"].float()) \
            + params["down_b"].float()[:, None, :]
        if ep > 1:
            out = out.reshape(e // ep, ep, cap, d).transpose(0, 1)
            out = _AllToAll.apply(out.reshape(ep, -1, d), group)
        # a dropped token reads a zero row
        out = torch.cat([out.reshape(e * cap, d), out.new_zeros(chunk, d)])
        yt = out[slot] * gate[:, None]
        if ep > 1:
            yt = psum_fwd_identity_bwd(torch.cat([
                yt.new_zeros(me * chunk, d), yt,
                yt.new_zeros(n_tok - (me + 1) * chunk, d)]))
        return yt.reshape(b, t, d).to(x.dtype), {**state, "aux": aux}
