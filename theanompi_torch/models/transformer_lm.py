"""Decoder-only transformer LM: the dense model's training and serving
paths.

Counterpart of ``theanompi_tpu/models/transformer_lm.py`` (``_Block`` and
``TransformerLM``), with the reference's param tree and key names —
``00_embedding``, ``01_positionembedding``, ``NN__block/{ln1, attn/{q,k,v,o},
ln2, up, down}``, the final ``NN_layernorm`` and ``head`` — so a converted
reference tree (:mod:`theanompi_torch.convert`) plugs straight in.

Training: ``loss_fn`` runs the trunk (``apply_trunk``: embedding,
positions, the blocks with dropout, the final LN) and the head outside it:
the fused chunked cross entropy (``ops.losses.fused_lm_xent``) at vocab
>= 8192, the plain head and fp32 softmax cross entropy below.  Data is
``PTBData`` (the synthetic bigram stream unless real PTB is given), or
with ``dataset="stream"`` (or ``stream_sources`` / ``stream_dir``) the
mixture token stream, :class:`~theanompi_torch.models.data.stream.
StreamTokenDataset`.

Serving: ``apply_logits`` (full forward, the batched reference),
``apply_prefill`` (one prompt, K/V into the paged cache),
``apply_prefill_partial`` (an uncached suffix over a cached prefix) and
``apply_decode`` (one token for every slot of a fixed batch).  The K/V
writes go into the cache's pools in place; each method returns the same
cache object.

Tensor and expert parallelism (a bound layout with a model group,
:mod:`theanompi_torch.parallel.mesh`): a rank holds its shards of the
params (:meth:`TransformerLM.param_specs`, the reference's
``specs_from_rules(TP_RULES)`` with the head vocab-parallel when the
fused loss is on), the blocks' q/k/v and ``up`` are column-parallel, o
and ``down`` row-parallel, and the loss is
:func:`~theanompi_torch.ops.losses.fused_lm_xent_vp`.
:class:`MoETransformerLM` swaps each block's MLP for the switch-routed
:class:`~theanompi_torch.ops.moe.MoEFFN`, whose stacked experts are cut
over the same group, and adds the blocks' mean load-balance loss at
``moe_aux_weight``.  The pipeline variant comes with a later slice.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from theanompi_torch.models.contract import Model
from theanompi_torch.models.lstm import PTBData, ptb_path
from theanompi_torch.ops import initializers as init_lib
from theanompi_torch.ops import quant
from theanompi_torch.ops.attention import MultiHeadAttention, PositionEmbedding
from theanompi_torch.ops.layers import (
    Dense,
    Dropout,
    Embedding,
    Layer,
    LayerNorm,
)
from theanompi_torch.ops.losses import (
    fused_lm_xent,
    fused_lm_xent_vp,
    softmax_cross_entropy,
    top_k_error,
)
from theanompi_torch.ops.moe import MoEFFN
from theanompi_torch.ops.opt import global_sq_norm
from theanompi_torch.parallel import mesh
from theanompi_torch.parallel.tensor import (
    ColumnParallelDense,
    RowParallelDense,
    specs_from_rules,
)


def _streamed(cfg) -> bool:
    """Whether the config asks for the token stream."""
    return bool(cfg.get("dataset") == "stream" or cfg.get("stream_sources")
                or cfg.get("stream_dir"))


class _Block(Layer):
    """Pre-norm transformer block: LN -> MHA -> dropout -> residual, LN ->
    MLP -> dropout -> residual (tanh-approximate GELU, the reference's
    ``jax.nn.gelu``; dropout only in training).  ``up`` is column-parallel
    and ``down`` row-parallel (the reference's :51-56).  The MLP half is a
    hook (``_ffn_subs`` / ``_ffn``) that :class:`_MoEBlock` overrides."""

    #: the MLP half's sub-layers, chained in ``init_stateful``
    FFN_KEYS = ("up", "down")

    def __init__(self, dim: int, heads: int, dropout: float = 0.0,
                 attn_impl: str = "auto"):
        super().__init__()
        self.dim = dim
        self.drop = Dropout(dropout)
        self.subs = nn.ModuleDict({
            "ln1": LayerNorm(),
            "attn": MultiHeadAttention(dim, heads, causal=True,
                                       impl=attn_impl),
            "ln2": LayerNorm(),
            **self._ffn_subs(),
        })

    def _ffn_subs(self) -> dict:
        w02 = init_lib.normal(0.02)
        return {"up": ColumnParallelDense(4 * self.dim, w_init=w02),
                "down": RowParallelDense(self.dim, w_init=w02)}

    def init_stateful(self, gen, in_shape):
        params, state, shape = {}, {}, tuple(in_shape)
        for name, layer in self.subs.items():
            ffn = name in self.FFN_KEYS
            p, s, out = layer.init_stateful(gen, shape if ffn else in_shape)
            if ffn:
                shape = out  # chained through the MLP half only
            if p:
                params[name] = p
            if s:
                state[name] = s
        return params, state, tuple(in_shape)

    def _ffn(self, params, state, h, train: bool = False):
        """The MLP half -> (h, its new state: none)."""
        h = self.subs["up"](params["up"], h)
        h = F.gelu(h, approximate="tanh")
        return self.subs["down"](params["down"], h), {}

    def _finish(self, params, x, ctx):
        """Output projection, residual, and the MLP half."""
        s = self.subs
        x = x + s["attn"].project_out(
            params["attn"], ctx.reshape(x.shape[0], x.shape[1], -1))
        return x + self._ffn(params, {}, s["ln2"](params["ln2"], x))[0]

    def apply_stateful(self, params, state, x, train: bool = False,
                       gen=None):
        s = self.subs
        h = s["attn"](params["attn"], s["ln1"](params["ln1"], x))
        x = x + self.drop(None, h, train, gen)
        h, new_state = self._ffn(params, state,
                                 s["ln2"](params["ln2"], x), train)
        return x + self.drop(None, h, train, gen), new_state

    def forward(self, params, x, train: bool = False, gen=None):
        return self.apply_stateful(params, {}, x, train, gen)[0]

    def prefill_step(self, params, x, cache, layer_idx, table_row):
        """Full-prompt forward of one block: writes this layer's K/V into
        the cache and attends causally within the prompt through
        ``MultiHeadAttention.attend`` (kernel 1 on the card).  ``x``
        ``[1, P_pad, D]`` -> y."""
        attn = self.subs["attn"]
        q, k, v = attn.project_qkv(params["attn"],
                                   self.subs["ln1"](params["ln1"], x))
        cache.write_prefill(layer_idx, k, v, table_row)
        return self._finish(params, x, attn.attend(q, k, v))

    def prefill_suffix_step(self, params, x, cache, layer_idx, suffix_row,
                            full_row, prefix_len):
        """Partial-prefill forward: ``x`` ``[1, S_pad, D]`` holds only the
        uncached suffix (absolute positions ``prefix_len..``); its K/V go
        into ``suffix_row``'s blocks and the queries attend over the full
        row, cached prefix included.  -> y."""
        attn = self.subs["attn"]
        q, k, v = attn.project_qkv(params["attn"],
                                   self.subs["ln1"](params["ln1"], x))
        cache.write_prefill(layer_idx, k, v, suffix_row)
        ctx = cache.attend_prefill(layer_idx, q, full_row, prefix_len)
        return self._finish(params, x, ctx)

    def decode_step(self, params, x, cache, layer_idx, positions):
        """One-token forward: appends this layer's K/V at ``positions`` and
        attends over the cached context (kernel 4 on the kernel path).
        ``x`` ``[B, 1, D]``, ``positions`` ``[B]`` -> y."""
        attn = self.subs["attn"]
        q, k, v = attn.project_qkv(params["attn"],
                                   self.subs["ln1"](params["ln1"], x))
        cache.write_decode(layer_idx, k[:, 0], v[:, 0], positions)
        return self._finish(params, x,
                            cache.attend_decode(layer_idx, q[:, 0], positions))


class _MoEBlock(_Block):
    """:class:`_Block` with the switch-routed :class:`MoEFFN` as its MLP
    half, under ``moe``; its load-balance loss rides in the block's state
    under ``moe/aux`` (the reference's :171-188)."""

    FFN_KEYS = ("moe",)

    def __init__(self, dim: int, heads: int, dropout: float = 0.0,
                 attn_impl: str = "auto", n_experts: int = 8,
                 capacity_factor: float = 1.25):
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        super().__init__(dim, heads, dropout=dropout, attn_impl=attn_impl)

    def _ffn_subs(self) -> dict:
        return {"moe": MoEFFN(self.dim, self.n_experts,
                              capacity_factor=self.capacity_factor)}

    def _ffn(self, params, state, h, train: bool = False):
        h, moe_state = self.subs["moe"].apply_stateful(
            params["moe"], state.get("moe", {}), h, train)
        return h, {"moe": moe_state}


class TransformerLM(Model):
    default_config = {
        "batch_size": 8,
        "n_epochs": 10,
        "lr": 1e-3,
        "momentum": 0.9,
        "grad_clip": 1.0,
        "seq_len": 256,
        "dim": 256,
        "heads": 8,
        "n_layers": 4,
        # training only: serving runs train=False
        "dropout": 0.1,
        # the reference's sequence-parallel attention and its scan unroll
        # factors: kept in the table (the run fingerprint hashes the whole
        # config, so the key sets must be the reference's), and any other
        # value than these is refused (UNCARRIED)
        "seq_parallel": False,
        # "auto": kernels 1-3 on the card (their wrappers raise on a shape
        # they do not take), blockwise elsewhere; "pallas"/"blockwise"
        # force a path (the reference's names)
        "attn_impl": "auto",
        "layers_unroll": 1,
        "loss_unroll": 1,
        # "ptb": the chopped PTB-style set (synthetic unless data_path /
        # $PTB_PATH names real PTB); "stream" (or any stream_sources /
        # stream_dir): the checkpointable mixture token stream
        "dataset": "ptb",
        # read with defaults, as the reference reads them: "vocab" (256)
        # and "fused_loss" ("auto": the fused chunked loss at vocab >=
        # 8192)
    }

    #: keys of the reference's table whose machinery the port does not
    #: carry, with the one value it runs: another value raises
    UNCARRIED = {"seq_parallel": False, "layers_unroll": 1, "loss_unroll": 1}

    def __init__(self, config=None):
        super().__init__(config)
        cfg = self.config
        for key, value in self.UNCARRIED.items():
            if cfg[key] != value:
                raise NotImplementedError(
                    f"TransformerLM: {key}={cfg[key]!r} not yet ported "
                    f"(the port runs {key}={value!r}; sequence-parallel "
                    f"meshes and scan unrolling are the reference's XLA "
                    f"machinery)")
        if ptb_path(cfg) is not None or _streamed(cfg):
            self.vocab = self.data.vocab  # real data sets its own vocab
        layers: list[Layer] = [
            Embedding(self.vocab, cfg["dim"], w_init=init_lib.normal(0.02)),
            PositionEmbedding(cfg["seq_len"], cfg["dim"]),
        ]
        for _ in range(cfg["n_layers"]):
            layers.append(self._make_block())
        layers.append(LayerNorm())
        self.layers = [(f"{i:02d}_{layer.name}", layer)
                       for i, layer in enumerate(layers)]
        self.head = Dense(self.vocab, w_init=init_lib.glorot_normal)

    def _make_block(self) -> _Block:
        """The block factory (:class:`MoETransformerLM` swaps the MLP)."""
        cfg = self.config
        return _Block(cfg["dim"], cfg["heads"], dropout=cfg["dropout"],
                      attn_impl=cfg["attn_impl"])

    def build_data(self):
        cfg = self.config
        if _streamed(cfg):
            from theanompi_torch.models.data.stream import StreamTokenDataset

            if cfg.get("stream_dir") and not cfg.get("stream_sources"):
                # one source a subdirectory, equally weighted
                root = cfg["stream_dir"]
                cfg = {**cfg, "stream_sources": [
                    {"name": d, "path": os.path.join(root, d)}
                    for d in sorted(os.listdir(root))
                    if os.path.isdir(os.path.join(root, d))]}
            return StreamTokenDataset(cfg)
        return PTBData(cfg)

    def fused_loss_enabled(self) -> bool:
        mode = self.config.get("fused_loss", "auto")
        if mode == "auto":
            return self.vocab >= 8192
        return bool(mode)

    def init_params(self, gen: torch.Generator):
        """-> (fp32 param tree in the reference's layout on ``gen``'s
        device, the state: empty for the dense model, the MoE blocks'
        ``moe/aux``)."""
        shape = (self.config["seq_len"],)
        params, state = {}, {}
        for name, layer in self.layers:
            p, s, shape = layer.init_stateful(gen, shape)
            if p:
                params[name] = p
            if s:
                state[name] = s
        params["head"], _ = self.head.init(gen, shape)
        return params, state

    def param_specs(self, params) -> dict:
        """Each param leaf's dim cut over the model group (None:
        replicated): the reference's ``TP_RULES``, and the head
        vocab-parallel, ``w`` on dim 1 and ``b`` on dim 0, whenever the
        fused loss is on (its ``_head_specs``, :408-421)."""
        specs = specs_from_rules(params)
        vp = self.fused_loss_enabled()
        specs["head"] = {k: (({"w": 1, "b": 0}[k]) if vp else None)
                         for k in params["head"]}
        return specs

    def _head_logits(self, cp, h):
        y = quant.matmul_any(h, cp["head"]["w"])
        if "b" in cp["head"]:
            y = y + cp["head"]["b"].to(h.dtype)
        return y.float()

    def _embed(self, cp, tokens):
        return cp[self.layers[0][0]]["w"][tokens]

    def _run(self, cp, x, block_fn):
        """Position-embedded ``x`` through the blocks and the final LN."""
        li = 0
        for name, layer in self.layers[2:]:
            if isinstance(layer, _Block):
                x = block_fn(layer, cp[name], x, li)
                li += 1
            else:
                x = layer(cp[name], x)
        return x

    def apply_logits(self, params, tokens):
        """Full-sequence forward to fp32 logits ``[B, T, V]`` — the batched
        reference the serving tests compare incremental decode against."""
        cp = self.precision.cast_to_compute(params)
        x = self.layers[1][1](cp[self.layers[1][0]], self._embed(cp, tokens))
        x = self._run(cp, x, lambda blk, p, h, li: blk(p, h))
        return self._head_logits(cp, x)

    def apply_prefill(self, params, kv_cache, table_row, tokens):
        """Prompt prefill for ONE sequence: ``tokens`` ``[1, P_pad]`` (end-
        padded to whole cache blocks — causal masking keeps the padding out
        of every real position), ``table_row`` its block ids.  Writes K/V
        into ``kv_cache`` in place.  -> (logits ``[1, P_pad, V]`` fp32,
        kv_cache)."""
        cp = self.precision.cast_to_compute(params)
        x = self.layers[1][1](cp[self.layers[1][0]], self._embed(cp, tokens))
        x = self._run(cp, x, lambda blk, p, h, li: blk.prefill_step(
            p, h, kv_cache, li, table_row))
        return self._head_logits(cp, x), kv_cache

    def apply_prefill_partial(self, params, kv_cache, suffix_row, full_row,
                              tokens, prefix_len: int):
        """Partial prefill: ``tokens`` ``[1, S_pad]`` are the prompt from
        absolute position ``prefix_len`` on; positions index at
        ``prefix_len + s``, clipped into the table for end padding.  ->
        (logits ``[1, S_pad, V]`` fp32, kv_cache)."""
        cp = self.precision.cast_to_compute(params)
        x = self._embed(cp, tokens)
        pos = cp[self.layers[1][0]]["pos"]
        idx = torch.clamp(prefix_len + torch.arange(tokens.shape[1],
                                                    device=x.device),
                          0, pos.shape[0] - 1)
        x = x + pos[idx].to(x.dtype)[None]
        x = self._run(cp, x, lambda blk, p, h, li: blk.prefill_suffix_step(
            p, h, kv_cache, li, suffix_row, full_row, prefix_len))
        return self._head_logits(cp, x), kv_cache

    def apply_decode(self, params, kv_cache, positions, tokens):
        """One decode step for a fixed batch: ``tokens`` ``[B]`` (the token
        AT ``positions``), ``positions`` ``[B]`` int32, 0-based.  Appends
        each layer's K/V and attends over the cached context.  -> (logits
        ``[B, V]`` fp32, kv_cache).  Inactive slots ride along with tables
        of null blocks."""
        cp = self.precision.cast_to_compute(params)
        x = self._embed(cp, tokens)[:, None, :]
        pos = cp[self.layers[1][0]]["pos"]
        x = x + pos[positions.long()].to(x.dtype)[:, None, :]
        x = self._run(cp, x, lambda blk, p, h, li: blk.decode_step(
            p, h, kv_cache, li, positions))
        return self._head_logits(cp, x[:, 0, :]), kv_cache

    # -- training -------------------------------------------------------------
    def apply_trunk(self, cp, state, tokens, train: bool = False,
                    gen=None):
        """The trunk over compute-cast params ``cp``: embedding, positions,
        the blocks (dropout from ``gen`` when ``train``) and the final LN
        -> (hidden states ``[B, T, D]``, the blocks' new state).  The head
        stays outside, so the loss can fuse it."""
        new_state = dict(state)

        def block(blk, p, h, li):
            name = self.layers[li + 2][0]
            h, s = blk.apply_stateful(p, state.get(name, {}), h, train, gen)
            if s:
                new_state[name] = s
            return h

        x = self.layers[1][1](cp[self.layers[1][0]], self._embed(cp, tokens))
        return self._run(cp, x, block), new_state

    def loss_fn(self, params, state, batch, gen, train: bool):
        """-> (loss, (new state, metrics ``cost/error/error_top5/
        perplexity``)) for one batch ``{"x": [B, T], "y": [B, T]}`` of int64
        token ids.  Params are the fp32 masters (a rank's shards under
        tensor parallelism); autograd through the compute cast hands back
        fp32 grads.  With a model group the fused loss is the
        vocab-parallel one (the reference's :451-455)."""
        cp = self.precision.cast_to_compute(params)
        h, new_state = self.apply_trunk(cp, state, batch["x"], train=train,
                                        gen=gen)
        y = batch["y"]
        if self.fused_loss_enabled():
            xent = fused_lm_xent if mesh.model_size() == 1 else \
                fused_lm_xent_vp
            loss, err1, err5 = xent(h, cp["head"]["w"], cp["head"].get("b"),
                                    y)
        else:
            logits = self.head(cp["head"], h)
            loss = softmax_cross_entropy(logits, y)
            err1 = top_k_error(logits, y, k=1)
            err5 = (top_k_error(logits, y, k=5) if logits.shape[-1] >= 5
                    else torch.zeros((), device=h.device))
        if self.config.get("l2", 0.0):  # L2 folded into the cost
            loss = loss + self.config["l2"] * global_sq_norm(
                params, self.param_specs(params))
        metrics = {"cost": loss.detach(), "error": err1.detach(),
                   "error_top5": err5.detach(),
                   "perplexity": torch.exp(loss.detach())}
        return loss, (new_state, metrics)


class MoETransformerLM(TransformerLM):
    """The mixture-of-experts LM (the reference's :472-528): every block's
    MLP is a switch-routed :class:`MoEFFN` of ``n_experts`` global experts,
    cut over the model group (expert parallelism shares the group with the
    attention's tensor parallelism), and the blocks' mean load-balance
    loss joins the training loss at ``moe_aux_weight``."""

    default_config = {
        **TransformerLM.default_config,
        "n_experts": 8,
        "capacity_factor": 1.25,
        "moe_aux_weight": 0.01,
    }

    def _make_block(self) -> _Block:
        cfg = self.config
        return _MoEBlock(cfg["dim"], cfg["heads"], dropout=cfg["dropout"],
                         attn_impl=cfg["attn_impl"],
                         n_experts=cfg["n_experts"],
                         capacity_factor=cfg["capacity_factor"])

    def param_specs(self, params) -> dict:
        """:meth:`TransformerLM.param_specs`, with the stacked expert
        leaves (``up_w``, ``up_b``, ``down_w``, ``down_b`` under ``moe``)
        cut on dim 0."""
        specs = super().param_specs(params)
        for name, p in params.items():
            if isinstance(p, dict) and "moe" in p:
                for k in ("up_w", "up_b", "down_w", "down_b"):
                    specs[name]["moe"][k] = 0
        return specs

    def loss_fn(self, params, state, batch, gen, train: bool):
        """:meth:`TransformerLM.loss_fn`, plus the blocks' mean ``aux``
        (reported as ``moe_aux``; added at ``moe_aux_weight`` in
        training).  The state carries each block's ``aux`` detached."""
        loss, (new_state, metrics) = super().loss_fn(params, state, batch,
                                                     gen, train)
        auxes = [s["moe"]["aux"] for s in new_state.values()
                 if isinstance(s, dict) and "moe" in s]
        if auxes:
            a = sum(auxes) / len(auxes)
            metrics = {**metrics, "moe_aux": a.detach()}
            if train:
                loss = loss + self.config["moe_aux_weight"] * a
            new_state = {k: {**s, "moe": {**s["moe"],
                                          "aux": s["moe"]["aux"].detach()}}
                         if isinstance(s, dict) and "moe" in s else s
                         for k, s in new_state.items()}
        return loss, (new_state, metrics)
