"""Inference engine: prefill and decode steps for ``TransformerLM``.

Counterpart of ``theanompi_tpu/serving/engine.py``, the compute half of
serving (the scheduler is the policy half).  It owns the paged KV pools,
the (optionally int8) params, and two steps over the model's serving path:

- **prefill**: one sequence, the whole prompt in one forward.  Prompts pad
  to power-of-two numbers of blocks (the reference's buckets); causal
  masking keeps the padding out of every real position, and the first
  token samples from the last real position's logits.  Prefill runs the
  dequantized weights in the compute dtype.
- **decode**: one token for every slot of a FIXED ``max_batch``; inactive
  slots ride along with tables of null blocks.

``decode_kernel``: ``"auto"`` takes the kernels (kernel 4 for decode
attention, kernel 5 for int8 weights) on the card, whatever the geometry
— a wrapper raises on a shape its kernel does not take — and the plain
path elsewhere; ``"on"`` takes them everywhere (on a CPU tensor each
wrapper runs its plain version); ``"off"`` pins the plain decode path,
which dequantizes every weight.  ``attn_impl`` is the model's config key
(prefill's flash kernel vs the blockwise path).

Live rollout: :meth:`InferenceEngine.swap_params` installs a restored
tree (moved to the card once, re-quantized as ``__init__`` quantized)
and returns the previous one, which :meth:`InferenceEngine.
restore_params` puts back exactly; both bump ``params_version``.

Sampling: greedy (``temperature <= 0``) is argmax; temperature sampling
draws Gumbel noise from a ``torch.Generator`` seeded from ``(seed, request
id, position)`` only, so a preempted and recomputed sequence resamples
identically.  (``jax.random``'s bits cannot be reproduced; only the
port's own replay determinism is held.)
"""

from __future__ import annotations

import numpy as np
import torch

from theanompi_torch.parallel.mesh import resolve_device
from theanompi_torch.serving.kv_cache import PagedKVCache, blocks_for
from theanompi_torch.serving.quant import (
    dequantize_tree,
    is_quantized_tree,
    quantize_tree,
)
from theanompi_torch.tree import tree_to

DECODE_KERNEL_MODES = ("auto", "on", "off")


def sample_seed(seed: int, rid: int, position: int) -> int:
    """The (seed, request, position)-only derivation of a row's sampling
    stream."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(rid),
                                 int(position)])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def sample_tokens(logits, temps, seeds, top_k: int = 0) -> np.ndarray:
    """Per-row sampling: argmax where ``temps <= 0``, else the Gumbel-max
    draw from ``softmax(logits / temp)`` (over the top ``top_k`` logits
    when set) under a generator seeded with ``seeds[row]``.  ``logits``
    ``[B, V]`` fp32 tensor -> ``[B]`` int32 numpy."""
    out = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
    for r, t in enumerate(np.asarray(temps, np.float64)):
        if t <= 0:
            continue
        scaled = logits[r].float().cpu() / max(float(t), 1e-6)
        if top_k and top_k < scaled.numel():
            kth = torch.topk(scaled, top_k).values[-1]
            scaled = torch.where(scaled >= kth, scaled,
                                 torch.full_like(scaled, -float("inf")))
        gen = torch.Generator().manual_seed(int(seeds[r]))
        u = torch.rand(scaled.shape, generator=gen, dtype=torch.float64)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-300)))
        out[r] = int((scaled.double() + gumbel).argmax())
    return out


class InferenceEngine:
    """Prefill/decode steps and cache state for one ``TransformerLM``.

    ``device=None`` serves on the card and raises without one;
    ``device="cpu"`` runs every kernel's plain version.  ``num_blocks``
    may be sized below ``max_batch * blocks_per_seq + 1`` — the pool then
    runs out mid-decode, which is the scheduler's preemption trigger.
    ``params`` may already be quantized (e.g. a converted reference
    payload); ``quantize_int8`` quantizes an fp tree here.
    """

    def __init__(self, model, params, *, block_size: int = 16,
                 num_blocks: int | None = None, max_batch: int = 8,
                 quantize_int8: bool = False, quant_chunk: int = 1024,
                 top_k: int = 0, seed: int = 0, decode_kernel: str = "auto",
                 device=None):
        if decode_kernel not in DECODE_KERNEL_MODES:
            raise ValueError(f"decode_kernel={decode_kernel!r} not in "
                             f"{DECODE_KERNEL_MODES}")
        self.device = resolve_device(device)
        cfg = model.config
        self.model = model
        self.max_batch = int(max_batch)
        self.block_size = int(block_size)
        self.max_context = int(cfg["seq_len"])
        self.max_blocks_per_seq = blocks_for(self.max_context, block_size)
        if num_blocks is None:
            num_blocks = max_batch * self.max_blocks_per_seq + 1
        self.num_blocks = int(num_blocks)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.decode_kernel = decode_kernel
        heads, dim = cfg["heads"], cfg["dim"]
        dtype = model.precision.compute_dtype
        use_kernel = decode_kernel == "on" or (
            decode_kernel == "auto" and self.device.type == "cuda")
        #: resolved decode path: "kernel" (kernel 4, and kernel 5 for every
        #: int8 leaf) or "fallback" (the plain versions)
        self.decode_impl = "kernel" if use_kernel else "fallback"
        self.quant_stats = None
        # kept for swap_params: a live rollout re-quantizes the incoming
        # tree exactly as here (same generator seed, same chunking), so
        # kernel 5 sees the same format
        self._quantize_int8 = bool(quantize_int8)
        self._quant_chunk = int(quant_chunk)
        self._install(self._engine_format(params))
        self.cache = PagedKVCache.create(
            n_layers=cfg["n_layers"], num_blocks=self.num_blocks,
            block_size=block_size, heads=heads, head_dim=dim // heads,
            max_batch=max_batch, max_context=self.max_context, dtype=dtype,
            device=self.device, decode_impl=self.decode_impl)
        #: bumped when the weights change; the prefix cache stamps on it
        self.params_version = 0

    @property
    def quantized(self) -> bool:
        return is_quantized_tree(self.params)

    def _engine_format(self, params):
        """A port-format tree (host or device tensors) -> the engine's
        format: on the engine's device, int8 leaves when quantized."""
        params = tree_to(params, self.device)
        if self._quantize_int8:
            params, self.quant_stats = quantize_tree(
                params, torch.Generator().manual_seed(self.seed ^ 0x51),
                self._quant_chunk)
        return params

    def _install(self, params) -> None:
        """Serve ``params`` (engine format): prefill's dequantized
        compute-dtype copy and decode's tree (int8 leaves kept for kernel
        5 on the kernel path) are built once here, not per step, and the
        previous ones are dropped."""
        cast = self.model.precision.cast_to_compute
        #: the engine-format tree (int8 leaves when quantized)
        self.params = params
        self._prefill_params = cast(dequantize_tree(params))
        if self.decode_impl == "kernel" and is_quantized_tree(params):
            self._decode_params = cast(params)
        else:
            self._decode_params = self._prefill_params

    def swap_params(self, params):
        """Hot-swap the serving weights (live rollout); -> the previous
        engine-format tree, the rollback token for :meth:`restore_params`.

        ``params``: a port-format tree (as :func:`theanompi_torch.utils.
        checkpoint.load_for_inference` restores it), moved to the engine's
        device once and, under ``quantize_int8``, re-quantized with the
        seed and chunking ``__init__`` used.  The KV cache is not touched:
        the caller preempts the active sequences first, since their cache
        was computed under the old weights.  Bumps ``params_version``,
        which the prefix cache checks."""
        prev = self.params
        self._install(self._engine_format(params))
        self.params_version += 1
        return prev

    def restore_params(self, engine_params) -> None:
        """Reinstall a tree :meth:`swap_params` returned (engine format,
        never re-quantized).  Bumps ``params_version`` too: K/V cached
        under the rolled-back-from weights is stale."""
        self._install(engine_params)
        self.params_version += 1

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    # -- host API (the scheduler's surface) ----------------------------------
    def pad_len(self, n_tokens: int) -> int:
        """Prompt bucket: the smallest power-of-two number of blocks that
        holds ``n_tokens`` (>= one block), capped at the max context."""
        nb = 1
        while nb * self.block_size < n_tokens:
            nb *= 2
        return min(nb, self.max_blocks_per_seq) * self.block_size

    @torch.inference_mode()
    def prefill(self, table_row, tokens, temperature: float = 0.0,
                rid: int = 0, prefix_len: int = 0):
        """Prefill one sequence; -> (first generated token: int, last-
        position logits ``[V]`` fp32 tensor).  ``table_row``: the block ids
        backing the prompt (padded here with the null block).
        ``prefix_len > 0``: the first ``prefix_len`` tokens' K/V already
        sit in the row's leading blocks (a prefix-cache hit); only the
        suffix is computed."""
        p = len(tokens)
        if p > self.max_context:
            raise ValueError(f"prompt of {p} tokens > max context "
                             f"{self.max_context}")
        if prefix_len:
            return self._prefill_suffix(table_row, tokens, temperature,
                                        rid, prefix_len)
        p_pad = self.pad_len(p)
        row = list(table_row) + [PagedKVCache.NULL_BLOCK] * (
            p_pad // self.block_size - len(table_row))
        toks = np.zeros((p_pad,), np.int64)
        toks[:p] = tokens
        logits, _ = self.model.apply_prefill(
            self._prefill_params, self.cache, self._tensor(row, torch.int32),
            self._tensor(toks, torch.long)[None])
        last = logits[0, p - 1]
        nxt = sample_tokens(last[None], [temperature],
                            [sample_seed(self.seed, rid, p)], self.top_k)
        return int(nxt[0]), last

    def _prefill_suffix(self, table_row, tokens, temperature, rid,
                        prefix_len):
        p = len(tokens)
        if prefix_len % self.block_size:
            raise ValueError(f"prefix_len {prefix_len} is not a whole "
                             f"number of {self.block_size}-token blocks")
        if not 0 < prefix_len < p:
            raise ValueError(f"prefix_len {prefix_len} outside (0, {p}) — "
                             f"at least one token must stay uncached")
        s = p - prefix_len
        s_pad = self.pad_len(s)
        full_row = list(table_row) + [PagedKVCache.NULL_BLOCK] * (
            self.max_blocks_per_seq - len(table_row))
        n_prefix = prefix_len // self.block_size
        suffix_row = list(table_row[n_prefix:]) + [
            PagedKVCache.NULL_BLOCK] * (
            s_pad // self.block_size - (len(table_row) - n_prefix))
        toks = np.zeros((s_pad,), np.int64)
        toks[:s] = tokens[prefix_len:]
        logits, _ = self.model.apply_prefill_partial(
            self._prefill_params, self.cache,
            self._tensor(suffix_row, torch.int32),
            self._tensor(full_row, torch.int32),
            self._tensor(toks, torch.long)[None], prefix_len)
        last = logits[0, s - 1]
        nxt = sample_tokens(last[None], [temperature],
                            [sample_seed(self.seed, rid, p)], self.top_k)
        return int(nxt[0]), last

    @torch.inference_mode()
    def decode(self, tables, lengths, tokens, temps, rids):
        """One decode step over the fixed batch; -> (next tokens ``[B]``
        np.int32, logits ``[B, V]`` fp32 tensor on the engine's device).
        Arguments are host arrays of length ``max_batch``; inactive slots
        pass null table rows and length 0 (their outputs are garbage)."""
        self.cache.block_tables = self._tensor(tables, torch.int32)
        positions = self._tensor(lengths, torch.int32)
        logits, _ = self.model.apply_decode(
            self._decode_params, self.cache, positions,
            self._tensor(tokens, torch.long))
        seeds = [sample_seed(self.seed, int(r), int(n) + 1)
                 for r, n in zip(rids, lengths)]
        return sample_tokens(logits, temps, seeds, self.top_k), logits
