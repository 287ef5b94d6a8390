"""Reference weights into the port and back: param trees, model state
and int8 payloads.

The reference's trees (nested dicts of arrays, handed over as numpy) map
1:1 onto the port's, under the same keys:

- ``TransformerLM``: ``00_embedding``, ``01_positionembedding``,
  ``NN__block/{ln1, attn/{q,k,v,o}, ln2, up, down}``, the final
  ``NN_layernorm`` and ``head``; ``MoETransformerLM`` the same with
  ``NN__moeblock/{ln1, attn, ln2, moe/{gate/w, up_w, up_b, down_w,
  down_b}}`` (the experts stacked on dim 0, as they are) and the state
  ``NN__moeblock/moe/aux``;
- the conv nets: ``00_conv2d`` or ``00__spacetodepthstem``,
  ``NN_batchnorm``, ``NN__wrnblock/...``, ``NN__bottleneck/...``,
  ``NN__inception/b0..b3/...`` and ``NN_dense``, GoogLeNet with aux heads
  as ``seg0..2`` and ``aux0..1``; their state (BatchNorm's
  ``mean``/``var``) under the same keys;
- the LSTM LM: ``00_embedding``, ``NN_lstm/{wx, wh, b}`` (2-D, as they
  are), ``NN_dense``;
- the GAN: ``gen`` and ``disc``, each a Sequential's tree (the
  generator's ``NN_convtranspose2d`` kernels take the generic 4-D
  transpose too: the layer flips and swaps them for
  ``F.conv_transpose2d`` itself), and an optimizer state per network.

Only the top-level key is checked: one that no port layer carries
raises ``KeyError``.

Layouts: conv kernels are the one leaf that changes.  The reference holds
them HWIO ``[kh, kw, in, out]``, the port OIHW ``[out, in, kh, kw]``
(``F.conv2d``'s), so every 4-D leaf is transposed on the way in and back
on the way out.  Dense weights stay ``[Din, Dout]`` used as ``x @ w``: the
int8 chunk and band layout depends on that row-major flatten, so nothing
is transposed into ``nn.Linear``'s layout.

``zero1``'s optimizer state: the reference keeps global flat ``(padded,)``
bucket buffers sharded over the ``data`` axis (``{"velocity": [buf,
...]}``), a rank of the port only its ``padded // n`` slice of each:
:func:`zero1_opt_state_from_jax` cuts rank r's slices out of the
reference's buffers, :func:`zero1_opt_state_to_jax` joins the ranks'
slices back.  Replicated entries (Adam's step ``t``) are the same on both
sides.

The train state of a checkpoint: the reference's ``.npz`` keys a leaf
``"<tree>::<path joined by />"`` (``params``, ``state``, ``opt_state``),
conv kernels HWIO.  :func:`train_state_to_jax` maps the trainer's trees
(host tensors) to those flat leaves, :func:`train_state_from_jax` back
into the trainer's templates: params and state as above, the per-leaf
optimizer states (SGD's ``{"velocity": tree}``, Adam's ``{"m", "v",
"t"}``, RMSProp's ``{"sq"}``) by :func:`opt_state_to_jax` /
:func:`opt_state_from_jax`, and ``zero1``'s global buckets in the
reference's element order, from which each rank cuts its slice.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from theanompi_torch.ops.quant import QuantizedTensor
from theanompi_torch.tree import tree_map
from theanompi_torch.utils.checkpoint import flat_leaves, restore_into

_TOP_KEY = re.compile(
    r"^(\d{2}_(embedding|positionembedding|_block|_moeblock|layernorm|"
    r"conv2d|batchnorm|_wrnblock|_bottleneck|_spacetodepthstem|dense|lstm|"
    r"_inception|convtranspose2d)|head|seg\d|aux\d|gen|disc)$")
#: the GAN's two networks, each with an optimizer state of its own
_GAN_NETS = ("gen", "disc")
#: HWIO -> OIHW, and back
_TO_OIHW, _TO_HWIO = (3, 2, 0, 1), (2, 3, 1, 0)


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _walk(tree, leaf, what):
    """Convert ``tree`` leaf by leaf; raises ``KeyError`` on a top-level
    key the port has no layer for."""
    def node(x):
        return {k: node(v) for k, v in x.items()} if isinstance(
            x, dict) else leaf(x)

    out = {}
    for key, sub in tree.items():
        if not _TOP_KEY.match(key):
            raise KeyError(f"{what}: no port layer for {key!r}")
        out[key] = node(sub)
    return out


def _from_jax(x) -> torch.Tensor:
    t = _tensor(x)
    return t.permute(*_TO_OIHW).contiguous() if t.ndim == 4 else t


def _to_jax(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t.permute(*_TO_HWIO) if t.ndim == 4 else t).numpy().copy()


def params_from_jax(tree) -> dict:
    """The reference's param tree (nested dicts of numpy arrays) -> the
    port's (nested dicts of CPU tensors, same dtypes; conv kernels
    OIHW)."""
    return _walk(tree, _from_jax, "params_from_jax")


def params_to_jax(tree) -> dict:
    """The port's param tree -> the reference's (numpy; conv kernels
    HWIO): the inverse of :func:`params_from_jax`."""
    return _walk(tree, _to_jax, "params_to_jax")


def state_from_jax(tree) -> dict:
    """The reference's model state (BatchNorm ``mean``/``var``, numpy) ->
    the port's (CPU tensors)."""
    return _walk(tree, _tensor, "state_from_jax")


def state_to_jax(tree) -> dict:
    """The port's model state -> the reference's (numpy)."""
    return _walk(tree, _to_jax, "state_to_jax")


def quantized_from_jax(q, scales, shape, dtype) -> QuantizedTensor:
    """One int8 leaf of the reference (``QuantizedTensor`` ``q``
    ``[n_chunks, chunk]`` int8, ``scales`` ``[n_chunks]`` fp32, the
    original shape and dtype) -> the port's, same bytes."""
    q = _tensor(q)
    if q.dtype != torch.int8 or q.ndim != 2:
        raise ValueError(f"quantized_from_jax: payload {q.dtype} "
                         f"{tuple(q.shape)} is not [n_chunks, chunk] int8")
    return QuantizedTensor(q, _tensor(scales).float(),
                           tuple(int(s) for s in shape),
                           _torch_dtype(dtype))


def _torch_dtype(dtype) -> torch.dtype:
    name = str(dtype)
    return getattr(torch, name if name == "bfloat16" else np.dtype(name).name)



def _relayout(buf: np.ndarray, bucket, to_port: bool) -> np.ndarray:
    """One global flat bucket between the two layouts: a 4-D leaf's
    elements sit HWIO-ordered in the reference's buffer, OIHW in the
    port's (``bucket`` is the port's, from ``Exchanger.zero1_layout``)."""
    out, off = [], 0
    for size, shape in zip(bucket.sizes, bucket.shapes):
        leaf = buf[off:off + size]
        if len(shape) == 4:
            hwio = tuple(shape[i] for i in _TO_HWIO)
            leaf = (leaf.reshape(hwio).transpose(_TO_OIHW) if to_port else
                    leaf.reshape(shape).transpose(_TO_HWIO)).reshape(-1)
        out.append(leaf)
        off += size
    out.append(buf[off:])  # the padding
    return np.concatenate(out)


def opt_state_to_jax(opt_state: dict) -> dict:
    """A per-leaf optimizer state of the port (params-shaped trees and
    replicated scalars; the GAN's ``{"gen": ..., "disc": ...}``, one
    each) -> the reference's (numpy; conv kernels HWIO)."""
    return {k: opt_state_to_jax(v) if k in _GAN_NETS else
            params_to_jax(v) if isinstance(v, dict) else _to_jax(v)
            for k, v in opt_state.items()}


def opt_state_from_jax(opt_state: dict) -> dict:
    """The reference's per-leaf optimizer state -> the port's (CPU
    tensors; conv kernels OIHW): the inverse of
    :func:`opt_state_to_jax`."""
    return {k: opt_state_from_jax(v) if k in _GAN_NETS else
            params_from_jax(v) if isinstance(v, dict) else _tensor(v)
            for k, v in opt_state.items()}


def zero1_opt_state_from_jax(opt_state: dict, layout: list, rank: int,
                             n: int) -> dict:
    """The reference's ``zero1`` optimizer state (numpy: lists of global
    ``(padded,)`` buckets, replicated scalars) -> rank ``rank`` of ``n``'s
    (CPU tensors: chunk ``rank`` of each bucket's ``reshape(n, -1)``, conv
    kernels' elements in the port's order).  ``layout``: the port's
    ``Exchanger.zero1_layout(params, n)``."""
    return {k: [_tensor(_relayout(np.asarray(buf), b, True)
                        .reshape(n, -1)[rank]) for buf, b in zip(v, layout)]
            if isinstance(v, list) else _tensor(v)
            for k, v in opt_state.items()}


def zero1_opt_state_to_jax(rank_states: list, layout: list) -> dict:
    """The ranks' ``zero1`` optimizer states, in rank order -> the
    reference's (numpy: each bucket's slices joined and in its element
    order; replicated entries from rank 0): the inverse of
    :func:`zero1_opt_state_from_jax`."""
    return zero1_global_to_jax(
        {k: [np.concatenate([_to_jax(s[k][i]) for s in rank_states])
             for i in range(len(layout))] if isinstance(v, list) else v
         for k, v in rank_states[0].items()}, layout)


def zero1_global_to_jax(opt_state: dict, layout: list) -> dict:
    """A ``zero1`` optimizer state of global ``(padded,)`` buckets in the
    port's element order (the ranks' slices gathered,
    ``Exchanger.zero1_gather_opt_state``) -> the reference's."""
    return {k: [_relayout(_to_jax(buf) if hasattr(buf, "detach") else buf,
                          b, False) for buf, b in zip(v, layout)]
            if isinstance(v, list) else _to_jax(v)
            for k, v in opt_state.items()}


def train_state_to_jax(trees: dict, zero1_layout: list | None = None) -> dict:
    """The trainer's checkpoint trees (``params``, ``state``,
    ``opt_state``; host tensors in the port's layouts) -> the reference's
    flat ``{"<tree>::<path>": ndarray}``.  ``zero1_layout``: the port's
    ``Exchanger.zero1_layout`` when ``opt_state`` holds ``zero1``'s global
    buckets."""
    out = {}
    for name, tree in trees.items():
        if name == "opt_state":
            tree = (zero1_global_to_jax(tree, zero1_layout)
                    if zero1_layout is not None else opt_state_to_jax(tree))
        elif name == "params":
            tree = params_to_jax(tree)
        else:
            tree = tree_map(_to_jax, tree)
        out.update(flat_leaves(name, tree))
    return out


def _to_template(arr: np.ndarray) -> np.ndarray:
    """A stored leaf in its template's layout: 4-D HWIO -> OIHW."""
    return np.transpose(arr, _TO_OIHW) if arr.ndim == 4 else arr


def _zero1_from_flat(sub: dict, template: dict, layout: list, rank: int,
                     n: int) -> dict:
    ref = {}
    for k, v in template.items():
        if not isinstance(v, list):
            if k not in sub:
                raise KeyError(f"checkpoint missing leaf {k!r}")
            ref[k] = sub[k]
            continue
        bufs = []
        for i, b in enumerate(layout):
            key = f"{k}/{i}"
            if key not in sub:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            if sub[key].shape != (b.padded,):
                raise ValueError(
                    f"checkpoint leaf {key!r} shape {sub[key].shape} != "
                    f"expected {(b.padded,)} (zero1 bucket {i} at "
                    f"{n} rank(s))")
            bufs.append(sub[key])
        ref[k] = bufs
    mine = zero1_opt_state_from_jax(ref, layout, rank, n)
    return tree_map(lambda x, t: x.to(device=t.device, dtype=t.dtype),
                    mine, template)


def train_state_from_jax(arrays: dict, templates: dict,
                         zero1: tuple | None = None) -> dict:
    """The reference's flat leaves (``{"<tree>::<path>": ndarray}``, as
    :func:`train_state_to_jax` writes them) -> trees shaped, typed and
    placed like ``templates`` (the trainer's fresh state).  ``zero1``:
    ``(layout, rank, n)`` when ``opt_state`` is this rank's ``zero1``
    slices, cut from the file's global buckets.  A missing leaf raises
    ``KeyError``, a shape that differs from the template's ``ValueError``."""
    out = {}
    for name, template in templates.items():
        sub = {k.split("::", 1)[1]: v for k, v in arrays.items()
               if k.startswith(f"{name}::")}
        if name == "opt_state" and zero1 is not None:
            out[name] = _zero1_from_flat(sub, template, *zero1)
        else:
            out[name] = restore_into(template, sub, convert=_to_template)
    return out
