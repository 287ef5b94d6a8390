"""Reference weights into the port: param trees and int8 payloads.

The reference's param tree (nested dicts of arrays, handed over as numpy)
maps 1:1 onto the port's: the same keys — ``00_embedding``,
``01_positionembedding``, ``NN__block/{ln1, attn/{q,k,v,o}, ln2, up,
down}``, the final ``NN_layernorm`` and ``head`` — and the same layouts.
Dense weights stay ``[Din, Dout]`` used as ``x @ w``: the int8 chunk and
band layout depends on that row-major flatten, so nothing is transposed
into ``nn.Linear``'s layout.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from theanompi_torch.ops.quant import QuantizedTensor

_TOP_KEY = re.compile(
    r"^(\d{2}_(embedding|positionembedding|_block|layernorm)|head)$")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def params_from_jax(tree) -> dict:
    """The reference's ``TransformerLM`` param tree (nested dicts of numpy
    arrays) -> the port's (nested dicts of CPU tensors, same dtypes).
    Raises ``KeyError`` on a top-level key the port has no layer for."""
    out = {}
    for key, sub in tree.items():
        if not _TOP_KEY.match(key):
            raise KeyError(f"params_from_jax: no port layer for {key!r}")
        out[key] = _convert(sub)
    return out


def _convert(node):
    if isinstance(node, dict):
        return {k: _convert(v) for k, v in node.items()}
    return _tensor(node)


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
