"""int8 weight-only quantization of a serving param tree.

Counterpart of ``theanompi_tpu/serving/quant.py``: the same leaf predicate
(matmul weights named ``w``/``up_w``/``down_w`` with >= 2 dims; nothing
under an embedding, position table or MoE gate) and the same chunked
format (:mod:`theanompi_torch.ops.quant`).  Quantization draws its
rounding noise from an explicit ``torch.Generator``, one leaf after the
other in tree order, so it is a seeded, reproducible transform.
"""

from __future__ import annotations

import torch

from theanompi_torch.ops.quant import QuantizedTensor, quantize_chunked
from theanompi_torch.tree import tree_leaves_with_path, tree_map_with_path

#: default elements per quantization chunk (one fp32 scale each)
DEFAULT_CHUNK_ELEMS = 1024

_MATMUL_LEAF_NAMES = ("w", "up_w", "down_w")
_SKIP_COMPONENTS = ("embedding", "positionembedding", "gate")


def _should_quantize(path, leaf) -> bool:
    if any(skip in str(part) for part in path for skip in _SKIP_COMPONENTS):
        return False
    if not path or path[-1] not in _MATMUL_LEAF_NAMES:
        return False
    return (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.ndim >= 2)


def quantize_tree(params, gen: torch.Generator,
                  chunk_elems: int = DEFAULT_CHUNK_ELEMS,
                  predicate=_should_quantize):
    """Quantize the matmul-weight leaves; -> (tree with
    :class:`QuantizedTensor` leaves, stats dict)."""
    stats = {"quantized_leaves": 0,
             "total_leaves": len(tree_leaves_with_path(params)),
             "bytes_before": 0, "bytes_after": 0}

    def leaf(path, x):
        if not predicate(path, x):
            return x
        q, scales = quantize_chunked(x, gen, chunk_elems)
        qt = QuantizedTensor(q, scales, tuple(x.shape), x.dtype)
        stats["quantized_leaves"] += 1
        stats["bytes_before"] += x.numel() * x.element_size()
        stats["bytes_after"] += qt.nbytes_quantized
        return qt

    return tree_map_with_path(leaf, params), stats


def dequantize_tree(params):
    """Materialize float weights from a (possibly) quantized tree."""

    def leaf(_path, x):
        if isinstance(x, QuantizedTensor):
            return x.dequantize()
        return x

    return tree_map_with_path(leaf, params)


def is_quantized_tree(params) -> bool:
    return any(isinstance(x, QuantizedTensor)
               for _, x in tree_leaves_with_path(params))
