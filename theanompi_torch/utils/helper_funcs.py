"""Model import by name and host-to-device batch placement.

Counterpart of ``theanompi_tpu/utils/helper_funcs.py``'s ``import_model``
and, for one process, its ``shard_batch``: a numpy batch goes to the
trainer's device whole, uint8 images as bytes (the model casts and
normalizes them there) and other integer arrays as int64 (what
``gather`` and indexing take).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


def import_model(modelfile: str, modelclass: str):
    """Resolve a model class from ``modelfile`` (module path) + class
    name, the reference's launch contract."""
    mod = importlib.import_module(modelfile)
    try:
        return getattr(mod, modelclass)
    except AttributeError as e:
        raise AttributeError(
            f"module {modelfile!r} has no class {modelclass!r}") from e


def to_device(batch: dict, device) -> dict:
    """A numpy (or tensor) batch on ``device``: uint8 leaves stay uint8
    (an image batch crosses as a quarter of its fp32 bytes, an eighth of
    int64's), other integer leaves become int64, floating leaves keep
    their dtype."""
    out = {}
    for k, x in batch.items():
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if not t.is_floating_point() and t.dtype != torch.uint8:
            t = t.long()
        out[k] = t.to(device)
    return out
