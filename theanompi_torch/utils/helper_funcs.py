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


def as_step_tensor(x) -> torch.Tensor:
    """A numpy (or tensor) leaf as a tensor of the dtype the step takes,
    where it lies: uint8 stays uint8 (an image batch crosses as a quarter
    of its fp32 bytes, an eighth of int64's), other integers become
    int64, floating leaves keep their dtype."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if not t.is_floating_point() and t.dtype != torch.uint8:
        t = t.long()
    return t


def to_device(batch: dict, device) -> dict:
    """A numpy (or tensor) batch on ``device``, each leaf as
    :func:`as_step_tensor` makes it (free for a batch already there)."""
    return {k: as_step_tensor(x).to(device) for k, x in batch.items()}
