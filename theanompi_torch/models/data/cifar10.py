"""CIFAR-10: in-memory arrays, normalized on the host, with pad-crop-mirror
augmentation.

Counterpart of ``theanompi_tpu/models/data/cifar10.py`` (``pad_crop_mirror``
:25, ``Cifar10Data`` :54).  Real data loads from an ``.npz`` (keys
``x_train``/``y_train``/``x_test``/``y_test``, uint8 NHWC) named by
``config['data_path']`` or ``$CIFAR10_PATH``; without one, a
class-structured synthetic stand-in of the same shape (the reference's,
bit for bit) runs the same pipeline.  Batches are fp32 NHWC.
"""

from __future__ import annotations

import os

import numpy as np

from theanompi_torch.models.data.base import ArrayDataset, _class_structured

MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def pad_crop_mirror(x: np.ndarray, rng: np.random.RandomState, pad: int = 4):
    """Random pad-crop and horizontal mirror of an NHWC batch: reflect-pad
    by ``pad``, crop back to the input size at a random offset, flip half.
    The crop runs in C where :mod:`theanompi_torch.native` builds, else
    in the numpy loop (the reference implementation); the draws come
    first, so both give the same bytes."""
    from theanompi_torch import native

    n, h, w, _ = x.shape
    padded = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode="reflect")
    ys = rng.randint(0, 2 * pad + 1, n)
    xs = rng.randint(0, 2 * pad + 1, n)
    flips = rng.rand(n) < 0.5
    fast = native.crop_mirror_batch(padded, h, w, ys, xs, flips)
    if fast is not None:
        return fast
    out = np.empty_like(x)
    for i in range(n):
        img = padded[i, ys[i]: ys[i] + h, xs[i]: xs[i] + w]
        out[i] = img[:, ::-1] if flips[i] else img
    return out


class Cifar10Data(ArrayDataset):
    """Config keys: ``data_path``, ``n_train``/``n_val`` and ``image_size``
    (synthetic only), ``normalize`` (``"standard"``, or ``"tanh"`` for
    [-1, 1]), ``augment``."""

    def __init__(self, config: dict | None = None):
        config = config or {}
        path = config.get("data_path") or os.environ.get("CIFAR10_PATH")
        n_train = config.get("n_train", 2048)
        n_val = config.get("n_val", 512)
        s = config.get("image_size", 32)
        if path and os.path.exists(path):
            raw = np.load(path)
            xt = raw["x_train"].astype(np.float32) / 255.0
            xv = raw["x_test"].astype(np.float32) / 255.0
            yt = raw["y_train"].reshape(-1).astype(np.int32)
            yv = raw["y_test"].reshape(-1).astype(np.int32)
            self.synthetic = False
        else:
            xt, yt = _class_structured(n_train, (s, s, 3), 10, seed=0,
                                       noise=0.5, means_seed=0)
            xv, yv = _class_structured(n_val, (s, s, 3), 10, seed=1,
                                       noise=0.5, means_seed=0)
            # into a [0, 1]-ish range, so the normalization means something
            xt = 0.5 + 0.1 * xt
            xv = 0.5 + 0.1 * xv
            self.synthetic = True
        if config.get("normalize", "standard") == "tanh":
            xt = xt * 2.0 - 1.0
            xv = xv * 2.0 - 1.0
        else:
            xt = (xt - MEAN) / STD
            xv = (xv - MEAN) / STD
        augment = pad_crop_mirror if config.get("augment", True) else None
        super().__init__(xt.astype(np.float32), yt, xv.astype(np.float32),
                         yv, n_classes=10, augment_fn=augment)
