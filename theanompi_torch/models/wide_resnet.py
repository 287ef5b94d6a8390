"""Wide-ResNet on CIFAR-10: pre-activation BN-ReLU-Conv blocks in three
stages, global average pool, a dense head.

Counterpart of ``theanompi_tpu/models/wide_resnet.py`` (``_WRNBlock`` :27,
``WideResNet`` :80), with the reference's param and state trees
(``00_conv2d``, ``NN__wrnblock/{bn1, conv1, bn2, conv2, proj}``,
``NN_batchnorm``, ``NN_dense``) and conv kernels in OIHW.  Config:
``depth`` (6n+4) and ``widen`` (k), WRN-16-4 by default.
"""

from __future__ import annotations

import torch.nn.functional as F

from theanompi_torch.models.contract import SupervisedModel
from theanompi_torch.models.data.cifar10 import Cifar10Data
from theanompi_torch.ops import initializers as init_lib
from theanompi_torch.ops import layers as L


class _WRNBlock(L.StatefulLayer):
    """Pre-activation residual block: BN-ReLU-Conv twice, with a 1x1
    projection of the first activation when the width or stride
    changes."""

    def __init__(self, filters: int, stride: int = 1, bn_axis=None):
        super().__init__()
        self.filters = filters
        self.stride = stride
        self.bn1 = L.BatchNorm(axis_name=bn_axis)
        self.conv1 = L.Conv2D(filters, 3, stride=stride, use_bias=False)
        self.bn2 = L.BatchNorm(axis_name=bn_axis)
        self.conv2 = L.Conv2D(filters, 3, use_bias=False)
        self.proj = L.Conv2D(filters, 1, stride=stride, use_bias=False)

    def init_stateful(self, gen, in_shape):
        params, state, shape = {}, {}, tuple(in_shape)
        for name in ("bn1", "conv1", "bn2", "conv2"):
            p, s, shape = getattr(self, name).init_stateful(gen, shape)
            params[name] = p
            if s:
                state[name] = s
        if in_shape[0] != self.filters or self.stride != 1:
            params["proj"], _ = self.proj.init(gen, in_shape)
        return params, state, shape

    def apply_stateful(self, params, state, x, train: bool = False,
                       gen=None):
        new_state = dict(state)
        h, new_state["bn1"] = self.bn1.apply_stateful(
            params["bn1"], state["bn1"], x, train)
        h = F.relu(h)
        shortcut = self.proj(params["proj"], h) if "proj" in params else x
        h = self.conv1(params["conv1"], h)
        h, new_state["bn2"] = self.bn2.apply_stateful(
            params["bn2"], state["bn2"], h, train)
        h = self.conv2(params["conv2"], F.relu(h))
        return h + shortcut, new_state


class WideResNet(SupervisedModel):
    """WRN-depth-widen on CIFAR-10."""

    default_config = {
        "depth": 16,
        "widen": 4,
        "batch_size": 128,
        "n_epochs": 60,
        "lr": 0.1,
        "lr_decay_epochs": (30, 45),
        "lr_decay_factor": 0.2,
        "momentum": 0.9,
        "weight_decay": 5e-4,
        "nesterov": True,
        "image_size": 32,
        # sync-BN over process groups: not ported, BatchNorm raises
        "bn_axis": None,
    }

    def build_data(self):
        return Cifar10Data(self.config)

    def build_net(self):
        cfg = self.config
        depth, k = cfg["depth"], cfg["widen"]
        if (depth - 4) % 6 != 0:
            raise ValueError("WRN depth must be 6n+4")
        n = (depth - 4) // 6
        bn_axis = cfg["bn_axis"]
        widths = [16, 16 * k, 32 * k, 64 * k]
        layers: list[L.Layer] = [L.Conv2D(widths[0], 3, use_bias=False)]
        for stage, width in enumerate(widths[1:]):
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                layers.append(_WRNBlock(width, stride=stride,
                                        bn_axis=bn_axis))
        layers += [
            L.BatchNorm(axis_name=bn_axis),
            L.Activation("relu"),
            L.GlobalAvgPool(),
            L.Dense(self.data.n_classes, w_init=init_lib.glorot_normal),
        ]
        s = cfg["image_size"]
        return L.Sequential(layers), (3, s, s)
