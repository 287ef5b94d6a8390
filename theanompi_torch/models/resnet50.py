"""ResNet-50 on ImageNet: a 7x7/2 stem, a 3x3/2 max-pool, four stages of
bottleneck blocks (3, 4, 6, 3) with post-activation BN-ReLU, global
average pool, a 1000-way dense head.

Counterpart of ``theanompi_tpu/models/resnet50.py`` (``_Bottleneck`` :30,
``_SpaceToDepthStem`` :139, ``ResNet50`` :181), with the reference's param
and state trees (``00_conv2d`` or ``00__spacetodepthstem``,
``01_batchnorm``, ``NN__bottleneck/{conv1, bn1, conv2, bn2, conv3, bn3,
proj, proj_bn}``, ``NN_dense``) and conv kernels in OIHW.  Each block's
last BN scale starts at zero (``bn_scale_zero``), so the residual
branches start as the identity.  The convolutions and BatchNorm's
arithmetic run in cuDNN and PyTorch's own kernels: the reference wrote no
kernel for this model.

``remat="save_convs"`` (the reference's recompute of the BN-ReLU chain in
the backward) is not ported yet and raises (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import torch.nn.functional as F

from theanompi_torch.models.contract import SupervisedModel
from theanompi_torch.models.data.imagenet import ImageNetData
from theanompi_torch.ops import initializers as init_lib
from theanompi_torch.ops import layers as L


class _Bottleneck(L.StatefulLayer):
    """1x1 reduce -> 3x3 (the stride) -> 1x1 expand to ``4 * filters``,
    BN after each conv and ReLU after the first two; a 1x1 projection and
    its BN on the shortcut when the width or stride changes; ReLU of the
    sum."""

    def __init__(self, filters: int, stride: int = 1, bn_axis=None,
                 zero_init_last: bool = True):
        super().__init__()
        self.filters = filters
        self.stride = stride
        last_scale = init_lib.zeros if zero_init_last else init_lib.ones
        self.conv1 = L.Conv2D(filters, 1, use_bias=False)
        self.bn1 = L.BatchNorm(axis_name=bn_axis)
        self.conv2 = L.Conv2D(filters, 3, stride=stride, padding=1,
                              use_bias=False)
        self.bn2 = L.BatchNorm(axis_name=bn_axis)
        self.conv3 = L.Conv2D(4 * filters, 1, use_bias=False)
        self.bn3 = L.BatchNorm(axis_name=bn_axis, scale_init=last_scale)
        self.proj = L.Conv2D(4 * filters, 1, stride=stride, use_bias=False)
        self.proj_bn = L.BatchNorm(axis_name=bn_axis)

    _MAIN = ("conv1", "bn1", "conv2", "bn2", "conv3", "bn3")

    def init_stateful(self, gen, in_shape):
        names = list(self._MAIN)
        if in_shape[0] != 4 * self.filters or self.stride != 1:
            names += ["proj", "proj_bn"]
        params, state = {}, {}
        shapes = {"main": tuple(in_shape), "proj": tuple(in_shape)}
        for name in names:
            path = "proj" if name.startswith("proj") else "main"
            p, s, shapes[path] = getattr(self, name).init_stateful(
                gen, shapes[path])
            params[name] = p
            if s:
                state[name] = s
        return params, state, shapes["main"]

    def apply_stateful(self, params, state, x, train: bool = False,
                       gen=None):
        new_state = dict(state)
        h = x
        for name in self._MAIN:
            h, s = getattr(self, name).apply_stateful(
                params[name], state.get(name, {}), h, train)
            if s:
                new_state[name] = s
            if name in ("bn1", "bn2"):
                h = F.relu(h)
        shortcut = x
        if "proj" in params:
            shortcut = self.proj(params["proj"], x)
            shortcut, new_state["proj_bn"] = self.proj_bn.apply_stateful(
                params["proj_bn"], state["proj_bn"], shortcut, train)
        return F.relu(h + shortcut), new_state


class _SpaceToDepthStem(L.Layer):
    """The 7x7/2 stem conv as a stride-1 4x4 conv over 2x2 pixel blocks
    moved into channels (``[C, H, W] -> [4C, H/2, W/2]``), with the kernel
    zero-padded to 8x8 and rearranged the same way: the same linear map,
    math-identical to the plain stem.  The param stays the logical
    ``[F, C, 7, 7]`` kernel; the rearrangement happens at apply time."""

    def __init__(self, filters: int = 64, w_init=init_lib.he_normal):
        super().__init__()
        self.filters = filters
        self.w_init = w_init

    def init(self, gen, in_shape):
        c, h, w = in_shape
        if h % 2 or w % 2:
            raise ValueError(f"space-to-depth stem needs even H/W, got "
                             f"{tuple(in_shape)}")
        return ({"w": self.w_init(gen, (self.filters, c, 7, 7))},
                (self.filters, h // 2, w // 2))

    def forward(self, params, x):
        n, c, h, w = x.shape
        f = self.filters
        # channel (di * 2 + dj) * C + c holds pixel (2i + di, 2j + dj)
        xs = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
        xs = xs.reshape(n, 4 * c, h // 2, w // 2)
        k = F.pad(params["w"].to(x.dtype), (1, 0, 1, 0))  # zero row/col 0
        k = k.reshape(f, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
        k = k.reshape(f, 4 * c, 4, 4)
        return F.conv2d(F.pad(xs, (2, 1, 2, 1)), k)


class ResNet50(SupervisedModel):
    default_config = {
        "batch_size": 64,
        "n_epochs": 90,
        "lr": 0.1,
        "lr_decay_epochs": (30, 60, 80),
        "lr_decay_factor": 0.1,
        "momentum": 0.9,
        "weight_decay": 1e-4,
        "nesterov": True,
        "image_size": 224,
        "n_classes": 1000,
        # sync-BN over process groups: not ported, BatchNorm raises
        "bn_axis": None,
        "bn_scale_zero": True,
        "stage_blocks": (3, 4, 6, 3),
        # "save_convs" is not ported yet (raises)
        "remat": "none",
        # "space_to_depth": the math-identical stem; "conv7" the plain one
        "stem": "conv7",
    }

    def build_data(self):
        return ImageNetData(self.config)

    def build_net(self):
        cfg = self.config
        bn_axis = cfg["bn_axis"]
        if cfg["stem"] not in ("conv7", "space_to_depth"):
            raise ValueError(f"stem {cfg['stem']!r} not in ('conv7', "
                             f"'space_to_depth')")
        if cfg["remat"] not in ("none", "save_convs"):
            raise ValueError(f"remat {cfg['remat']!r} not in ('none', "
                             f"'save_convs')")
        if cfg["remat"] == "save_convs":
            raise NotImplementedError(
                "remat='save_convs' not yet ported (ROADMAP queue 1 item 9)")
        stem = (_SpaceToDepthStem(64) if cfg["stem"] == "space_to_depth"
                else L.Conv2D(64, 7, stride=2, padding=3, use_bias=False))
        layers: list[L.Layer] = [
            stem,
            L.BatchNorm(axis_name=bn_axis),
            L.Activation("relu"),
            L.MaxPool(3, stride=2, padding="SAME"),
        ]
        widths = (64, 128, 256, 512)
        for stage, (w, blocks) in enumerate(zip(widths,
                                                cfg["stage_blocks"])):
            for i in range(blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                layers.append(_Bottleneck(
                    w, stride=stride, bn_axis=bn_axis,
                    zero_init_last=cfg["bn_scale_zero"]))
        layers += [
            L.GlobalAvgPool(),
            L.Dense(cfg["n_classes"], w_init=init_lib.glorot_normal),
        ]
        s = cfg["image_size"]
        return L.Sequential(layers), (3, s, s)
