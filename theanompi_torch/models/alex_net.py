"""AlexNet on ImageNet: five convolutions (LRN after the first two),
three max-pools, two dropout FC-4096 layers and a 1000-way head.

Counterpart of ``theanompi_tpu/models/alex_net.py`` (``AlexNet`` :26),
with its param tree (``NN_conv2d``, ``NN_dense``) and config:
``lrn`` (on by default, :class:`~theanompi_torch.ops.layers.LRN` after
conv1 and conv2), ``grouped`` (conv2, conv4 and conv5 in two groups, the
original two-GPU split) and ``dropout``.  The convolutions, pools and
matmuls run in cuDNN and cuBLAS through PyTorch: the reference wrote no
kernel for this model.
"""

from __future__ import annotations

from theanompi_torch.models.contract import SupervisedModel
from theanompi_torch.models.data.imagenet import ImageNetData
from theanompi_torch.ops import initializers as init_lib
from theanompi_torch.ops import layers as L


class AlexNet(SupervisedModel):
    default_config = {
        "batch_size": 128,
        "n_epochs": 70,
        "lr": 0.01,
        "lr_decay_epochs": (20, 40, 60),
        "lr_decay_factor": 0.1,
        "momentum": 0.9,
        "weight_decay": 5e-4,
        "image_size": 224,
        "n_classes": 1000,
        "lrn": True,
        "dropout": 0.5,
        "grouped": False,  # 2-group conv2/4/5 (Krizhevsky two-GPU split)
    }

    def build_data(self):
        return ImageNetData(self.config)

    def build_net(self):
        cfg = self.config
        g = 2 if cfg["grouped"] else 1

        def lrn():
            return [L.LRN(size=5)] if cfg["lrn"] else []

        layers: list[L.Layer] = [
            L.Conv2D(96, 11, stride=4, padding=2),
            L.Activation("relu"),
            *lrn(),
            L.MaxPool(3, stride=2),
            L.Conv2D(256, 5, padding=2, groups=g),
            L.Activation("relu"),
            *lrn(),
            L.MaxPool(3, stride=2),
            L.Conv2D(384, 3, padding=1),
            L.Activation("relu"),
            L.Conv2D(384, 3, padding=1, groups=g),
            L.Activation("relu"),
            L.Conv2D(256, 3, padding=1, groups=g),
            L.Activation("relu"),
            L.MaxPool(3, stride=2),
            L.Flatten(),
            L.Dense(4096, w_init=init_lib.he_normal),
            L.Activation("relu"),
            L.Dropout(cfg["dropout"]),
            L.Dense(4096, w_init=init_lib.he_normal),
            L.Activation("relu"),
            L.Dropout(cfg["dropout"]),
            L.Dense(cfg["n_classes"], w_init=init_lib.glorot_normal),
        ]
        s = cfg["image_size"]
        return L.Sequential(layers), (3, s, s)
