"""VGG-16 on ImageNet (configuration D: 13 convolutions, 3 FC layers),
and the shallow VGG-11 (configuration A).

Counterpart of ``theanompi_tpu/models/vggnet_16.py`` (``VGGNet_16`` :26,
``VGGNet_11_Shallow`` :80), with its param and state trees
(``NN_conv2d``, ``NN_batchnorm``, ``NN_dense``) and config: ``shallow``
(VGG-11), ``bn`` (BatchNorm after every convolution, whose bias it then
drops; sync-BN over the process group with ``bn_axis="data"``, which BSP
sets above one rank), ``fc_width`` and ``dropout``.  The convolutions
run in cuDNN through PyTorch: the reference wrote no kernel for this
model.
"""

from __future__ import annotations

from theanompi_torch.models.contract import SupervisedModel
from theanompi_torch.models.data.imagenet import ImageNetData
from theanompi_torch.ops import initializers as init_lib
from theanompi_torch.ops import layers as L

# conv widths per stage; 'M' = 2x2 max-pool
_VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M")
_VGG11 = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")


class VGGNet_16(SupervisedModel):
    default_config = {
        "batch_size": 64,
        "n_epochs": 74,
        "lr": 0.01,
        "lr_decay_epochs": (50, 65),
        "lr_decay_factor": 0.1,
        "momentum": 0.9,
        "weight_decay": 5e-4,
        "image_size": 224,
        "n_classes": 1000,
        "dropout": 0.5,
        "shallow": False,
        "bn": False,
        "bn_axis": None,
        "fc_width": 4096,
    }

    def build_data(self):
        return ImageNetData(self.config)

    def build_net(self):
        cfg = self.config
        plan = _VGG11 if cfg["shallow"] else _VGG16
        layers: list[L.Layer] = []
        for item in plan:
            if item == "M":
                layers.append(L.MaxPool(2, stride=2))
                continue
            layers.append(L.Conv2D(item, 3, padding=1,
                                   use_bias=not cfg["bn"]))
            if cfg["bn"]:
                layers.append(L.BatchNorm(axis_name=cfg["bn_axis"]))
            layers.append(L.Activation("relu"))
        w = cfg["fc_width"]
        layers += [
            L.Flatten(),
            L.Dense(w, w_init=init_lib.he_normal),
            L.Activation("relu"),
            L.Dropout(cfg["dropout"]),
            L.Dense(w, w_init=init_lib.he_normal),
            L.Activation("relu"),
            L.Dropout(cfg["dropout"]),
            L.Dense(cfg["n_classes"], w_init=init_lib.glorot_normal),
        ]
        s = cfg["image_size"]
        return L.Sequential(layers), (3, s, s)


class VGGNet_11_Shallow(VGGNet_16):
    """The reference's shallow variant as its own class."""

    default_config = {**VGGNet_16.default_config, "shallow": True}
