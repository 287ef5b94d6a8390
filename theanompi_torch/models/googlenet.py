"""GoogLeNet (Inception-v1) on ImageNet: the stem (7x7/2 convolution,
LRN), nine inception modules, global average pool and a dense head, and
with ``aux=True`` the two auxiliary classifiers tapped after inception 4a
and 4d, whose losses join at weight 0.3 in training (paper §5).

Counterpart of ``theanompi_tpu/models/googlenet.py`` (``_Inception``
:35, ``_TrunkWithTaps`` :113, ``GoogLeNet`` :185), with its param and
state trees: with ``aux=False`` one flat Sequential (``NN_conv2d``,
``NN__inception/b0..b3/...``, ``NN_dense``), with ``aux=True`` the trunk
in three segments ``seg0..2`` (stem to 4a, 4b to 4d, 4e to the logits)
and the heads ``aux0``, ``aux1``.  Config: ``lrn``, ``aux``, ``bn``
(BatchNorm after every convolution, replacing the LRN and the conv
biases; sync-BN over the process group with ``bn_axis="data"``) and
``dropout``.  Eval always runs the main path only.  The convolutions
run in cuDNN through PyTorch: the reference wrote no kernel for this
model.
"""

from __future__ import annotations

import torch
from torch import nn

from theanompi_torch.models.contract import SupervisedModel
from theanompi_torch.models.data.imagenet import ImageNetData
from theanompi_torch.ops import initializers as init_lib
from theanompi_torch.ops import layers as L


class _Inception(L.StatefulLayer):
    """Four parallel branches concatenated on channels: 1x1; 1x1 -> 3x3;
    1x1 -> 5x5; 3x3/1 max-pool -> 1x1.  ``spec`` = (n1x1, n3x3_reduce,
    n3x3, n5x5_reduce, n5x5, pool_proj); ``bn`` puts BatchNorm between
    every convolution and its ReLU."""

    def __init__(self, spec, bn: bool = False, bn_axis=None):
        super().__init__()
        self.spec = tuple(spec)
        self.bn = bn
        self.bn_axis = bn_axis
        n1, r3, n3, r5, n5, pp = self.spec
        self.branches = nn.ModuleList([
            L.Sequential(self._conv(n1, 1)),
            L.Sequential([*self._conv(r3, 1), *self._conv(n3, 3, 1)]),
            L.Sequential([*self._conv(r5, 1), *self._conv(n5, 5, 2)]),
            L.Sequential([L.MaxPool(3, stride=1, padding="SAME"),
                          *self._conv(pp, 1)]),
        ])

    def _conv(self, c, k, padding=0):
        conv = L.Conv2D(c, k, padding=padding, use_bias=not self.bn)
        if self.bn:
            return [conv, L.BatchNorm(axis_name=self.bn_axis),
                    L.Activation("relu")]
        return [conv, L.Activation("relu")]

    def init_stateful(self, gen, in_shape):
        params, state, out_c = {}, {}, 0
        for i, b in enumerate(self.branches):
            p, s, shape = b.init_stateful(gen, in_shape)
            if p:
                params[f"b{i}"] = p
            if s:
                state[f"b{i}"] = s
            out_c += shape[0]
        return params, state, (out_c, *in_shape[1:])

    def apply_stateful(self, params, state, x, train: bool = False,
                       gen=None):
        new_state, outs = dict(state), []
        for i, b in enumerate(self.branches):
            y, s = b.apply_stateful(params.get(f"b{i}", {}),
                                    state.get(f"b{i}", {}), x, train, gen)
            if s:
                new_state[f"b{i}"] = s
            outs.append(y)
        return torch.cat(outs, dim=1), new_state


# (module name, spec) in network order, with 'P' = 3x3/2 max-pool; the two
# aux-classifier taps (paper §5) sit after 4a and 4d
_PLAN = (
    ("3a", (64, 96, 128, 16, 32, 32)),
    ("3b", (128, 128, 192, 32, 96, 64)),
    "P",
    ("4a", (192, 96, 208, 16, 48, 64)),
    ("4b", (160, 112, 224, 24, 64, 64)),
    ("4c", (128, 128, 256, 24, 64, 64)),
    ("4d", (112, 144, 288, 32, 64, 64)),
    ("4e", (256, 160, 320, 32, 128, 128)),
    "P",
    ("5a", (256, 160, 320, 32, 128, 128)),
    ("5b", (384, 192, 384, 48, 128, 128)),
)


class _TrunkWithTaps(L.StatefulLayer):
    """The trunk in segments, a head on each of the first segments'
    outputs: ``apply_stateful`` runs the main path only,
    :meth:`apply_with_aux` the heads too."""

    def __init__(self, segs, heads=()):
        super().__init__()
        self.segs = nn.ModuleList(segs)
        self.heads = nn.ModuleList(heads)

    def init_stateful(self, gen, in_shape):
        params, state, shape, taps = {}, {}, tuple(in_shape), []
        for i, seg in enumerate(self.segs):
            params[f"seg{i}"], s, shape = seg.init_stateful(gen, shape)
            if s:
                state[f"seg{i}"] = s
            taps.append(shape)
        for i, head in enumerate(self.heads):
            params[f"aux{i}"], s, _ = head.init_stateful(gen, taps[i])
            if s:
                state[f"aux{i}"] = s
        return params, state, shape

    def _run_trunk(self, params, state, x, train, gen):
        new_state, taps = dict(state), []
        for i, seg in enumerate(self.segs):
            x, s = seg.apply_stateful(params[f"seg{i}"],
                                      state.get(f"seg{i}", {}), x, train,
                                      gen)
            if s:
                new_state[f"seg{i}"] = s
            taps.append(x)
        return x, taps, new_state

    def apply_stateful(self, params, state, x, train: bool = False,
                       gen=None):
        out, _, new_state = self._run_trunk(params, state, x, train, gen)
        return out, new_state

    def apply_with_aux(self, params, state, x, train: bool = False,
                       gen=None):
        """-> ((logits, aux logits tuple), new_state)."""
        out, taps, new_state = self._run_trunk(params, state, x, train, gen)
        aux = []
        for i, head in enumerate(self.heads):
            a, s = head.apply_stateful(params[f"aux{i}"],
                                       state.get(f"aux{i}", {}), taps[i],
                                       train, gen)
            if s:
                new_state[f"aux{i}"] = s
            aux.append(a)
        return (out, tuple(aux)), new_state


class GoogLeNet(SupervisedModel):
    default_config = {
        "batch_size": 32,
        "n_epochs": 80,
        "lr": 0.01,
        "lr_decay_epochs": (30, 55, 70),
        "lr_decay_factor": 0.1,
        "momentum": 0.9,
        "weight_decay": 2e-4,
        "image_size": 224,
        "n_classes": 1000,
        "lrn": True,
        "dropout": 0.4,
        "aux": False,  # paper §5 auxiliary classifiers (train-time only)
        # BN-GoogLeNet variant: BatchNorm after every conv, biases and LRN
        # dropped — the trainable-at-small-scale recipe (Inception-v2)
        "bn": False,
        "bn_axis": None,
    }

    def build_data(self):
        return ImageNetData(self.config)

    def _aux_head(self) -> L.Sequential:
        """Paper §5 head: avgpool 5x5/3, 1x1x128 conv, FC-1024, dropout
        0.7, FC.  Where the tap (``image_size // 16``) is under 5x5 the
        pool is global and the 1x1 conv a dense layer, as the
        reference's."""
        cfg = self.config
        big = cfg["image_size"] // 16 >= 5
        return L.Sequential([
            L.AvgPool(5, stride=3) if big else L.GlobalAvgPool(),
            L.Conv2D(128, 1) if big else L.Dense(
                128, w_init=init_lib.he_normal),
            L.Activation("relu"),
            L.Flatten(),
            L.Dense(1024, w_init=init_lib.he_normal),
            L.Activation("relu"),
            L.Dropout(0.7),
            L.Dense(cfg["n_classes"], w_init=init_lib.glorot_normal),
        ])

    def build_net(self):
        cfg = self.config
        self.aux = bool(cfg["aux"])
        bn, bn_axis = bool(cfg["bn"]), cfg["bn_axis"]

        def conv(c, k, stride=1, padding=0):
            out: list[L.Layer] = [L.Conv2D(c, k, stride=stride,
                                           padding=padding, use_bias=not bn)]
            if bn:
                out.append(L.BatchNorm(axis_name=bn_axis))
            out.append(L.Activation("relu"))
            return out

        def lrn():
            # BN replaces the LRN-era norms entirely (Inception-v2 recipe)
            return [L.LRN(size=5)] if (cfg["lrn"] and not bn) else []

        stem: list[L.Layer] = [
            *conv(64, 7, stride=2, padding=3),
            L.MaxPool(3, stride=2, padding="SAME"),
            *lrn(),
            *conv(64, 1),
            *conv(192, 3, padding=1),
            *lrn(),
            L.MaxPool(3, stride=2, padding="SAME"),
        ]
        # trunk segments split at the aux taps: [stem..4a], [4b..4d],
        # [4e..logits]
        segs: list[list[L.Layer]] = [stem, [], []]
        seg = 0
        for item in _PLAN:
            if item == "P":
                segs[seg].append(L.MaxPool(3, stride=2, padding="SAME"))
                continue
            segs[seg].append(_Inception(item[1], bn=bn, bn_axis=bn_axis))
            if item[0] == "4a":
                seg = 1
            elif item[0] == "4d":
                seg = 2
        segs[2] += [
            L.GlobalAvgPool(),
            L.Dropout(cfg["dropout"]),
            L.Dense(cfg["n_classes"], w_init=init_lib.glorot_normal),
        ]
        s = cfg["image_size"]
        if not self.aux:
            # one flat Sequential: the reference's aux=False tree
            return L.Sequential(segs[0] + segs[1] + segs[2]), (3, s, s)
        net = _TrunkWithTaps([L.Sequential(x) for x in segs],
                             [self._aux_head(), self._aux_head()])
        return net, (3, s, s)

    def apply_net(self, params, state, x, train: bool, gen=None):
        # paper §5: the aux losses join in training only; eval runs the
        # main path
        if not (train and self.aux):
            return super().apply_net(params, state, x, train, gen)
        (logits, aux), new_state = self.net.apply_with_aux(params, state, x,
                                                           train, gen)
        return logits, aux, new_state
