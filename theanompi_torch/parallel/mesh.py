"""Precision policy and the device rule.

Counterpart of ``theanompi_tpu/parallel/mesh.py``'s ``Precision``/``FP32``/
``BF16``.  The port runs one process per GPU; the mesh's ``data`` axis is
the process group of :mod:`theanompi_torch.dist`.

The device rule every entry point follows: ``device=None`` means the
card (``cuda``; a rank of a process group takes its own,
``cuda:<local rank>``); with no CUDA available it raises rather than
quietly running on the CPU.  Only an explicit ``device="cpu"`` (what the
tests pass) runs on the host.
"""

from __future__ import annotations

import dataclasses

import torch

from theanompi_torch import dist as tdist
from theanompi_torch.tree import tree_map


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` -> ``cuda`` (raises
    ``RuntimeError`` when CUDA is unavailable); anything else as given,
    with a CUDA request also checked.  In a process group of more than
    one rank, ``None`` and ``"cuda"`` name the rank's own card,
    ``cuda:<local rank>``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: theanompi_torch runs on the card unless "
                "the caller asks for device='cpu'")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is "
                           f"unavailable")
    if dev.type == "cuda" and dev.index is None and tdist.world() > 1:
        return torch.device("cuda", tdist.local_rank())
    return dev


@dataclasses.dataclass(frozen=True)
class Precision:
    """Mixed-precision policy: fp32 params, ``compute_dtype`` compute
    (the model casts its logits up to fp32 at the head)."""

    compute_dtype: torch.dtype = torch.bfloat16

    def cast_to_compute(self, tree):
        """Cast every floating tensor leaf (LayerNorm params included) to
        the compute dtype.  Non-tensor leaves — the int8
        ``QuantizedTensor``, whose fp32 scales must stay fp32 — pass
        through whole.  A leaf already in the compute dtype is returned
        as is (no copy)."""
        def cast(x):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                return x.to(self.compute_dtype)
            return x

        return tree_map(cast, tree)


#: Full precision everywhere — CPU tests and numerical parity.  On the
#: card, an fp32 convolution is whatever cuDNN runs under
#: ``torch.backends.cudnn.allow_tf32``, which PyTorch leaves on: TF32
#: (inputs rounded to 10-bit mantissas, fp32 sums) unless the caller turns
#: it off; the port's entry points leave the flag as they find it (fp32
#: matmuls follow ``torch.backends.cuda.matmul.allow_tf32``, off by
#: default).  ``chip_smoke.py`` turns both off, so its fp32 runs are
#: IEEE fp32.
FP32 = Precision(compute_dtype=torch.float32)
#: The serving default on the card.
BF16 = Precision()
