"""The kernel variants tools' substitutions still fit the sources.

``python -m theanompi_torch.kernels.{dkv,dq32,dkv32,fwd32}_variants`` time
the flash kernels against variants of their own design, each made by text
substitutions in ``kernels/csrc/flash_bwd.cu`` (the backward's tools) or
``kernels/csrc/flash_fwd.cu`` (``fwd32``) and their headers, and
``decode_variants`` the decode step's kernels (``int8_matmul.cu``,
``paged_decode.cu``); they run only on the card.  A substitution whose old text is no longer found
exactly once (the kernel edited, or a second kernel with the same line)
stops the tool there; this catches it here, on the CPU, for every variant
of every tool.
"""

from types import SimpleNamespace

import pytest

from theanompi_torch.kernels import (
    decode_variants,
    dkv32_variants,
    dkv_variants,
    dq32_variants,
    fwd32_variants,
)
from theanompi_torch.kernels.dkv_variants import variant_sources


@pytest.mark.parametrize("tool,source", [
    (dkv_variants, "flash_bwd.cu"), (dq32_variants, "flash_bwd.cu"),
    (dkv32_variants, "flash_bwd.cu"), (fwd32_variants, "flash_fwd.cu"),
    (SimpleNamespace(VARIANTS=decode_variants.INT8_VARIANTS),
     "int8_matmul.cu"),
    (SimpleNamespace(VARIANTS=decode_variants.PAGED_VARIANTS),
     "paged_decode.cu")],
    ids=["dkv", "dq32", "dkv32", "fwd32", "decode_int8", "decode_paged"])
def test_every_variant_substitutes_once(tool, source):
    plain = variant_sources("shipped", [], source)
    for name, subs in tool.VARIANTS.items():
        files = variant_sources(name, subs, source)
        assert (files == plain) == (not subs), name
