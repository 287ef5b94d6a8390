"""int8 weights: per-chunk scale + stochastic rounding, and the int8 matmul.

Counterpart of ``theanompi_tpu/ops/quant.py`` — the same wire format:

- **per-chunk fp32 scale**: one ``max|x| / 127`` per fixed-size chunk of
  the row-major flattened tensor;
- **stochastic rounding**: ``floor(y + U[0,1))``, unbiased, drawn from an
  explicit ``torch.Generator`` (the bits differ from ``jax.random``; a
  reference payload converts through :func:`theanompi_torch.convert.
  quantized_from_jax`).

With ``W [Din, Dout]`` flattened row-major, the chunks tile the 2D shape
without moving bytes when either each chunk spans whole rows
(``chunk % Dout == 0``: one row band) or each row spans whole chunks
(``Dout % chunk == 0``: ``Dout // chunk`` column bands) — see
:func:`_band_layout`.  :func:`int8_matmul` consumes that view directly
through kernel 5 (``kernels/csrc/int8_matmul.cu``) on the card, and
:func:`int8_matmul_ref` is its plain PyTorch version, which a CPU tensor
runs.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from theanompi_torch.kernels import Kernel, check_cuda, register, stream_ptr

INT8_MATMUL = register(Kernel(
    "int8_matmul", "int8_matmul.cu",
    "theanompi_tpu/ops/quant.py:122 (_int8_mm_kernel)"))

#: kernel 5's narrowest load is 4 int8 weights as one word, so a band's
#: column count must be a multiple of this (16-column bands, 16-byte
#: aligned, take its 16-byte loads)
_VEC = 4


def quantize_chunk(x: torch.Tensor, gen: torch.Generator):
    """-> (int8 payload, fp32 scale) for ONE chunk: per-chunk scale and
    stochastic rounding (``E[dequantize(q)] == x``); the scale guard keeps
    an all-zero chunk finite."""
    scale = torch.clamp(x.abs().max().float(), min=1e-30) / 127.0
    y = x.float() / scale
    u = torch.rand(y.shape, generator=gen, device=gen.device).to(y.device)
    q = torch.clamp(torch.floor(y + u), -127, 127).to(torch.int8)
    return q, scale


def quantize_chunked(x: torch.Tensor, gen: torch.Generator,
                     chunk_elems: int):
    """Flatten ``x``, zero-pad to a multiple of ``chunk_elems``, quantize
    each chunk with its own scale; -> (q ``[n_chunks, chunk]`` int8,
    scales ``[n_chunks]`` fp32).  One uniform draw per element from
    ``gen``."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % chunk_elems
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(-1, chunk_elems)
    scales = torch.clamp(chunks.abs().amax(dim=1), min=1e-30) / 127.0
    u = torch.rand(chunks.shape, generator=gen,
                   device=gen.device).to(chunks.device)
    q = torch.clamp(torch.floor(chunks / scales[:, None] + u), -127, 127)
    return q.to(torch.int8), scales


def dequantize_chunked(q: torch.Tensor, scales: torch.Tensor, shape, dtype):
    """Inverse of :func:`quantize_chunked`: drop the padding tail and
    restore ``shape``/``dtype``."""
    flat = (q.float() * scales[:, None]).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape).to(dtype)


@dataclasses.dataclass
class QuantizedTensor:
    """One quantized leaf: ``q [n_chunks, chunk]`` int8 + ``scales
    [n_chunks]`` fp32, with the original shape and dtype.  Not a tensor:
    the precision policy passes it through whole (its scales stay fp32)."""

    q: torch.Tensor
    scales: torch.Tensor
    shape: tuple
    dtype: torch.dtype
    _layout: tuple | None = dataclasses.field(default=None, repr=False,
                                              compare=False)
    _packed: torch.Tensor | None = dataclasses.field(default=None,
                                                     repr=False,
                                                     compare=False)

    def dequantize(self) -> torch.Tensor:
        return dequantize_chunked(self.q, self.scales, self.shape, self.dtype)

    @property
    def chunk(self) -> int:
        return int(self.q.shape[1])

    @property
    def nbytes_quantized(self) -> int:
        return int(self.q.numel() + 4 * self.scales.numel())

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scales.to(device),
                               self.shape, self.dtype)

    def layout(self):
        """:func:`_band_layout`, computed once per leaf (the decode step
        reads it every token)."""
        if self._layout is None:
            self._layout = _band_layout(self)
        return self._layout

    def tc_packed(self):
        """The 2D payload in kernel 5's tensor-core fragment order
        (:func:`tc_pack`), computed once per leaf on the payload's device
        (a second copy of the int8 bytes); ``None`` where the tensor-core
        kernel does not take the shape (:func:`tc_shape`), and while the
        stream is captured into a CUDA graph before it was built (a
        captured build would run only at replay)."""
        layout = self.layout()
        if (self._packed is None and layout is not None
                and not torch.cuda.is_current_stream_capturing()):
            q2d, _, bands = layout
            din, dout = q2d.shape
            if tc_shape(din, dout, dout // bands):
                self._packed = tc_pack(q2d)
        return self._packed


def _band_layout(qt: QuantizedTensor):
    """Metadata-only view of the chunked payload as ``(q2d [Din, Dout]
    int8, scales [bands, Din] fp32, bands)``; ``None`` when the chunking
    does not tile the 2D shape."""
    if len(qt.shape) != 2:
        return None
    din, dout = (int(s) for s in qt.shape)
    chunk = qt.chunk
    if chunk % dout == 0:
        # row bands: each chunk covers chunk // Dout whole rows
        q2d = qt.q.reshape(-1, dout)[:din]
        srow = torch.repeat_interleave(qt.scales, chunk // dout)[:din]
        return q2d, srow[None, :].contiguous(), 1
    if dout % chunk == 0:
        # column bands: each row is Dout // chunk consecutive chunks
        bands = dout // chunk
        return (qt.q.reshape(din, dout),
                qt.scales.reshape(din, bands).t().contiguous(), bands)
    return None


def tc_shape(din: int, dout: int, cc: int) -> bool:
    """Whether kernel 5's bf16 tensor-core path takes a ``[Din, Dout]``
    weight in bands of ``cc`` columns: K in pairs of 16-row tiles, whole
    16-column tiles, every 64-column tile in one band (the kernel's own
    ``int8_matmul_tc_shape``)."""
    return din % 32 == 0 and dout % 16 == 0 and (cc == dout or cc % 64 == 0)


def tc_pack(q2d: torch.Tensor) -> torch.Tensor:
    """``q2d [Din, Dout]`` int8 in the fragment order of kernel 5's
    ``mma.m16n8k16`` (weight as the 16-row A operand, ``A[n][k] =
    W[k][n]``): for each 16-column n-tile, each pair of 16-row K tiles and
    each lane (``g = lane // 4``, ``t = lane % 4``), 16 bytes: per K tile
    ``W[2t][g], W[2t+1][g], W[2t][g+8], W[2t+1][g+8], W[2t+8][g],
    W[2t+9][g], W[2t+8][g+8], W[2t+9][g+8]`` (rows and columns within the
    tiles), i.e. A's registers ``a0a1, a2a3, a4a5, a6a7``.  -> ``[Dout /
    16, Din / 32, 32, 16]`` int8."""
    din, dout = q2d.shape
    lane = torch.arange(32, device=q2d.device)
    g, t = lane // 4, lane % 4
    kk = torch.stack([2 * t, 2 * t + 1, 2 * t, 2 * t + 1,
                      2 * t + 8, 2 * t + 9, 2 * t + 8, 2 * t + 9], 1)
    nn = torch.stack([g, g, g + 8, g + 8, g, g, g + 8, g + 8], 1)
    tiles = q2d.reshape(din // 16, 16, dout // 16, 16).permute(2, 0, 1, 3)
    frag = tiles[:, :, kk, nn]                        # [nt, kt, 32, 8]
    return (frag.reshape(dout // 16, din // 32, 2, 32, 8).transpose(2, 3)
            .reshape(dout // 16, din // 32, 32, 16).contiguous())


def int8_matmul_supported(shape, chunk_elems: int) -> bool:
    """Whether :func:`int8_matmul` takes a ``[Din, Dout]`` weight quantized
    at ``chunk_elems``: the chunking must tile the 2D shape (the
    reference's rule), and each band's column count must be a multiple of
    4 (kernel 5's word loads).  The reference's Mosaic (8, 128) rule does
    not apply on the card."""
    if len(shape) != 2:
        return False
    din, dout = (int(s) for s in shape)
    if chunk_elems % dout == 0:
        band_cols = dout
    elif dout % chunk_elems == 0:
        band_cols = chunk_elems
    else:
        return False
    return band_cols % _VEC == 0


def int8_matmul_ref(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The plain version of kernel 5: per band, ``(x * s)`` in fp32 —
    rounded to bf16 when ``x`` is bf16 — times the int8 weight, summed in
    fp32, cast to ``x.dtype``.  ``x [..., Din] -> [..., Dout]``.  A
    chunking that does not tile the 2D shape (an odd-vocab head), which
    kernel 5 refuses, is dequantized and multiplied: the reference's
    ``matmul_any`` rule for such a leaf."""
    layout = qt.layout()
    if layout is None:
        return x @ qt.dequantize().to(x.dtype)
    q2d, scales, bands = layout
    din, dout = q2d.shape
    x2 = x.reshape(-1, din)
    cc = dout // bands
    outs = []
    for b in range(bands):
        xs = x2.float() * scales[b][None, :]
        if x.dtype == torch.bfloat16:
            xs = xs.to(torch.bfloat16).float()
        outs.append(xs @ q2d[:, b * cc:(b + 1) * cc].float())
    out = torch.cat(outs, dim=1) if bands > 1 else outs[0]
    return out.to(x.dtype).reshape(*x.shape[:-1], dout)


def _layout_or_raise(qt):
    layout = qt.layout()
    if layout is None or not int8_matmul_supported(qt.shape, qt.chunk):
        raise ValueError(
            f"int8_matmul: chunking {qt.chunk} does not tile shape "
            f"{qt.shape} in bands of a multiple of {_VEC} columns; gate "
            f"with int8_matmul_supported()")
    return layout


def int8_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x @ dequantize(qt)`` without materializing the weight:
    ``x [..., Din] -> [..., Dout]`` in ``x.dtype``.  A CPU tensor runs
    :func:`int8_matmul_ref`; a CUDA tensor launches kernel 5 or raises."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, qt)
    q2d, scales, bands = _layout_or_raise(qt)
    din, dout = q2d.shape
    if x.shape[-1] != din:
        raise ValueError(f"int8_matmul: x width {x.shape[-1]} != Din {din}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matmul: dtype {x.dtype} not in "
                         f"(float32, bfloat16)")
    x2 = x.reshape(-1, din).contiguous()
    check_cuda("int8_matmul", x2, q2d, scales)
    if q2d.data_ptr() % 4:
        raise ValueError("int8_matmul: int8 payload not 4-byte aligned")
    m = x2.shape[0]
    out = torch.empty((m, dout), dtype=x.dtype, device=x.device)
    # bf16 runs on the tensor cores from the packed payload where the
    # shape allows it and M >= 3 (the kernel decides)
    packed = qt.tc_packed() if x.dtype == torch.bfloat16 else None
    # one launch: the kernel picks its K split (within a CTA, and across a
    # thread block cluster for small weights) from the shapes alone
    INT8_MATMUL.call(
        "int8_matmul", "ipppppiiiip",
        0 if x.dtype == torch.float32 else 1, x2.data_ptr(),
        q2d.data_ptr(), 0 if packed is None else packed.data_ptr(),
        scales.data_ptr(), out.data_ptr(), m, din, dout, dout // bands,
        stream_ptr(x))
    INT8_MATMUL.launches += 1
    return out.reshape(*x.shape[:-1], dout)


def matmul_any(x: torch.Tensor, w) -> torch.Tensor:
    """The layer stack's matmul dispatch: ``x @ w`` for tensors,
    :func:`int8_matmul` for every :class:`QuantizedTensor` leaf (on the
    card it launches kernel 5 or raises)."""
    if isinstance(w, QuantizedTensor):
        return int8_matmul(x, w)
    return x @ w.to(x.dtype)
