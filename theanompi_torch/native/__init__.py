"""The host's native helper: the input pipeline's per-image crop and
mirror in C, loaded through ctypes.

Counterpart of ``theanompi_tpu/native/__init__.py``, with its own copy of
the C source (``augment.c``).  The library is compiled on first use with
the system's C compiler into ``_build/`` next to this file (git-ignored),
under a per-process temporary name renamed into place, so concurrent
processes never load a half-written file.  Where no compiler is found or
the build fails, :func:`lib` returns None after one line on stderr, and
the callers run their numpy loop, the reference implementation the C
path is tested equal to.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "augment.c")
BUILD_DIR = os.path.join(_DIR, "_build")
_SO = os.path.join(BUILD_DIR, "libaugment.so")

_lib = None
_tried = False
_lock = threading.Lock()  # the prefetch thread may race the first call


def lib():
    """The loaded library, built on the first call; None where it cannot
    be built or loaded (said once on stderr)."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _load(_build())
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                print(f"theanompi_torch.native: no C crop ({e}); using the "
                      f"numpy loop", file=sys.stderr, flush=True)
                _lib = None
        return _lib


def available() -> bool:
    """Whether the native crop is loadable (builds it on the first call)."""
    return lib() is not None


def _build() -> str:
    """-> the library's path, compiling it if it is missing or older than
    its source."""
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    errors = []
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run([cc, "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                           check=True, capture_output=True, timeout=120)
        except FileNotFoundError:
            errors.append(f"{cc}: not found")
            continue
        except subprocess.CalledProcessError as e:
            errors.append(f"{cc}: {e.stderr.decode(errors='replace')[:200]}")
            continue
        except subprocess.TimeoutExpired:
            errors.append(f"{cc}: timed out")
            continue
        os.replace(tmp, _SO)
        return _SO
    if os.path.exists(tmp):
        os.remove(tmp)
    raise RuntimeError("build failed: " + "; ".join(errors))


def _load(path):
    handle = ctypes.CDLL(path)
    handle.crop_mirror_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    handle.crop_mirror_batch.restype = None
    return handle


def crop_mirror_batch(src: np.ndarray, out_h: int, out_w: int,
                      ys: np.ndarray, xs: np.ndarray,
                      flips: np.ndarray) -> np.ndarray | None:
    """Crop image ``i`` of the NHWC batch ``src`` (any fixed-size dtype)
    at ``(ys[i], xs[i])`` to ``out_h x out_w``, mirrored where
    ``flips[i]``; -> the new batch, or None without the library (the
    caller runs its numpy loop)."""
    handle = lib()
    if handle is None:
        return None
    src = np.ascontiguousarray(src)
    n, h, w, c = src.shape
    ys = np.ascontiguousarray(ys, np.int64)
    xs = np.ascontiguousarray(xs, np.int64)
    flips = np.ascontiguousarray(flips, np.uint8)
    # the C loop reads without bounds checks: every crop must lie inside
    if (ys.shape != (n,) or xs.shape != (n,) or flips.shape != (n,)
            or (n and (ys.min() < 0 or ys.max() > h - out_h
                       or xs.min() < 0 or xs.max() > w - out_w))):
        raise ValueError(
            f"crop_mirror_batch: {n} images of {h}x{w}, crops of "
            f"{out_h}x{out_w} at offsets outside them or of other counts")
    out = np.empty((n, out_h, out_w, c), src.dtype)
    handle.crop_mirror_batch(
        src.ctypes.data_as(ctypes.c_char_p),
        out.ctypes.data_as(ctypes.c_char_p),
        n, h, w, c, src.dtype.itemsize, out_h, out_w, ys, xs, flips)
    return out
