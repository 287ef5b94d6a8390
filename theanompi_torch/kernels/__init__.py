"""Hand-written Hopper kernels: build at first use, bind with ``ctypes``.

Every ``csrc/*.cu`` source compiles on its own with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, under
``_build/`` next to this file (git-ignored).  The build runs at the first
launch of any kernel — never at import, so the CPU tests import every
module without ``nvcc`` — and compiles all sources at once, one ``nvcc``
process each, started together.  A library is reused while its source's
content hash (with the shared ``*.cuh`` headers') matches the one in its
file name.

Each C entry point takes raw device pointers and the CUDA stream as
``void*`` (``ctypes.c_void_p``), launches on that stream and returns
``cudaGetLastError()``; :meth:`Kernel.call` raises when it is not 0.

Each :class:`Kernel` keeps a plain integer ``launches`` count that its
wrapper bumps once per launch of its kernel (and nowhere else), so a run
can show that the main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_build_lock = threading.Lock()

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(source: str) -> str:
    """The library of ``source``, named by the hash of its text and of the
    headers beside it (``csrc/*.cuh``, which sources may include)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


class Kernel:
    """One CUDA source and its launch count.

    ``replaces`` names the Pallas kernel the source stands in for
    (``file:line``); ``chip_smoke.py`` reports it.
    """

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._lib = None
        self._fns: dict[str, object] = {}

    def _load(self):
        if self._lib is None:
            build_all()
            self._lib = ctypes.CDLL(_lib_path(self.source))
        return self._lib

    def query(self, symbol: str, sig: str, *args) -> int:
        """Call a C function that returns an ``int``, and return it.
        ``sig`` spells its arguments, one letter each: ``p`` a pointer or
        the stream (``c_void_p``, from ``data_ptr()`` / ``cuda_stream``),
        ``i`` a ``c_int``, ``f`` a ``c_float``."""
        fn = self._fns.get(symbol)
        if fn is None:
            fn = getattr(self._load(), symbol)
            fn.argtypes = [_CTYPES[c] for c in sig]
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn
        return fn(*args)

    def call(self, symbol: str, sig: str, *args) -> None:
        """Call a C entry point (``sig`` as :meth:`query`).  Raises on a
        non-zero ``cudaGetLastError``."""
        rc = self.query(symbol, sig, *args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: {symbol} failed with CUDA "
                               f"error {rc}")


#: every kernel of the port, in the order ``chip_smoke.py`` reports them
KERNELS: list[Kernel] = []


def register(kernel: Kernel) -> Kernel:
    KERNELS.append(kernel)
    return kernel


def build_all() -> float:
    """Compile every ``csrc/*.cu`` whose library is missing, all ``nvcc``
    processes at once; -> seconds spent (0.0 when everything was built).
    ``ptxas`` resource usage lands beside each library as ``.ptxas.txt``."""
    with _build_lock:
        sources = sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))
        todo = [s for s in sources if not os.path.exists(_lib_path(s))]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = []
        for s in todo:
            out = _lib_path(s)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, s)]
            procs.append((s, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for s, out, tmp, p in procs:
            log, _ = p.communicate()
            with open(os.path.splitext(out)[0] + ".ptxas.txt", "w") as f:
                f.write(log)
            if p.returncode != 0:
                failed.append(f"{s} (exit {p.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        return time.perf_counter() - t0


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device as a raw pointer int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, *tensors) -> None:
    """Wrapper-side validation shared by every kernel: all on one CUDA
    device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             f"not contiguous")
