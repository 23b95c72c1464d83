"""Build and bind the port's CUDA kernels.

Each kernel source in ``pingpong_tpu_torch/csrc/`` has a plain C
interface. At first use it is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``build/torch_kernels/`` of the checkout and loaded
with ``ctypes``; a library newer than its source and the shared headers
(``csrc/*.cuh``) is reused, and the compiler's log written beside it
(``lib<name>.log``) with it. Nothing here
runs at import time: this module is imported on machines without a card
or a compiler, where only the kernels' plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

from pingpong_tpu_torch.utils import trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and {path})")
    return path


_KERNELS: List["CudaKernel"] = []


class CudaKernel:
    """One CUDA source, its entry point and its launch counter.

    ``launches`` counts successful launches of the kernel: the wrapper
    adds one right after the entry point returned ``cudaSuccess``, and
    nowhere else. Every instance is listed for :func:`launch_counts`."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.library = BUILD_DIR / f"lib{name}.so"
        self.log = BUILD_DIR / f"lib{name}.log"
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lib = None
        _KERNELS.append(self)

    def _stale(self) -> bool:
        """The library or its log is missing, or older than its source or
        any shared header of ``csrc/``."""
        if not (self.library.exists() and self.log.exists()):
            return True
        newest = max(p.stat().st_mtime
                     for p in [self.source, *CSRC.glob("*.cuh")])
        return self.library.stat().st_mtime < newest

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this source if the library is missing or
        stale; returns the process (or None when nothing to do)."""
        if not self._stale():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_name(self.library.name + f".tmp-{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        """Wait for ``nvcc`` (an ``ops::build`` span, counted in
        ``ops::builds``) and move the library into place."""
        if proc is None:
            return
        with trace.span("ops::build"):
            trace.count("ops::builds")
            out, _ = proc.communicate()
        tmp = self.library.with_name(self.library.name + f".tmp-{os.getpid()}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        self.log.write_text(out)
        os.replace(tmp, self.library)

    def ptxas_log(self) -> str:
        """The compiler's log (``-Xptxas -v``) of the library in use."""
        return self.log.read_text() if self.log.exists() else ""

    def fn(self):
        """The bound entry point, building the library first if needed."""
        if self._fn is None:
            self.finish_build(self.start_build())
            self._lib = ctypes.CDLL(str(self.library))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = self._lib.pp_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn = fn
        return self._fn

    def library_fn(self, symbol: str, argtypes: list, restype):
        """Another entry point of the same library (a size query, say)."""
        self.fn()
        fn = getattr(self._lib, symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        return fn

    def launch(self, *args) -> None:
        """Call the entry point on the current stream's arguments; raise if
        the launch was refused."""
        rc = self.fn()(*args)
        if rc != 0:
            msg = self._lib.pp_error_string(rc).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} "
                               f"(cudaError {rc})")
        self.launches += 1


def launch_counts() -> Dict[str, int]:
    """Every kernel's launches so far, by kernel name."""
    out: Dict[str, int] = {}
    for k in _KERNELS:
        out[k.name] = out.get(k.name, 0) + k.launches
    return out


def build_all(kernels: Iterable[CudaKernel]) -> Dict[str, str]:
    """Build every stale kernel library with one ``nvcc`` per source, all
    started together; returns each kernel's compiler log (that of its last
    build when the library was up to date)."""
    kernels = list(kernels)
    procs = [(k, k.start_build()) for k in kernels]
    for k, p in procs:
        k.finish_build(p)
    return {k.name: k.ptxas_log() for k in kernels}


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None):
    """Validate a kernel argument: CUDA, dtype, contiguity and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
