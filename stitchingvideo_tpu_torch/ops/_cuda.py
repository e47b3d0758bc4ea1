"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each `csrc/*.cu` holds one kernel behind a plain C launch function
(`<stem>_launch`, returning the `cudaError_t` of the launch) and an error
string helper (`<stem>_error_string`). A source is compiled for Hopper
(`sm_90a`) on first use, into `_build/` beside the package, under a name
that hashes the source and the flags, so an edited source is rebuilt and
concurrent processes never load a half-written library. Nothing here runs
when the module is imported: a machine without nvcc or a GPU imports it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -fmad=false: no multiply-add contraction, so the float tails stay
# bit-exact with the reference's separately rounded multiply and add
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class KernelLibrary:
    """One `csrc/<stem>.cu`, compiled into its own shared library."""

    def __init__(self, stem: str, argtypes: Sequence):
        self.stem = stem
        self.source = CSRC / f"{stem}.cu"
        self.argtypes = list(argtypes)
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    @property
    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc unless the library is built: (process, tmp, path)."""
        path = self.path
        if path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, path

    def _load(self):
        with self._lock:
            if self._fn is None:
                build_all([self])
                lib = ctypes.CDLL(str(self.path))
                fn = getattr(lib, f"{self.stem}_launch")
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = getattr(lib, f"{self.stem}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._fn, self._err = fn, err
        return self._fn

    def __call__(self, *args) -> None:
        """Launch on the given stream; raise if the launch was refused."""
        rc = self._load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.stem}: CUDA error {rc}: "
                               f"{self._err(rc).decode()}")


def build_all(libraries: Sequence[KernelLibrary]) -> float:
    """Compile every library that is not built yet, one nvcc each, all
    started together. Raises with the compiler's output if one fails.
    Returns the seconds it took."""
    t0 = time.perf_counter()
    jobs = [j for j in (lib.start_build() for lib in libraries) if j]
    failed = []
    for proc, tmp, path in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{path.name}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


class CudaKernel:
    """A kernel's launcher with its count of launches (`launches`, a plain
    int that a run resets and reads to show which kernels it went through)."""

    def __init__(self, name: str, library: KernelLibrary):
        self.name = name
        self.library = library
        self.launches = 0

    def launch(self, *args) -> None:
        self.library(*args)
        self.launches += 1


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# frames, tap_xy, tap_cw, gc, fb_cam, fb_sx, fb_sy, fb_gain, out,
# B, N, H, W, npix, stream
COMPOSITE_MAT2 = KernelLibrary("composite_mat2", [_P] * 9 +
                               [_I, _I, _I, _I, _L, _P])
# src, dst, B, N, rows (= 3*H), W, stream
SHIFT_PLANAR_BN = KernelLibrary("shift_planar_bn",
                                [_P, _P, _I, _I, _I, _I, _P])
LIBRARIES = (COMPOSITE_MAT2, SHIFT_PLANAR_BN)
