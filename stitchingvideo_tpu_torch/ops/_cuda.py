"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each `csrc/<stem>.cu` holds a kernel (and the device functions it calls)
behind a plain C launch function (`<stem>_launch`, returning the
`cudaError_t` of the launch) and an error string helper
(`<stem>_error_string`); a source may hold a second kernel that shares its
device functions, behind a launch function of its own (`<entry>_launch`). A
source is compiled for Hopper
(`sm_90a`) on first use, into `_build/` beside the package, under a name
that hashes the source, the headers it includes from `csrc/` and the flags,
so an edited source or header is rebuilt and concurrent processes never load
a half-written library. Nothing here runs
when the module is imported: a machine without nvcc or a GPU imports it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
    """One launch function (`<entry>_launch`, `entry` being the stem unless
    given) of `csrc/<stem>.cu`, which is compiled into its own shared
    library."""

    def __init__(self, stem: str, argtypes: Sequence, entry: str = ""):
        self.stem = stem
        self.entry = entry or stem
        self.source = CSRC / f"{stem}.cu"
        self.argtypes = list(argtypes)
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    @property
    def path(self) -> Path:
        h = hashlib.sha256()
        for f in local_includes(self.source):
            h.update(f.read_bytes())
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
                fn = getattr(lib, f"{self.entry}_launch")
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
            raise RuntimeError(f"{self.entry}: CUDA error {rc}: "
                               f"{self._err(rc).decode()}")

    def query(self, name: str, *args: int) -> int:
        """The int that `<entry>_<name>(args..., int* value)` writes (a query
        of the library, returning a CUDA error code); raises on an error."""
        self._load()
        lib = ctypes.CDLL(str(self.path))
        fn = getattr(lib, f"{self.entry}_{name}")
        fn.argtypes = [ctypes.c_int] * len(args) + \
            [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        value = ctypes.c_int(0)
        rc = fn(*args, ctypes.byref(value))
        if rc != 0:
            raise RuntimeError(f"{self.entry}_{name}: CUDA error {rc}: "
                               f"{self._err(rc).decode()}")
        return value.value

    def blocks_per_sm(self, stage_bytes: int) -> int:
        """Blocks of a staged kernel that an SM holds at once with stages of
        `stage_bytes` (`<entry>_blocks_per_sm`, the CUDA occupancy query)."""
        return self.query("blocks_per_sm", stage_bytes)


def local_includes(source: Path) -> list:
    """`source` and every file it includes with `#include "..."` from its
    own directory, headers of headers too, each once, in the order met."""
    seen, todo = [], [source]
    while todo:
        f = todo.pop(0)
        if f in seen or not f.exists():
            continue
        seen.append(f)
        todo += [f.parent / name for name in
                 re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read_text(),
                            re.MULTILINE)]
    return seen


def build_all(libraries: Sequence[KernelLibrary]) -> float:
    """Compile every source that is not built yet, one nvcc each, all
    started together. Raises with the compiler's output if one fails.
    Returns the seconds it took."""
    t0 = time.perf_counter()
    sources = {lib.source: lib for lib in libraries}.values()
    jobs = [j for j in (lib.start_build() for lib in sources) if j]
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


_P, _I = ctypes.c_void_p, ctypes.c_int

# frames, tap_xy, tap_cw, gc, fb_cam, fb_sx, fb_sy, fb_gain, stage table,
# out, B, N, H, W, Hp, Wp, stage bytes, stream
COMPOSITE_MAT2 = KernelLibrary("composite_mat2", [_P] * 10 + [_I] * 7 + [_P])
# src, dst, B, N, rows (= 3*H), W, stream
SHIFT_PLANAR_BN = KernelLibrary("shift_planar_bn",
                                [_P, _P, _I, _I, _I, _I, _P])
# the single-class kernel, mat2's staged kernel without the fallback path:
# frames, tap_xy, tap_cw, gc, stage table, out, B, N, H, W, Hp, Wp,
# stage bytes, stream
COMPOSITE_MAT = KernelLibrary("composite_mat2", [_P] * 6 + [_I] * 7 + [_P],
                              entry="composite_mat")
# the multiband warp stage, mat2's staged kernel into bf16 windows: frames,
# tap_xy, tap_cw, gc, fb_cam, fb_sx, fb_sy, fb_gain, stage table, out, B, N,
# H, W, pieces, window rows, window columns, stage bytes, stream
COMPOSITE_MAT2_PIECES = KernelLibrary("composite_mat2",
                                      [_P] * 10 + [_I] * 8 + [_P],
                                      entry="composite_mat2_pieces")
# frames, sx, sy, gain, cidx, out, N, H, W, ntx, T, Hp, Wp, stream
COMPOSITE_TILED = KernelLibrary("composite_tiled", [_P] * 6 + [_I] * 7 + [_P])
# frames, tap_xy, tap_cw, gw (each [2, npix]), fb_cam, fb_sx, fb_sy, fb_gw
# (each [F, 2]), stage table, out, B, N, H, W, Hp, Wp, stage bytes, stream
COMPOSITE_FEATHER = KernelLibrary("composite_feather",
                                  [_P] * 10 + [_I] * 7 + [_P])
# frame, origins, out, nwin, H, W, align, stream
WINDOW_PROBE = KernelLibrary("window_probe", [_P] * 3 + [_I] * 4 + [_P])
LIBRARIES = (COMPOSITE_MAT2, SHIFT_PLANAR_BN, COMPOSITE_MAT,
             COMPOSITE_MAT2_PIECES, COMPOSITE_TILED, COMPOSITE_FEATHER,
             WINDOW_PROBE)
