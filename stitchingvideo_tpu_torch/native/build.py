"""Build-on-demand for the native libraries (g++ -> .so, ctypes).

Port of `stitchingvideo_tpu/native/build.py`: `native/maxflow.cpp` (the
graph cut's `grid_maxflow`) and `native/sharemem.cpp` (the shared-memory
frame ring, `shm_ring_*`, the same C ABI and ring layout as the JAX
package's, so either package's processes can share a ring) are compiled by
g++ on first use into `_build/` beside the package, one library a source,
under a name that hashes the source and the flags. Each is written to a
temporary name and renamed, so an edited source is rebuilt and processes
that build at once (several producers starting together) never load a
half-written library. A failed build raises with g++'s output. Nothing here
runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "maxflow.cpp"
SHAREMEM_SOURCE = _DIR / "sharemem.cpp"
BUILD_DIR = _DIR.parent / "_build"
# neither source holds a floating-point multiply, so no flag changes a result
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
SHAREMEM_LIBS = ("-lpthread", "-lrt")
_LOCK = threading.Lock()
_libs = {}


def library_path(source: Optional[Path] = None,
                 libs: Sequence[str] = ()) -> Path:
    source = SOURCE if source is None else source
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(GXX_FLAGS + tuple(libs)).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Optional[Path] = None, libs: Sequence[str] = ()) -> Path:
    """Compile `source` (the max-flow library unless given) unless it is
    built; returns the library's path."""
    source = SOURCE if source is None else source
    path = library_path(source, libs)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    r = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(source),
                        *libs], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed to build {source.name}:\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, path)
    return path


def _load(key: str, source: Path, libs: Sequence[str], declare):
    with _LOCK:
        if key not in _libs:
            lib = ctypes.CDLL(str(build(source, libs)))
            declare(lib)
            _libs[key] = lib
        return _libs[key]


def _declare_maxflow(lib: ctypes.CDLL) -> None:
    ct = ctypes
    lib.grid_maxflow.restype = ct.c_double
    lib.grid_maxflow.argtypes = [
        ct.c_int, ct.c_int,
        ct.POINTER(ct.c_float), ct.POINTER(ct.c_float),
        ct.POINTER(ct.c_float), ct.POINTER(ct.c_float),
        ct.POINTER(ct.c_uint8),
    ]


def _declare_sharemem(lib: ctypes.CDLL) -> None:
    ct = ctypes
    lib.shm_ring_create.restype = ct.c_void_p
    lib.shm_ring_create.argtypes = [ct.c_char_p, ct.c_int, ct.c_int,
                                    ct.c_int, ct.c_int]
    lib.shm_ring_open.restype = ct.c_void_p
    lib.shm_ring_open.argtypes = [ct.c_char_p]
    lib.shm_ring_publish.restype = ct.c_int
    lib.shm_ring_publish.argtypes = [ct.c_void_p, ct.POINTER(ct.c_uint8),
                                     ct.c_int64, ct.c_int64]
    lib.shm_ring_consume.restype = ct.c_int64
    lib.shm_ring_consume.argtypes = [ct.c_void_p, ct.POINTER(ct.c_uint8),
                                     ct.c_int64, ct.POINTER(ct.c_int64),
                                     ct.c_double]
    lib.shm_ring_close.restype = None
    lib.shm_ring_close.argtypes = [ct.c_void_p, ct.c_int]
    lib.shm_ring_info.restype = ct.c_int
    lib.shm_ring_info.argtypes = [ct.c_void_p, ct.POINTER(ct.c_int)]


def load() -> ctypes.CDLL:
    """Load (building if needed) the max-flow library."""
    return _load("maxflow", SOURCE, (), _declare_maxflow)


def load_sharemem() -> ctypes.CDLL:
    """Load (building if needed) the shared-memory ring library."""
    return _load("sharemem", SHAREMEM_SOURCE, SHAREMEM_LIBS,
                 _declare_sharemem)
