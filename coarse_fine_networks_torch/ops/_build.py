"""Build and load the port's hand-written CUDA sources.

Each source in ``csrc/`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` at first use into ``_build/``
(gitignored) and bound with ``ctypes``.  A source may add flags of its own
(``flags``: the nvJPEG wrapper links ``-lnvjpeg``).  The library is named
by a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
its own included, so an edited source, header or flag is rebuilt; it is written to a temporary name and renamed,
so a concurrent process never loads a half-written file.

A host source (``csrc/*.cpp``, no device code) is built the same way by the
host C++ compiler (:class:`HostLibrary`), so the CPU runs the same code as
the card's host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

P, I = ctypes.c_void_p, ctypes.c_int


def cuda_home() -> str:
    """The CUDA toolkit's root: ``nvcc``'s, else ``CUDA_HOME``, else
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return os.path.dirname(os.path.dirname(os.path.realpath(found)))
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(cuda_home(), "bin", "nvcc")


class CudaLibrary:
    """One ``csrc/`` source and the C functions it exports.

    ``functions`` maps each exported name to its ``ctypes`` argument types;
    every function returns an ``int`` (``cudaGetLastError()`` after its
    launch).  ``flags``: nvcc flags of this source alone, after
    ``NVCC_FLAGS``."""

    compiler = "nvcc"
    base_flags = NVCC_FLAGS
    headers = "*.cuh"

    def __init__(self, source: str, functions: dict[str, list],
                 flags: tuple = ()):
        self.source = CSRC / source
        self.functions = functions
        self.flags = tuple(flags)
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def _command(self, tmp: Path) -> list:
        return [_nvcc(), *self.base_flags, "-o", str(tmp), str(self.source),
                *self.flags]

    def build(self) -> ctypes.CDLL:
        """Compile the source (once per source version) and load it."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            tag = hashlib.sha256(self.source.read_bytes())
            for header in sorted(CSRC.glob(self.headers)):
                tag.update(header.read_bytes())
            tag.update(" ".join(self.base_flags + self.flags).encode())
            out = BUILD_DIR / f"{self.source.stem}_{tag.hexdigest()[:16]}.so"
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = self._command(tmp)
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"{self.compiler} failed ({proc.returncode}): "
                        f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
            return lib

    def call(self, name: str, *args) -> None:
        """Launch ``name`` on the current stream's device; raise if the
        launch was refused."""
        err = getattr(self.build(), name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")


class HostLibrary(CudaLibrary):
    """One host C++ source of ``csrc/`` (``*.cpp``), compiled by the host's
    C++ compiler (``CXX``, else ``g++``) with ``CXX_FLAGS`` into
    ``_build/`` under :class:`CudaLibrary`'s hash-and-rename rule (the hash
    takes the ``*.hpp`` headers); each exported function returns an
    ``int`` status."""

    compiler = "c++"
    base_flags = CXX_FLAGS
    headers = "*.hpp"

    def _command(self, tmp: Path) -> list:
        cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
        return [cxx, *self.base_flags, "-o", str(tmp), str(self.source),
                *self.flags]


def build_all(libraries) -> None:
    """Build several libraries at once, one ``nvcc`` each."""
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        for fut in [pool.submit(lib.build) for lib in libraries]:
            fut.result()
