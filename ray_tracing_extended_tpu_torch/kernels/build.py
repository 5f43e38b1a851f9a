"""Builds one of the package's sources into a shared library at first use,
and loads it with ctypes: the CUDA sources with ``nvcc``, the host
geometry (``csrc/geometry.cpp``, ``utils/native.py``) with ``g++``.

Every library of the port is built here, from its source in ``csrc/``,
into ``build/`` beside this package; every CUDA source with the same
flags, to which the profiling library of ``csrc/megakernel.cu`` adds
``-DRTX_PROBES``. A library's name carries a digest of its source and the
flags, so a changed source is rebuilt and an unchanged one is loaded as it
is. The compiler's output, for nvcc with ptxas's register and spill report
(``-Xptxas -v``), is kept beside the library, so a later load reports the
same.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"

# Flags of every build. No --use_fast_math: it would swap logf, cosf, sinf,
# powf and sqrtf for approximations the plain versions do not use.
# -fmad=false keeps every multiply and add separately rounded, as in the
# plain versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Flags of the host geometry library: the JAX package's own (its
# utils/native.py), with no -march=native and no -ffast-math, so the
# Morton quantisation rounds as NumPy does; -ffp-contract=off keeps the
# SAH build's float64 multiply-adds separately rounded, as NumPy's are.
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from the package's csrc/ at first use and need the CUDA toolkit"
    )


@dataclasses.dataclass
class BuildInfo:
    library: Path
    seconds: float  # 0.0 when an up-to-date library was already there
    # the compiler's output (nvcc's includes ptxas's register report)
    log: str


def build_library(source: Path, name: str, compiler: str | None = None,
                  flags: tuple = NVCC_FLAGS) -> BuildInfo:
    """Compile ``source`` with ``compiler`` (default nvcc) and ``flags``
    into ``build/lib<name>_<digest>.so`` unless that library is there
    already. Raises if the compiler is missing or fails."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib_path, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler or find_nvcc(), *flags, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed ({proc.returncode}): "
            f"{' '.join(cmd)}\n{log}"
        )
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return BuildInfo(lib_path, seconds, log)


class CudaLibrary:
    """One source's library, built and loaded at first use.

    ``bind(lib)`` sets the argument and result types of the source's own C
    functions on the loaded ``ctypes.CDLL``; every source also exports
    ``rtx_error_string(code)``, bound here. ``flags`` are the compiler's
    (a second library of one source adds a ``-D`` to ``NVCC_FLAGS``)."""

    def __init__(self, source: str, name: str, bind, flags: tuple = NVCC_FLAGS):
        self.source = CSRC / source
        self.name = name
        self.flags = flags
        self._bind = bind
        self.build_info: BuildInfo | None = None
        self._lib = None

    def build(self) -> BuildInfo:
        if self._lib is None:
            info = build_library(self.source, self.name, flags=self.flags)
            lib = ctypes.CDLL(str(info.library))
            lib.rtx_error_string.argtypes = [ctypes.c_int]
            lib.rtx_error_string.restype = ctypes.c_char_p
            self._bind(lib)
            self._lib, self.build_info = lib, info
        return self.build_info

    @property
    def lib(self):
        self.build()
        return self._lib

    def check(self, rc: int, what: str) -> None:
        """Raise if a launch returned a CUDA error code."""
        if rc != 0:
            raise RuntimeError(
                f"{what} launch failed: " + self.lib.rtx_error_string(rc).decode()
            )
