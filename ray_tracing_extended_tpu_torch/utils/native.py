"""The native host builds of the BVH: Morton codes, a u64 radix argsort and
the recursive LBVH build over the sorted primitives, and the binned-SAH
build, in C++ through ctypes.

Counterpart of ``ray_tracing_extended_tpu/utils/native.py``, with the same
functions (``available``, ``morton_codes``, ``argsort_u64``,
``lbvh_build``) over the port's own copy of the source,
``csrc/geometry.cpp``, and one of its own, ``sah_build``. It is built at
first use with ``g++ -O3 -shared -fPIC -ffp-contract=off`` (the JAX
package's flags, multiply-adds unfused) into ``build/`` by
``kernels/build.py``. ``accel/bvh.build_lbvh`` and ``build_sah_bvh``
build the same arrays through it as through their NumPy code, bit for bit
(``tests/test_torch_native.py``).

Unlike the JAX module it has no silent fallback: a compiler that is there
and fails raises, with its output. Only ``RTE_NATIVE=0`` (the JAX
package's switch) or no ``g++`` on the PATH leaves the build to NumPy; the
functions then return None, and ``accel/bvh.LBVH_BUILDS`` records the
route each build took.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

import numpy as np

from ..kernels.build import CSRC, GXX_FLAGS, BuildInfo, build_library

SOURCE = CSRC / "geometry.cpp"


def _bind(lib) -> None:
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.rtx_morton3.argtypes = [f32p, ctypes.c_int, f32p, f32p, u64p]
    lib.rtx_morton3.restype = None
    lib.rtx_argsort_u64.argtypes = [u64p, ctypes.c_int, i32p]
    lib.rtx_argsort_u64.restype = None
    lib.rtx_lbvh_build.restype = ctypes.c_int
    lib.rtx_lbvh_build.argtypes = [
        f32p, f32p, ctypes.c_int, i32p, u64p, ctypes.c_int, ctypes.c_int,
        f32p, f32p, i32p, i32p, i32p, i32p,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.rtx_sah_build.restype = ctypes.c_int
    lib.rtx_sah_build.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, i32p, i32p, i32p, i32p,
        ctypes.POINTER(ctypes.c_int),
    ]


class NativeGeometry:
    """The host geometry library of ``source``, compiled by ``compiler``
    and loaded at first use."""

    def __init__(self, source: Path = SOURCE, compiler: str = "g++"):
        self.source = Path(source)
        self.compiler = compiler
        self.build_info: BuildInfo | None = None
        self._lib = None

    def library(self):
        """The loaded library, or None where the build is NumPy's
        (``RTE_NATIVE=0``, or no compiler). Raises if the compiler fails."""
        if os.environ.get("RTE_NATIVE", "1") == "0":
            return None
        if self._lib is None:
            gxx = shutil.which(self.compiler)
            if gxx is None:
                return None
            info = build_library(self.source, "rtx_geom", compiler=gxx,
                                 flags=GXX_FLAGS)
            lib = ctypes.CDLL(str(info.library))
            _bind(lib)
            self._lib, self.build_info = lib, info
        return self._lib


NATIVE = NativeGeometry()


def available() -> bool:
    return NATIVE.library() is not None


def morton_codes(centroids: np.ndarray) -> np.ndarray | None:
    """30-bit Morton codes of the centroids quantized to a 2^10 grid, or
    None on the NumPy route."""
    lib = NATIVE.library()
    if lib is None:
        return None
    c = np.ascontiguousarray(centroids, np.float32)
    lo = c.min(axis=0)
    ext = c.max(axis=0) - lo
    inv = np.where(ext > 0, 1023.0 / np.where(ext > 0, ext, 1.0), 0.0).astype(
        np.float32
    )
    codes = np.empty(len(c), np.uint64)
    lib.rtx_morton3(c, len(c), np.ascontiguousarray(lo),
                    np.ascontiguousarray(inv), codes)
    return codes


def argsort_u64(codes: np.ndarray) -> np.ndarray | None:
    """The stable argsort of u64 codes (an LSB radix sort), or None on the
    NumPy route."""
    lib = NATIVE.library()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint64)
    order = np.empty(len(codes), np.int32)
    lib.rtx_argsort_u64(codes, len(codes), order)
    return order


def lbvh_build(prim_bmin, prim_bmax, order, sorted_codes, leaf_width,
               sentinel):
    """-> ``(node_bmin, node_bmax, left, right, leaf_row, leaf_prims)``,
    NumPy arrays trimmed to the built nodes and leaves, or None on the
    NumPy route."""
    lib = NATIVE.library()
    if lib is None:
        return None
    bmin = np.ascontiguousarray(prim_bmin, np.float32)
    bmax = np.ascontiguousarray(prim_bmax, np.float32)
    order = np.ascontiguousarray(order, np.int32)
    codes = np.ascontiguousarray(sorted_codes, np.uint64)
    n = len(order)
    if bmin.shape != (n, 3) or bmax.shape != (n, 3) or codes.shape != (n,):
        raise ValueError(
            f"lbvh_build: {n} primitives in order, boxes {bmin.shape} and "
            f"{bmax.shape}, codes {codes.shape}"
        )
    cap = 2 * n
    node_bmin = np.empty((cap, 3), np.float32)
    node_bmax = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    leaf_row = np.empty(cap, np.int32)
    leaf_prims = np.empty((n, leaf_width), np.int32)
    n_leaves = ctypes.c_int(0)
    n_nodes = lib.rtx_lbvh_build(
        bmin, bmax, n, order, codes, leaf_width, sentinel,
        node_bmin, node_bmax, left, right, leaf_row, leaf_prims,
        ctypes.byref(n_leaves),
    )
    nl = n_leaves.value
    return (
        node_bmin[:n_nodes].copy(),
        node_bmax[:n_nodes].copy(),
        left[:n_nodes].copy(),
        right[:n_nodes].copy(),
        leaf_row[:n_nodes].copy(),
        leaf_prims[:nl].copy(),
    )


def sah_build(prim_bmin, prim_bmax, leaf_width, sentinel):
    """The binned-SAH build -> ``(node_bmin, node_bmax, left, right,
    leaf_row, leaf_prims)``, NumPy arrays trimmed to the built nodes and
    leaves, or None on the NumPy route."""
    lib = NATIVE.library()
    if lib is None:
        return None
    bmin = np.ascontiguousarray(prim_bmin, np.float32)
    bmax = np.ascontiguousarray(prim_bmax, np.float32)
    n = len(bmin)
    if bmin.shape != (n, 3) or bmax.shape != (n, 3) or n < 1:
        raise ValueError(f"sah_build: boxes {bmin.shape} and {bmax.shape}")
    cap = 2 * n
    node_bmin = np.empty((cap, 3), np.float32)
    node_bmax = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    leaf_row = np.empty(cap, np.int32)
    leaf_prims = np.empty((n, leaf_width), np.int32)
    n_leaves = ctypes.c_int(0)
    n_nodes = lib.rtx_sah_build(
        bmin, bmax, n, leaf_width, sentinel,
        node_bmin, node_bmax, left, right, leaf_row, leaf_prims,
        ctypes.byref(n_leaves),
    )
    nl = n_leaves.value
    return (
        node_bmin[:n_nodes].copy(),
        node_bmax[:n_nodes].copy(),
        left[:n_nodes].copy(),
        right[:n_nodes].copy(),
        leaf_row[:n_nodes].copy(),
        leaf_prims[:nl].copy(),
    )
