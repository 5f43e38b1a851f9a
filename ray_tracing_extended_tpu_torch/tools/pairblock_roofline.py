"""The isolated sphere pair-test block: the card's ceiling for the
path-trace kernel's hot loop, without traversal, shading or the real
kernel's occupancy.

Counterpart of ``tools/pairblock_roofline.py`` (the JAX tool's Pallas
kernel, ported to ``csrc/pairblock_roofline.cu``; see the source's header
for what each variant computes). Every program of the grid tests the same
8 rows of 128 rays against a (16, 32, 8) table of sphere clusters, ``steps``
outer steps of 8 cluster visits a row: ``grid x steps x 8 x 8 x 32 x 128``
pair tests a call (1.07e9 at the defaults, the JAX tool's constants).

    python -m ray_tracing_extended_tpu_torch.tools.pairblock_roofline [variant...]

prints one JSON line per variant (default ``full``) with the JAX tool's
keys: ``variant``, ``pairblock_tflops``, ``pairs_gps``, ``wall_ms``,
``t1_ms``, ``pairs``, ``ops_per_pair``, ``device``. ``ops_per_pair`` is the
JAX tool's count (30, 25 for twophase), kept so the two tools' TFLOP/s
read alike; ``pairs_gps`` needs no count. ``wall_ms`` is the median of
CUDA-event times of single launches after a warm-up, ``t1_ms`` one launch
on the host clock to its synchronise. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..kernels.build import CudaLibrary
from ..ops import vecmath as vm
from .vpu_roofline import event_ms

LANES = 128
SUB = 32
RS = 8  # rows of ray state
NCL = 16  # clusters in the table
VISITS = 8  # cluster visits a row an outer step
STEPS = 64  # outer steps a program
GRID = 64
OPS_PER_PAIR = 30
_INF = float("inf")
_WIDEN = ~2047

# The source's Variant values, in order.
VARIANTS = ("full", "nosqrt", "noenc", "nomin", "twophase", "multisub2",
            "multisub4", "multirow")


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rtx_pairblock.argtypes = [ci, vp, vp, vp, ci, ci, vp]
    lib.rtx_pairblock.restype = ci


LIBRARY = CudaLibrary("pairblock_roofline.cu", "pairblock_roofline", _bind)
# launches of the kernel made through ``pairblock``, by variant
LAUNCHES = {v: 0 for v in VARIANTS}


def make_inputs() -> tuple[np.ndarray, np.ndarray]:
    """The JAX tool's inputs (its ``np.random.default_rng(7)`` sequence):
    rays (48, 128) f32 and the logical cluster table (16, 32, 8) f32."""
    rng = np.random.default_rng(7)
    rays = rng.normal(size=(6 * RS, LANES)).astype(np.float32)
    rays[:3] += 4.0  # origins away from the cluster cloud
    d = rays[3 * RS:].reshape(3, RS, LANES)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    cols = np.zeros((NCL, SUB, 8), np.float32)
    cols[..., :3] = rng.normal(size=(NCL, SUB, 3))
    cols[..., 4] = 0.25  # r^2
    return rays, cols


def pairs(steps: int = STEPS, grid: int = GRID) -> int:
    """Pair tests of one call; every variant covers the same volume."""
    return grid * steps * RS * VISITS * SUB * LANES


def _encode(tq, idx):
    """The wide encode ``(bits(tq) & ~2047) | idx`` where ``tq >= 0``."""
    bits = (tq.view(torch.int32) & _WIDEN) | idx
    return torch.where(tq >= 0.0, bits.view(torch.float32), _INF)


def root_value(b: torch.Tensor, disc: torch.Tensor, idx,
               variant: str = "full") -> torch.Tensor:
    """A root-taking variant's value from ``b`` and ``disc = b^2 - cc``, as
    the kernel's ``pair``: ``tq = -b - sqrt(disc)`` taken only where
    ``disc >= 0``, then ``tq`` (noenc) or its wide encode where ``tq >= 0``,
    else +inf. Where ``disc < 0`` the unguarded root would be NaN and miss
    as well, so the guard changes no value."""
    tq = torch.where(disc >= 0.0, -b - vm.sqrt(disc), -_INF)
    if variant == "noenc":
        return torch.where(tq >= 0.0, tq, _INF)
    return _encode(tq, idx)


def pair_disc(cx, cy, cz, r2, o, d):
    """The pair test's ``(b, disc = b^2 - cc)`` an element (all arguments
    broadcast): the sphere's centre ``cx, cy, cz`` and ``r2`` = r^2, the
    ray's origin ``o`` and direction ``d`` as three tensors each."""
    ocx, ocy, ocz = o[0] - cx, o[1] - cy, o[2] - cz
    b = ocx * d[0] + ocy * d[1] + ocz * d[2]
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
    return b, b * b - cc


def pair_test(cx, cy, cz, r2, idx, o, d, variant: str = "full"):
    """One pair test an element (arguments as ``pair_disc``'s, and the
    encode's ``idx``): the value the kernel's ``pair`` gives, +inf on a
    miss."""
    b, disc = pair_disc(cx, cy, cz, r2, o, d)
    if variant == "twophase":
        return torch.where((disc >= 0.0) & (b < 0.0), -b, _INF)
    if variant == "nosqrt":
        return _encode(-b - disc * 0.5, idx)  # exact on every device
    return root_value(b, disc, idx, variant)


def pairblock_plain(rays: torch.Tensor, cols: torch.Tensor,
                    variant: str = "full", steps: int = STEPS,
                    grid: int = GRID) -> torch.Tensor:
    """The plain PyTorch version: the (grid * 8, 128) f32 output of
    ``variant`` on ``rays`` (48, 128) and the logical table ``cols``
    (16, 32, 8), on their device."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    dev = rays.device
    o = [rays[k * RS:(k + 1) * RS] for k in range(3)]  # (RS, 128) each
    d = [rays[(3 + k) * RS:(4 + k) * RS] for k in range(3)]
    g = torch.arange(RS, device=dev)
    best = torch.full((RS, LANES), _INF, dtype=torch.float32, device=dev)

    def test(q, idx, o, d):
        return pair_test(*(q[..., k:k + 1] for k in (0, 1, 2, 4)), idx, o, d,
                         variant)

    if variant == "multirow":
        # every row against one cluster's spheres: (SUB, RS, 128)
        k = torch.arange(SUB, device=dev)
        for it in range(steps):
            for v in range(VISITS):
                c = (it * 7 + v) % NCL
                q = cols[c][:, None, :]  # (SUB, 1, 8)
                idx = ((c << 5) | k).to(torch.int32)[:, None, None]
                enc = test(q, idx, [x[None] for x in o], [x[None] for x in d])
                best = torch.minimum(enc.amin(dim=0), best)
    else:
        fuse = int(variant[-1]) if variant.startswith("multisub") else 1
        table = cols.reshape(NCL // fuse, fuse * SUB, 8)
        s = torch.arange(fuse * SUB, device=dev)
        for it in range(steps):
            for v in range(VISITS // fuse):
                c = (it * 7 + g * 3 + v) % (NCL // fuse)  # (RS,)
                q = table[c]  # (RS, fuse * SUB, 8)
                idx = ((c[:, None] << 5) | s[None, :]).to(torch.int32)[..., None]
                enc = test(q, idx, [x[:, None] for x in o],
                           [x[:, None] for x in d])
                visit_min = enc.amin(dim=1)
                best = (visit_min if variant == "nomin"
                        else torch.minimum(visit_min, best))
    return best.repeat(grid, 1)


def pairblock(rays: torch.Tensor, cols: torch.Tensor, variant: str = "full",
              steps: int = STEPS, grid: int = GRID) -> torch.Tensor:
    """The probe's output: on CUDA tensors one launch of the kernel
    (counted in ``LAUNCHES``), on CPU tensors the plain version."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    dev = rays.device
    if dev.type == "cpu":
        return pairblock_plain(rays, cols, variant, steps, grid)
    if dev.type != "cuda" or cols.device != dev:
        raise ValueError(f"rays on {dev}, cols on {cols.device}: both on one "
                         "CUDA device or both on the CPU")
    for name, t, shape in (("rays", rays, (6 * RS, LANES)),
                           ("cols", cols, (NCL, SUB, 8))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} float32 "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    out = torch.empty((grid * RS, LANES), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = LIBRARY.lib.rtx_pairblock(
            VARIANTS.index(variant), rays.data_ptr(), cols.data_ptr(),
            out.data_ptr(), steps, grid,
            torch.cuda.current_stream(dev).cuda_stream)
    LIBRARY.check(rc, f"pairblock {variant}")
    LAUNCHES[variant] += 1
    return out


def measure(variant: str = "full", steps: int = STEPS, grid: int = GRID,
            reps: int = 7) -> dict:
    """Time one variant on the card; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("the pair-block probe measures a CUDA card; none "
                           "is available")
    rays, cols = (torch.from_numpy(a).cuda() for a in make_inputs())
    LIBRARY.build()
    ms = statistics.median(event_ms(
        lambda: pairblock(rays, cols, variant, steps, grid), reps))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pairblock(rays, cols, variant, steps, grid)
    torch.cuda.synchronize()
    t1 = time.perf_counter() - t0
    n = pairs(steps, grid)
    ops_per_pair = 25 if variant == "twophase" else OPS_PER_PAIR
    return {
        "variant": variant,
        "pairblock_tflops": n * ops_per_pair / (ms * 1e-3) / 1e12,
        "pairs_gps": n / (ms * 1e-3) / 1e9,
        "wall_ms": ms,
        "t1_ms": t1 * 1e3,
        "pairs": n,
        "ops_per_pair": ops_per_pair,
        "device": torch.cuda.get_device_name(0),
    }


if __name__ == "__main__":
    for v in [a for a in sys.argv[1:] if not a.startswith("-")] or ["full"]:
        print(json.dumps(measure(v)), flush=True)
