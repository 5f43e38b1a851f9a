"""The whole path trace of a scene of spheres and triangles as one kernel,
and its plain PyTorch version.

Port of ``ray_tracing_extended_tpu/kernels/megakernel.py``: its Pallas
kernel ``_render_kernel`` traces a tile of pixels start to finish; here
``csrc/megakernel.cu`` traces one pixel per CUDA thread (see the source's
header for what it computes, what bounds it and what it does about that).
The source has two kernels, each instantiated for three scene geometries
(``geometry``): spheres only, triangles by chunk scan, and triangles
through the scene's triangle BVH (the TPU kernel's big-mesh mode); and
with the reference's Box-Muller scatter or the 2-draw fast one
(``cfg.fast_scatter``). Both run one slot loop, in which a lane whose path
ended starts its next camera sample at once (through a BVH, once its warp's
paths have all ended): ``render_kernel`` traces exactly ``spp`` samples a
pixel, bit for bit a loop over samples and bounces
(``warp_schedule_counts`` counts what the two schedules cost a warp),
``render_adaptive`` runs the adaptive sample refill
(``cfg.adaptive_spp``), in which lanes that have met their quota trace
extra samples while any lane of their tile, the TPU kernel's
(``refill_tile_size``), is still short of it: two launches, the exact slot
loop, then each lane's extra samples up to its tile's last finish. Each
of those twelve has two routes for the scene's tables
(``TABLES``): ``"staged"``, copied into each block's shared memory, and
``"global"``, read in place from global memory, for a scene whose tables
pass ``MAX_SHARED_BYTES`` (about 9,000 spheres). ``table_route`` picks the
route by size (``launch_shared_bytes``); a test forces one with
``tables=``. ``variant`` names the twenty-four instantiations.

The same source built with ``-DRTX_PROBES`` is a probe library: the
profiling instantiations (``PROBE_VARIANTS``) of the TPU kernel's knobs
(``megakernel.py:461-466``, ``PROBES``), every production one under each
knob, a library for each knob, sampler and route, built at its first
launch (``probe_library``). ``dup_intersect`` and
``dup_fetch`` do a segment's closest hit, or its winner's fetch, twice,
the second result folded so that the image cannot change; ``no_cull``
runs the scans with every gate open (the same image); ``stub_intersect``
gives every segment a hit on the JAX tables' slot 0, ``stub_fetch`` the
winner's fields as constants (``stub_row``), both changing the rays'
paths. ``render_frame_mega`` takes the knobs as the JAX function does;
``tools/profile_mega.py`` times them against the production kernel.

``render_frames_mega`` is the wrapper the renderer calls. Given a scene on
the CPU it runs ``render_frames_plain``, the same function built from the
plain modules in ``ops/`` and ``accel/bvh.py`` (the JAX package's XLA
path, op for op, and for refill the TPU kernel's slot machine, vectorised
over lanes). Given a scene on a CUDA device it launches the kernel, or
raises for what the kernel does not do; it never falls back. With
``rows=(y0, y1)`` it renders a band of the frame's rows, each pixel with
the whole frame's seed and camera ray (``band_rows``; the multi-GPU split
of ``parallel/sharding.py`` launches one band a device).

Refill makes the image depend on how pixels are grouped: the plain
version takes the grouping as a (G, P) array of pixel indices, -1 for
padding, by default the TS x TS tiles of both kernels (``tile_groups``);
``warp_groups`` are the kernel's warps (16x2 pixels of its 16x8 block).

The kernel is compiled with ``nvcc`` from the package's own source at
first use, into ``build/`` beside this package, and loaded with ctypes
(``kernels/build.py``).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import heapq
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..accel.bvh import (
    LEAF_WIDTH,
    STACK_DEPTH,
    _traverse,
    _triangle_t_one,
    closest_hit_bvh,
)
from ..models.geometry import BVH, Materials, Scene
from ..ops import rng as rng_ops
from ..ops import vecmath as vm
from ..ops.accumulate import accumulate
from ..ops.camera import Camera, camera_params, focus_points, generate_rays
from ..ops.intersect import (
    INF,
    HitRecord,
    hit_record,
    ray_spheres_t,
    ray_triangles_t,
)
from ..ops.trace import dup_intersect, trace, trace_segment
from ..utils.config import RenderConfig
from ..utils.profiling import (
    REFILL_LANE_PASS,
    REFILL_PHASE1,
    REFILL_PHASE2,
    WRAPPER_LAUNCH,
    WRAPPER_TABLE_BUILD,
    WRAPPER_TABLES,
    WRAPPER_VISIT_BUILD,
    annotate,
)
from .build import NVCC_FLAGS, BuildInfo, CudaLibrary
from .pack import (
    CLUSTER,
    SUB,
    _cluster_slots,
    fetch_fields,
    pack_spheres,
    scene_features,
)

# The ``variant_launches`` key of refill's lane pass (``refill_lanes``).
LANE_PASS = "refill_lanes"

# Dynamic shared memory one block may use on Hopper (227 KB): a scene whose
# staged tables need more takes the global route (``table_route``).
MAX_SHARED_BYTES = 232448

# The source's kParams: the launch's camera and environment parameters, f32.
N_PARAMS = 32

# The plain path's (pixels x primitives) temporaries hold at most this many
# elements each (128 MB in f32): its pixel block shrinks for scenes with
# many triangles. Images do not depend on the block size.
MAX_PAIR_ELEMENTS = 1 << 25

# The kernel's 16x8 thread block (the source's kBlockX, kBlockY): a warp
# is 32 consecutive threads of it, 16 columns by 2 rows.
BLOCK_X = 16
BLOCK_Y = 8
WARP = 32

# The chunk scan's box levels (``super_levels``): one box over each run of
# this many chunks in index order, and past this many squared one box over
# each run of this many of those; chosen on the card (csrc/megakernel.cu).
SUPER_CHUNKS = 4

# The source's kWarpScanMax: in the kSpheres instantiations a cluster visit
# whose gate ballot holds fewer live lanes runs the warp-cooperative scan (a
# ray a step, one sphere a lane), one with at least this many the per-lane
# loop (a sphere a step); chosen on the card (the source says why).
WARP_SCAN_MAX = 12

# The source's kChunkScanMax: in the kChunks instantiations a visit of k
# live lanes to a chunk of n triangles runs the warp-cooperative scan (a ray
# a step, one triangle a lane, ceil(n / 32) runs) iff k * 32 * ceil(n / 32)
# < CHUNK_SCAN_MAX * n, else the per-lane loop; chosen on the card.
CHUNK_SCAN_MAX = 12

# The sphere scan's second level: one box over each run of this many sphere
# clusters in table (Morton) order (the TPU's SUPER, pack.py:44), built
# where a scene has more than one run (``sphere_tables``).
SUPER_CLUSTERS = 32

# Adaptive refill's pixel group, the TPU kernel's tile (``refill_tile_size``):
# REFILL_TILE pixels a side, REFILL_TILE_WINNER where the JAX package's
# tables hold more than ONEHOT_MAX_SLOTS slots (its ``pack.py:50``: past it
# ``pack_scene`` picks the winner fetch, and ``tile_size`` the smaller tile).
REFILL_TILE = 128
REFILL_TILE_WINNER = 64
ONEHOT_MAX_SLOTS = 8192

# How the kernel finds a scene's triangles, in the order of the source's
# Geometry values (kSpheres, kChunks, kBvh).
GEOMETRIES = ("spheres", "chunks", "bvh")

# The BVH node table's reference to a leaf: ~(leaf row << LEAF_COUNT_BITS
# | its real slots) (the source's kLeafCountBits).
LEAF_COUNT_BITS = 3


# The profiling knobs, in the order of the source's Probe values after
# kNone (kDupIntersect, kDupFetch, kStubIntersect, kStubFetch, kNoCull):
# the TPU kernel's dup_intersect, dup_fetch, stub_intersect, stub_fetch and
# use_cull=False (megakernel.py:461-466).
PROBES = ("dup_intersect", "dup_fetch", "stub_intersect", "stub_fetch",
          "no_cull")
# The knobs' settings ``render_frames_mega`` takes: one knob, or
# ``"stubs"``, stub_intersect and stub_fetch together (the instantiation
# of kStubIntersect with the constants of stub_fetch, ``stub_row``).
PROBE_SETTINGS = PROBES + ("stubs",)
STUBS = ("stub_intersect", "stub_fetch", "stubs")

# The stub row, what stub_intersect and stub_fetch give a segment's winner
# in place of its fetch (the source's kStubRow floats): 0-2 a sphere's
# centre, 3 its r^2, 4-6 a triangle's a, 7-9 b - a, 10-12 c - a, 13-15 its
# geometric normal, 16-24 its vertex normals at a, b and c, 25 the JAX
# field is_sph (1 for a scene without triangles: the sphere's forms), 26
# whether the scene has vertex normals (the JAX feature "vnormals"); from
# STUB_MAT a material row in the kernel's layout (``geometry_tables``).
STUB_ROW = 48
STUB_MAT = 32

# Where a launch reads the scene's sphere and chunk tables, in the order of
# the source's Tables values (kStaged, kGlobal): copied into each block's
# shared memory, or in place in global memory.
TABLES = ("staged", "global")


def variant(geometry: str, adaptive: bool = False,
            fast_scatter: bool = False, probe: str | None = None,
            tables: str = "staged", knobs: bool = False) -> str:
    """The name of one instantiation of the source's kernels; with
    ``probe`` (one of ``PROBES``) a profiling one, its sampler named, as
    ``render_kernel<kSpheres, kBoxMuller, kDupIntersect>``; with
    ``tables="global"`` one of the global route, its sampler named, as
    ``render_kernel<kSpheres, kBoxMuller, kGlobal>``; with ``knobs`` a
    refill one under the lane knobs (``refill_knobs`` other than (1, 1)),
    its sampler named, as ``render_adaptive<kSpheres, kBoxMuller,
    kKnobs>``; the three in that order, as ``render_adaptive<kChunks,
    kFastScatter, kNoCull, kGlobal, kKnobs>``."""
    if tables not in TABLES:
        raise ValueError(f"tables must be one of {TABLES}, got {tables!r}")
    if probe is not None and probe not in PROBES:
        raise ValueError(f"probe must be None or one of {PROBES}, got {probe!r}")
    if knobs and not adaptive:
        raise ValueError("the lane knobs' instantiations are refill's")
    name = "render_adaptive" if adaptive else "render_kernel"
    args = f"k{geometry.capitalize()}"
    if fast_scatter:
        args += ", kFastScatter"
    elif probe is not None or tables != "staged" or knobs:
        args += ", kBoxMuller"
    if probe is not None:
        args += ", k" + "".join(w.capitalize() for w in probe.split("_"))
    if tables != "staged":
        args += ", k" + tables.capitalize()
    if knobs:
        args += ", kKnobs"
    return f"{name}<{args}>"


# Every instantiation the source compiles: the production library's, on
# the staged route and on the global one, and the probe libraries' (each
# production one under each knob).
VARIANTS = tuple(
    variant(g, a, f) for a in (False, True) for f in (False, True)
    for g in GEOMETRIES
)
GLOBAL_VARIANTS = tuple(
    variant(g, a, f, tables="global") for a in (False, True)
    for f in (False, True) for g in GEOMETRIES
)
KNOB_VARIANTS = tuple(
    variant(g, True, f, tables=t, knobs=True) for t in TABLES
    for f in (False, True) for g in GEOMETRIES
)
PROBE_VARIANTS = tuple(
    variant(g, a, f, p, t, k) for p in PROBES for t in TABLES
    for f in (False, True) for a, k in ((False, False), (True, False),
                                        (True, True))
    for g in GEOMETRIES
)
VARIANT_SPHERES = variant("spheres")
VARIANT_TRIANGLES = variant("chunks")
VARIANT_BVH = variant("bvh")

# ptxas -v of the production library's 48 instantiations (nvcc 12.9,
# sm_90a): registers, spill store bytes, spill load bytes, by variant name
# (a kKnobs one's phase 2 over the lane list as its variant with
# render_listed for render_adaptive). chip_smoke.py's build phase and the
# CUDA tests fail if one moved. render_kernel's kSpheres and kBvh values
# since it runs the slot loop (before it, a loop over samples and bounces:
# spheres (64, 12, 20), BVH (64, 60, 64), both scatters), the kSpheres
# fast-scatter pair's since their cluster scan runs across the warp (before
# it (72, 0, 0); a minimum of 7 blocks an SM, which gave 72 registers and
# no spill, made the frame slower: csrc/megakernel.cu at the launch
# bounds), the kChunks values since their chunk scan runs across the warp
# under a minimum of 8 blocks an SM (before it (64, 24, 32)),
# render_adaptive's since refill runs in two launches (before them kSpheres
# fast (64, 20, 28), kBvh (64, 4, 4), kBvh fast (64, 16, 24)), the lane
# knobs' since phase 2 runs over the lane list, and all sixteen kChunks
# values since the chunk scan walks two box levels (before them 64/36/48
# render_kernel staged, 64/28/44 global, 64/36/56 render_adaptive, 64/40/76
# kKnobs, 64/32/36 render_listed; the A/B on the card measured the levels
# with these spills, PERF.md).
PTXAS_PRODUCTION = {
    "render_kernel<kSpheres>": (72, 0, 0),
    "render_kernel<kChunks>": (64, 40, 56),
    "render_kernel<kBvh>": (64, 4, 4),
    "render_kernel<kSpheres, kFastScatter>": (64, 20, 28),
    "render_kernel<kChunks, kFastScatter>": (64, 40, 56),
    "render_kernel<kBvh, kFastScatter>": (64, 16, 20),
    "render_adaptive<kSpheres>": (72, 0, 0),
    "render_adaptive<kChunks>": (64, 56, 96),
    "render_adaptive<kBvh>": (64, 4, 8),
    "render_adaptive<kSpheres, kFastScatter>": (72, 0, 0),
    "render_adaptive<kChunks, kFastScatter>": (64, 56, 96),
    "render_adaptive<kBvh, kFastScatter>": (64, 4, 8),
    "render_kernel<kSpheres, kBoxMuller, kGlobal>": (64, 16, 24),
    "render_kernel<kChunks, kBoxMuller, kGlobal>": (64, 40, 56),
    "render_kernel<kBvh, kBoxMuller, kGlobal>": (64, 8, 8),
    "render_kernel<kSpheres, kFastScatter, kGlobal>": (64, 16, 24),
    "render_kernel<kChunks, kFastScatter, kGlobal>": (64, 40, 56),
    "render_kernel<kBvh, kFastScatter, kGlobal>": (64, 16, 24),
    "render_adaptive<kSpheres, kBoxMuller, kGlobal>": (64, 36, 64),
    "render_adaptive<kChunks, kBoxMuller, kGlobal>": (64, 56, 96),
    "render_adaptive<kBvh, kBoxMuller, kGlobal>": (64, 4, 8),
    "render_adaptive<kSpheres, kFastScatter, kGlobal>": (64, 36, 64),
    "render_adaptive<kChunks, kFastScatter, kGlobal>": (64, 56, 96),
    "render_adaptive<kBvh, kFastScatter, kGlobal>": (64, 12, 16),
    "render_adaptive<kSpheres, kBoxMuller, kKnobs>": (72, 8, 20),
    "render_adaptive<kChunks, kBoxMuller, kKnobs>": (64, 68, 120),
    "render_adaptive<kBvh, kBoxMuller, kKnobs>": (64, 4, 8),
    "render_adaptive<kSpheres, kFastScatter, kKnobs>": (72, 4, 8),
    "render_adaptive<kChunks, kFastScatter, kKnobs>": (64, 68, 120),
    "render_adaptive<kBvh, kFastScatter, kKnobs>": (64, 4, 8),
    "render_adaptive<kSpheres, kBoxMuller, kGlobal, kKnobs>": (64, 36, 88),
    "render_adaptive<kChunks, kBoxMuller, kGlobal, kKnobs>": (64, 68, 120),
    "render_adaptive<kBvh, kBoxMuller, kGlobal, kKnobs>": (64, 20, 56),
    "render_adaptive<kSpheres, kFastScatter, kGlobal, kKnobs>": (64, 36, 88),
    "render_adaptive<kChunks, kFastScatter, kGlobal, kKnobs>": (64, 68, 120),
    "render_adaptive<kBvh, kFastScatter, kGlobal, kKnobs>": (64, 20, 56),
    "render_listed<kSpheres, kBoxMuller, kKnobs>": (72, 0, 0),
    "render_listed<kChunks, kBoxMuller, kKnobs>": (64, 56, 60),
    "render_listed<kBvh, kBoxMuller, kKnobs>": (64, 4, 4),
    "render_listed<kSpheres, kFastScatter, kKnobs>": (72, 4, 4),
    "render_listed<kChunks, kFastScatter, kKnobs>": (64, 56, 60),
    "render_listed<kBvh, kFastScatter, kKnobs>": (64, 16, 16),
    "render_listed<kSpheres, kBoxMuller, kGlobal, kKnobs>": (64, 32, 56),
    "render_listed<kChunks, kBoxMuller, kGlobal, kKnobs>": (64, 56, 60),
    "render_listed<kBvh, kBoxMuller, kGlobal, kKnobs>": (64, 16, 16),
    "render_listed<kSpheres, kFastScatter, kGlobal, kKnobs>": (64, 32, 56),
    "render_listed<kChunks, kFastScatter, kGlobal, kKnobs>": (64, 56, 60),
    "render_listed<kBvh, kFastScatter, kGlobal, kKnobs>": (64, 16, 16),
}


def geometry(scene: Scene, cfg: RenderConfig) -> str:
    """The geometry the kernel takes for ``scene`` under
    ``cfg.intersector``: ``"bvh"`` for a scene with a triangle BVH unless
    the intersector is ``"bruteforce"``, else ``"chunks"`` for a scene with
    triangles and ``"spheres"``. Spheres are always scanned: a sphere BVH
    is traversed by the plain path only. Reads nothing from the device."""
    if scene.has_tri_bvh and cfg.intersector != "bruteforce":
        return "bvh"
    return "chunks" if scene.has_triangles else "spheres"


def tpu_table_slots(scene: Scene) -> int:
    """The slots of the JAX package's ``pack_scene`` tables for ``scene``
    (its ``n_slots``, ``kernels/pack.py:343-491``): the real spheres less
    the hoisted ones in blocks of ``CLUSTER``, one more block for the
    hoisted (the JAX package drops the hoist where the rest would fill
    more than one super-cluster, ``:354-358``; the port keeps it, so only
    the count follows that rule here), then, where the scene has a real
    triangle (a nonzero geometric normal), its real triangles in blocks of
    ``CLUSTER``. Counted on the host once a scene."""
    cache = _scene_cache(scene)
    if "tpu_slots" not in cache:
        def blocks(n):
            return _round_up(n, CLUSTER)

        part = _sphere_part(scene)
        n_sph, n_hoist = part["spheres"].shape[0], part["n_hoist"]  # real
        if (n_hoist and (blocks(n_sph - n_hoist) + CLUSTER) // SUB
                > SUPER_CLUSTERS):
            n_hoist = 0
        s_pad = (blocks(n_sph - n_hoist) + (CLUSTER if n_hoist else 0)
                 if n_sph else CLUSTER)
        n = scene.triangles.n.cpu().numpy()
        n_tri = int(((n * n).sum(axis=1) > 0).sum())
        cache["tpu_slots"] = s_pad + blocks(n_tri) if n_tri else s_pad
    return cache["tpu_slots"]


def refill_tile_size(scene: Scene, cfg: RenderConfig) -> int:
    """The side of the TPU kernel's refill tile for ``scene`` under ``cfg``
    (the JAX package's ``tile_size(pack_scene(scene), adaptive=True)``,
    ``kernels/megakernel.py:167-209``, less its ``RTX_MEGA_TS``, which the
    port does not read): ``cfg.mega_tile_size`` where it is set; else 64
    where the JAX package's tables would pass ``ONEHOT_MAX_SLOTS``
    (``tpu_table_slots``: its winner fetch), else 128. Adaptive refill
    groups pixels by these tiles (``tile_groups``), on the card and in the
    plain version. A side's square is a multiple of 128, so the side is a
    multiple of 16: a warp's 16x2 pixels lie in one tile."""
    ts = cfg.mega_tile_size
    if ts is not None:
        if ts <= 0 or (ts * ts) % 128:
            raise ValueError(
                "mega_tile_size must be a positive tile size with TS*TS a "
                f"multiple of 128 (e.g. 32/64/96/128), got {ts}")
        return ts
    return (REFILL_TILE if tpu_table_slots(scene) <= ONEHOT_MAX_SLOTS
            else REFILL_TILE_WINNER)


def pixels_per_lane(adaptive: bool = False, batched: bool = False,
                    paired: bool = False, override: int | None = None) -> int:
    """The TPU kernel's pixels a lane (the JAX package's
    ``pixels_per_lane``, ``kernels/megakernel.py:211-244``, less its
    ``RTX_MEGA_PPL``, which the port does not read): a lane traces that
    many pixels of its tile one after another. ``override`` is
    ``cfg.mega_pixels_per_lane``. Only refill's image depends on it
    (``refill_knobs``); an exact-spp pixel's samples are the same whatever
    lane traces them."""
    if override is not None:
        if override not in (1, 2, 4, 8):
            raise ValueError(
                f"mega_pixels_per_lane must be 1, 2, 4 or 8, got {override}")
        return override
    if paired and batched and not adaptive:
        return 4
    return 2 if (batched and not adaptive) else 1


def n_phases(override: int | None = None) -> int:
    """The TPU kernel's slot phases (the JAX package's ``n_phases``,
    ``kernels/megakernel.py:138-164``, less its ``RTX_MEGA_PHASES``): 1, or
    2, where a lane starts a camera sample on even slots only and traces a
    bounce on odd ones. ``override`` is ``cfg.mega_phases``."""
    if override is not None:
        if override not in (1, 2):
            raise ValueError(f"mega_phases must be 1 or 2, got {override}")
        return override
    return 1


def refill_knobs(scene: Scene, cfg: RenderConfig) -> tuple[int, int]:
    """``(pixels a lane, phases)`` of a refill launch of ``scene`` under
    ``cfg``: 1 and 1 unless the config says otherwise, as the JAX
    package resolves them under ``adaptive_spp``. Raises where the pixels a
    lane do not divide the refill tile's rows of 128 lanes, as it does."""
    ppl = pixels_per_lane(adaptive=True, override=cfg.mega_pixels_per_lane)
    rows = refill_tile_size(scene, cfg) ** 2 // 128
    if rows % ppl:
        raise ValueError(
            f"pixels-per-lane {ppl} must divide the tile's {rows} rows")
    return ppl, n_phases(cfg.mega_phases)


def knobbed(scene: Scene, cfg: RenderConfig) -> bool:
    """Whether a launch of ``scene`` under ``cfg`` takes the refill
    instantiations under the lane knobs (``variant(..., knobs=True)``):
    refill with more than one pixel a lane or two phases."""
    return cfg.adaptive_spp and refill_knobs(scene, cfg) != (1, 1)


def launches_per_call(cfg: RenderConfig) -> int:
    """Kernel launches a call of ``render_frames_mega`` on the card makes
    (``PathTraceKernel.launch``): refill's two phases, with more than one
    pixel a lane the lane pass between them (``refill_lanes``), or one."""
    if not cfg.adaptive_spp:
        return 1
    ppl = pixels_per_lane(adaptive=True, override=cfg.mega_pixels_per_lane)
    return 3 if ppl > 1 else 2


def refill_band_rows(cfg: RenderConfig) -> int:
    """What the height of a band of a refill launch is a multiple of, for
    any scene (``parallel/sharding.py``): ``cfg.mega_tile_size`` where it
    is set, else ``REFILL_TILE``, a multiple of both default tile sides."""
    return cfg.mega_tile_size or REFILL_TILE


def plain_through_sphere_bvh(scene: Scene, cfg: RenderConfig) -> bool:
    """Whether the plain path takes the one case the kernel has no
    counterpart of, the JAX package's XLA path: ``"auto"`` and ``"bvh"`` on
    a scene with a sphere BVH traverse it (``closest_hit_bvh``)."""
    return cfg.intersector in ("auto", "bvh") and scene.sphere_bvh is not None


def plain_intersector(scene: Scene, camera: Camera, cfg: RenderConfig,
                      counts=None, direct: bool = False, cull: bool = True):
    """The plain path's closest-hit function for ``cfg.intersector``:
    ``closest_hit_clustered`` on the tables of ``geometry(scene, cfg)`` in
    ``camera``'s visit order (``visit_tables``), the function a launch from
    that camera computes for this scene and config; ``closest_hit_bvh``
    where ``plain_through_sphere_bvh``. ``counts``, a dict, gathers the
    tests the clustered scan needs (``closest_hit_clustered``); ``direct``
    takes the kernel's test forms there (``clustered_winner``). Without
    ``cull`` (the knob ``no_cull``) the clustered scan with every gate
    open, for every scene."""
    if cull and plain_through_sphere_bvh(scene, cfg):
        return closest_hit_bvh
    return functools.partial(
        closest_hit_clustered,
        tables=visit_tables(scene, geometry(scene, cfg), camera),
        counts=counts, direct=direct, cull=cull)


def launch_shared_bytes(tab: KernelTables, max_bounce: int,
                        tables: str = "staged") -> int:
    """A launch's dynamic shared memory for tables ``tab`` on the route
    ``tables``, in bytes (the source's ``shared_bytes``, which
    ``PathTraceKernel.shared_bytes`` asks): staged, 16 bytes a float4 row
    (a sphere; two a cluster, a chunk of a chunk scan, a box of either of
    its levels) and 4 bytes a parameter, a sphere's scene index, its
    material index and a bounce of the histogram; global, the parameters
    and the histogram only."""
    if tables not in TABLES:
        raise ValueError(f"tables must be one of {TABLES}, got {tables!r}")
    words = N_PARAMS + max_bounce + 1
    if tables == "global":
        return 4 * words
    n_sph = tab.spheres.shape[0]
    rows = n_sph + 2 * tab.clusters.shape[0]
    if tab.geometry == "chunks":
        rows += 2 * tab.chunks.shape[0]
        if tab.supers is not None:
            rows += 2 * tab.supers.shape[0]
    return 16 * rows + 4 * (words + 2 * n_sph)


def table_route(tab: KernelTables, cfg: RenderConfig) -> str:
    """The route of a launch over tables ``tab``: ``"staged"`` if they fit
    a block's shared memory (``launch_shared_bytes`` within
    ``MAX_SHARED_BYTES``), else ``"global"``. Reads nothing from the
    device."""
    fits = launch_shared_bytes(tab, cfg.max_bounce) <= MAX_SHARED_BYTES
    return "staged" if fits else "global"


def path_name(scene: Scene, cfg: RenderConfig) -> str:
    """What renders ``scene`` under ``cfg``: on a CUDA device the kernel's
    instantiation (``variant``, on the route ``table_route`` picks), on the
    CPU the plain version's closest-hit function (``plain_intersector``)
    and its geometry. Several intersector
    names can take one path: on the card every name on a scene without a
    triangle BVH, and every name but ``"bruteforce"`` on a scene with
    one."""
    if scene.device.type == "cuda":
        geom = geometry(scene, cfg)
        return variant(geom, cfg.adaptive_spp, cfg.fast_scatter,
                       tables=table_route(geometry_tables(scene, geom), cfg),
                       knobs=knobbed(scene, cfg))
    if plain_through_sphere_bvh(scene, cfg):
        return "plain closest_hit_bvh"
    return f"plain closest_hit_clustered<{geometry(scene, cfg)}>"


# ------------------------------ plain version -------------------------------


def _slab_interval(o, inv_d, bmin, bmax):
    """Every ray's slab interval with every box -> ``(t_near, t_far)``, each
    (B, K). An axis whose ``t0`` or ``t1`` is NaN (a zero direction
    component with the origin on that face's plane: the ray's line lies in
    the plane) leaves the interval as it is, the reference's rule
    (RayTracing.shader:177-187, whose min and max drop a NaN operand): it
    can never reject, so no primitive that a scan without boxes would hit
    is skipped for it."""
    t0 = (bmin[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    t1 = (bmax[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    free = torch.isnan(t0) | torch.isnan(t1)
    t_near = torch.where(free, -INF, torch.minimum(t0, t1)).amax(dim=-1)
    t_far = torch.where(free, INF, torch.maximum(t0, t1)).amin(dim=-1)
    return t_near, t_far


def _gated_visits(t_near, t_far, nearest, best0, outer=()):
    """Which boxes a scan in table order visits behind the t-bounded slab
    test: box k iff ``t_far >= 0 and t_near <= min(t_far, best)``, where
    ``best`` is the nearest hit so far: ``best0`` (B,) before the first
    box, then the least of it and ``nearest`` (B, K, the nearest hit among
    a box's members, +inf for none) of the boxes visited. ``outer`` lists
    levels of boxes above them, innermost first, each ``(t_near, t_far,
    starts)``: the intervals (B, R) of a box over each of R consecutive runs
    of the level below (the boxes themselves for the first) and the (R,)
    int64 index there of each run's first member (0 first, ascending). A
    run is entered only if its box passes the same test, with ``best`` as
    it is at the run's first box, and its own run, a level up, was entered.
    -> ``(visit (B, K) bool, entered)``: ``entered`` lists, a level of
    ``outer`` each, which of its boxes each ray entered (B, R).

    Computed without a loop over boxes. A box skipped for ``t_near > best``
    holds, as a rule, nothing nearer than ``best``; then ``best`` before
    box k is the running minimum over all boxes before k that the line
    test alone passes, one ``cummin``. The exception is a skipped box with
    a member nearer than ``best`` (a near-tie: rounding put the member
    before its box's entry, ``best`` between the two): the running minimum
    took a hit the scan never saw. The first such box of a ray is certain
    (everything before it is right), so it is taken out of that ray's
    minimum and the ray is scanned again, until none is left: a pass or
    two over a few rays."""
    n = t_near.shape[1]
    dev = t_near.device
    line = (t_far >= 0.0) & (t_near <= t_far)
    # per level: each member's run (``run_of``), the first box of each run
    # (``first``), and each box's run at that level (``above``)
    run_ofs, firsts, o_lines = [], [], []
    first, above = torch.arange(n, device=dev), torch.arange(n, device=dev)
    for o_near, o_far, starts in outer:
        run_of = torch.zeros(first.shape[0], dtype=torch.int64, device=dev)
        run_of[starts[1:]] = 1
        run_of = run_of.cumsum(0)
        first, above = first[starts], run_of[above]
        run_ofs.append(run_of)
        firsts.append(first)
        o_lines.append((o_far >= 0.0) & (o_near <= o_far))
        line = line & o_lines[-1][:, above]

    def scan(rows, unseen):
        """One pass over the rays ``rows`` (all of them for None), the
        boxes ``unseen`` (rows, K) out of the minimum -> (visit, entered,
        skipped boxes with a member nearer than the best so far)."""
        def of(x):
            return x if rows is None else x[rows]

        ln, tn, m = of(line), of(t_near), of(nearest)
        counted = ln if unseen is None else ln & ~unseen
        reach = torch.where(counted, m, INF)
        before = torch.cummin(
            torch.cat([of(best0)[:, None], reach[:, :-1]], dim=1), dim=1
        ).values
        visit = ln & (tn <= before)
        entered = [None] * len(outer)
        for lev in reversed(range(len(outer))):
            e = of(o_lines[lev]) & (of(outer[lev][0]) <= before[:, firsts[lev]])
            if lev + 1 < len(outer):
                e &= entered[lev + 1][:, run_ofs[lev + 1]]
            entered[lev] = e
        if outer:
            visit &= entered[0][:, run_ofs[0]]
        return visit, entered, counted & ~visit & (m < before)

    visit, entered, wrong = scan(None, None)
    rows = wrong.any(dim=1).nonzero().squeeze(1)
    if rows.numel():
        wrong = wrong[rows]
        unseen = torch.zeros_like(wrong)
        while True:
            has = wrong.any(dim=1).nonzero().squeeze(1)
            if not has.numel():
                break
            unseen[has, wrong[has].to(torch.int8).argmax(dim=1)] = True
            v, e, wrong = scan(rows, unseen)
        visit[rows] = v
        for lev, e_lev in enumerate(e):
            entered[lev][rows] = e_lev
    return visit, entered


def _group_min(t, members):
    """(B, P) hit distances -> (B, G) least distance of each group's
    members, +inf for a group without a hit. ``members`` (G, M) int64 holds
    each group's columns of ``t``, filled up with P (a column of +inf)."""
    return F.pad(t, (0, 1), value=INF)[:, members].amin(dim=2)


def _members(group_of: np.ndarray, n_groups: int, pad: int) -> np.ndarray:
    """(n_groups, M) int64: row g lists the positions where ``group_of`` is
    g (groups at or beyond ``n_groups`` are left out), filled up with
    ``pad``; M is the largest group's size, at least 1."""
    keep = np.nonzero(group_of < n_groups)[0]
    order = keep[np.argsort(group_of[keep], kind="stable")]
    sizes = np.bincount(group_of[keep], minlength=n_groups)
    out = np.full((n_groups, max(1, int(sizes.max(initial=0)))), pad, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    within = np.arange(len(order)) - np.repeat(starts, sizes)
    out[group_of[order], within] = order
    return out


def closest_hit_clustered(o, d, scene: Scene, tables: KernelTables,
                          counts=None, direct: bool = False,
                          visits=None, cull: bool = True) -> HitRecord:
    """The kernel's closest hit in plain PyTorch (``clustered_winner``) as
    a hit record."""
    return hit_record(o, d, scene, *clustered_winner(
        o, d, scene, tables, counts, direct, visits, cull))


def kernel_sphere_t(o, d, spheres) -> torch.Tensor:
    """Hit distances of every (ray, sphere) pair, (B, S), +inf on a miss,
    in the kernel's direct form (``csrc/megakernel.cu`` test_spheres, the
    TPU kernel's): ``oc = o - c``, ``b = dot(oc, d)``, ``cc = dot(oc, oc) -
    r^2``, the root ``-b - sqrt(b^2 - cc)`` where that is not negative.
    ``ops/intersect.ray_spheres_t`` is the JAX package's expanded form of
    the same quadratic; the two round differently."""
    r = spheres.radius
    oc = o[:, None, :] - spheres.center[None, :, :]
    b = vm.dot(oc, d[:, None, :])
    cc = vm.dot(oc, oc) - (r * r)[None, :]
    disc = b * b - cc
    t = -b - vm.sqrt(torch.clamp(disc, min=0.0))
    valid = (disc >= 0.0) & (t >= 0.0) & (r > 0.0)[None, :]
    return torch.where(valid, t, INF)


def clustered_winner(o, d, scene: Scene, tables: KernelTables, counts=None,
                     direct: bool = False, visits=None, cull: bool = True):
    """The kernel's closest hit in plain PyTorch -> ``(t (B,), index (B,))``
    as ``hit_record`` takes them: ``closest_hit_bruteforce`` behind the
    kernel's culls, with its pair tests (so a distance is computed by the
    same operations whether or not a cull comes first). With ``direct`` the
    sphere and chunk-scan triangle tests take the kernel's direct forms
    instead (``kernel_sphere_t``; ``accel/bvh._triangle_t_one``, the BVH's
    test), so that the kernel and this function run the same arithmetic op
    for op (``bench.py``'s gate (a)); the culls and counts are the same.

    Spheres: the hoisted ones, then each sub-cluster of ``tables.clusters``
    in the order of its rows (``visit_tables``: a camera's front-to-back
    order, or table order) behind the t-bounded slab test
    (``_gated_visits``, ``_slab_interval`` for the NaN rule); with
    ``tables.sph_supers`` a run of clusters is entered only if its super
    box passes the same test. Among the spheres tested the nearest wins,
    the lower scene index on a tie, so the order decides no tie (it decides
    only which near-ties a box's entry culls). Then the triangles, by
    ``tables.geometry``: each chunk
    in index order behind the same test (spheres first, so the best hit is
    often finite already), a run of chunks entered only if each box above
    it (``chunk_box_levels``) passes the test, a strictly nearer triangle
    winning and the lower index a tie; or through the triangle BVH
    (``accel/bvh._traverse``, from +inf, its winner taken if strictly
    nearer).

    ``counts``, a dict, if given, gains what the scan does for the rays
    that are live (the plain path parks dead lanes at 1e9): ``segments``,
    ``cluster_slabs`` (with supers, every super box and the cluster boxes
    of the supers entered; ``super_slabs`` the former), ``sphere_tests``,
    ``chunk_slabs`` (every box test of the chunk scan, at every level of
    ``chunk_box_levels``: each box of the top level, and beneath it the
    boxes of the runs entered; ``super_slabs`` those above the chunks, and
    ``super_slabs_1``, ``super_slabs_2`` those of each level, the first the
    one over the chunks), ``triangle_tests``, beside them
    ``line_triangle_tests`` (the triangles of every chunk whose box the
    ray's line meets: what the reference's gate, without the bound, would
    test), and for the BVH ``_traverse``'s counts (with the parked lanes' root tests, ``parked`` of them: each
    one slab, one pop, one pop reject and ``ROOT_BYTES``).

    ``visits``, a list, if given, gains one entry a call: ``(live (B,)
    bool, the cluster rows each ray tested (B, K) bool, in the rows' order,
    the chunks it tested (B, C) bool or None for the other geometries)``,
    from which ``warp_schedule_counts`` counts a warp's unions.

    Without ``cull`` (the profiling knob ``no_cull``, the TPU kernel's
    ``use_cull=False``) every gate is open: every sphere is tested, every
    chunk's triangles, and for the BVH geometry every triangle in index
    order with the traversal's test (a strictly nearer one winning), no box
    is tested (``counts`` gains no slab). The winner is the lexicographic
    minimum of (t, index) either way, so the hit is the culled one's."""
    b = o.shape[0]
    dev = o.device
    inv_d = 1.0 / d
    s = scene.spheres.count
    n_clusters = tables.clusters.shape[0]
    live = None
    if counts is not None:
        live = o[:, 0] < 1e8
        counts["segments"] = counts.get("segments", 0) + int(live.sum())

    def add(key, per_ray):
        counts[key] = counts.get(key, 0) + int(per_ray[live].sum())

    def weighted(mask, weights):
        # (B, K) bool x (K,) integer -> (B,) int64 (CUDA has no integer
        # matrix product)
        return (mask * weights.to(torch.int64)[None, :]).sum(dim=1)

    # spheres: hoisted (column n_clusters, always tested), then clusters in
    # the order of their rows; nearest and tested by table index
    t_sph = (kernel_sphere_t if direct else ray_spheres_t)(o, d, scene.spheres)
    nearest = _group_min(t_sph, tables.cluster_members)
    tested = torch.zeros((b, n_clusters + 2), dtype=torch.bool, device=dev)
    tested[:, n_clusters] = True
    cl, su, row_of = tables.clusters, tables.sph_supers, tables.cluster_order
    entered = None
    if not cull:
        tested[:, :n_clusters] = True
        su = None
    elif n_clusters:
        t_near, t_far = _slab_interval(o, inv_d, cl[:, 0:3], cl[:, 4:7])
        outer = []
        if su is not None:
            outer = [(*_slab_interval(o, inv_d, su[:, 0:3], su[:, 4:7]),
                      _int_column(su, 3).to(torch.int64))]
        visit, entered = _gated_visits(t_near, t_far, nearest[:, row_of],
                                       nearest[:, n_clusters], outer)
        entered = entered[0] if outer else None
        tested[:, row_of] = visit
    if visits is not None:
        visits.append([o[:, 0] < 1e8, tested[:, row_of], None])
    t_sph = torch.where(tested[:, tables.cluster_of], t_sph, INF)
    best_t, best = torch.min(t_sph, dim=1)
    if counts is not None:
        if cull and entered is None:
            add("cluster_slabs", torch.full((b,), n_clusters, device=dev))
        elif cull:
            add("cluster_slabs",
                su.shape[0] + weighted(entered, _int_column(su, 7)))
            add("super_slabs", torch.full((b,), su.shape[0], device=dev))
        # a cluster's live slots, int32 bits in its row's last column
        add("sphere_tests", tables.n_hoist + weighted(
            tested[:, row_of], _int_column(cl, 7)))

    if tables.geometry == "chunks":
        ch = tables.chunks
        n_chunks = ch.shape[0]
        if direct:
            t_tri = _triangle_t_one(
                o[:, None, :], d[:, None, :], scene,
                torch.arange(scene.triangles.count, device=dev)[None, :])
        else:
            t_tri = ray_triangles_t(o, d, scene.triangles)
        nearest = _group_min(t_tri, tables.chunk_members)
        t_near, t_far = _slab_interval(o, inv_d, ch[:, 0:3], ch[:, 4:7])
        # the box levels over the chunks, innermost first: each level's
        # boxes, and the size and first index of each one's run beneath
        levels = []
        below = n_chunks
        for rows in (chunk_box_levels(tables.supers, n_chunks) if cull else ()):
            members = torch.arange(below, device=dev)
            levels.append((rows, torch.bincount(members // SUPER_CHUNKS),
                           members[::SUPER_CHUNKS]))
            below = rows.shape[0]
        visit = torch.zeros((b, n_chunks + 1), dtype=torch.bool, device=dev)
        if cull:
            visit[:, :n_chunks], entered = _gated_visits(
                t_near, t_far, nearest, best_t,
                [(*_slab_interval(o, inv_d, rows[:, 0:3], rows[:, 4:7]),
                  starts) for rows, _, starts in levels])
        else:
            visit[:, :n_chunks] = True
        if visits is not None:
            visits[-1][2] = visit[:, :n_chunks]
        t_tri = torch.where(visit[:, tables.chunk_of], t_tri, INF)
        t_t, i_t = torch.min(t_tri, dim=1)
        if counts is not None and cull:
            # the box tests of each level, the chunks' first: every box of
            # the top one, and beneath it the runs of the boxes entered
            tests = [weighted(entered[lev], sizes)
                     for lev, (_, sizes, _) in enumerate(levels)]
            tests.append(torch.full((b,), below, device=dev))
            add("chunk_slabs", sum(tests))
            for lev, per_ray in enumerate(tests[1:], 1):
                add(f"super_slabs_{lev}", per_ray)
            if levels:
                add("super_slabs", sum(tests[1:]))
        if counts is not None:
            n_tris = scene.chunks.num_tris
            add("triangle_tests", weighted(visit[:, :n_chunks], n_tris))
            add("line_triangle_tests", weighted(t_near <= t_far, n_tris))
    elif tables.geometry == "bvh" and not cull:
        t_t, i_t = _all_triangles(o, d, scene)
        if counts is not None:
            add("triangle_tests", torch.full((b,), scene.triangles.count,
                                             device=dev))
    elif tables.geometry == "bvh":
        inf = torch.full((b,), INF, dtype=torch.float32, device=dev)
        if counts is not None:
            counts["parked"] = counts.get("parked", 0) + int((~live).sum())
        t_t, i_t = _traverse(
            o, d, scene.tri_bvh,
            lambda o_, d_, idx: _triangle_t_one(o_, d_, scene, idx), inf,
            torch.zeros((b,), dtype=torch.int64, device=dev), counts,
            tables.bvh_sentinel,
        )
    else:
        return best_t, best
    # strict <: a sphere keeps an exact tie with a triangle
    better = t_t < best_t
    return torch.where(better, t_t, best_t), torch.where(better, s + i_t, best)


def _all_triangles(o, d, scene: Scene):
    """Every triangle against every ray in index order with the BVH's
    test (``accel/bvh._triangle_t_one``) -> ``(t (B,), index (B,))``, +inf
    without a hit; the first of equal nearest hits wins, as a strict < in
    index order keeps. In runs of triangles, so that no (rays x triangles)
    temporary passes ``MAX_PAIR_ELEMENTS``."""
    b, n = o.shape[0], scene.triangles.count
    t_best = torch.full((b,), INF, dtype=torch.float32, device=o.device)
    i_best = torch.zeros((b,), dtype=torch.int64, device=o.device)
    step = max(1, MAX_PAIR_ELEMENTS // max(b, 1))
    for t0 in range(0, n, step):
        idx = torch.arange(t0, min(t0 + step, n), device=o.device)
        t, i = torch.min(_triangle_t_one(o[:, None, :], d[:, None, :], scene,
                                         idx[None, :]), dim=1)
        nearer = t < t_best
        t_best = torch.where(nearer, t, t_best)
        i_best = torch.where(nearer, t0 + i, i_best)
    return t_best, i_best


def winner_fetch(scene: Scene) -> bool:
    """Whether the JAX package's kernel fetches a scene's winners by its
    winner post-pass (``pack.py:605``: more than ``ONEHOT_MAX_SLOTS``
    table slots, ``tpu_table_slots``), where its ``stub_fetch`` does
    nothing."""
    return tpu_table_slots(scene) > ONEHOT_MAX_SLOTS


def probe_instantiation(scene: Scene, probe: str | None,
                        cfg: RenderConfig) -> str | None:
    """The profiling instantiation (one of ``PROBES``, or None for the
    production one) that the knob setting ``probe`` (one of
    ``PROBE_SETTINGS``) takes for ``scene`` under ``cfg``: ``"stubs"`` is
    stub_intersect's; under the JAX package's winner fetch
    (``winner_fetch``) stub_fetch is the production kernel, as the TPU
    kernel's fetch returns before its stub (``megakernel.py:1382-1388``).

    Raises NotImplementedError for stub_intersect (alone or in
    ``"stubs"``) in two cases. Under the winner fetch: the TPU kernel's
    winner fetch then reads the winner's cluster and encoded t from
    scratch that only its closest hit writes (``best_clu_ref`` /
    ``best_enc_ref``, set at ``megakernel.py:637-638``, read at
    ``:1268-1269``), never written under the stub, so its result is
    undefined. Under two phases (``cfg.mega_phases`` 2, exact or refill):
    the stub gives the lanes waiting for their phase a hit too, and the
    segment body, whose scatter is not masked by participation
    (``megakernel.py:1556``), moves them and blends their throughput and
    origin with the scatter's (``:1687-1700``), which a kernel that leaves
    a waiting lane as it is does not reproduce."""
    _check_probe(probe)
    if probe is None or probe not in STUBS:
        return probe
    if winner_fetch(scene):
        if probe == "stub_fetch":
            return None
        raise NotImplementedError(
            "stub_intersect under the JAX package's winner fetch (more than "
            f"{ONEHOT_MAX_SLOTS} table slots) has no defined result: the TPU "
            "kernel's winner fetch reads scratch only its closest hit writes "
            "(ray_tracing_extended_tpu/kernels/megakernel.py:637-638, "
            ":1268-1269), and the stub skips it")
    if probe == "stub_fetch":
        return "stub_fetch"
    if n_phases(cfg.mega_phases) > 1:
        raise NotImplementedError(
            "stub_intersect under two phases: the TPU kernel's stub hits the "
            "lanes waiting for their phase too, and its segment body scatters "
            "them and blends their throughput and origin "
            "(ray_tracing_extended_tpu/kernels/megakernel.py:1556, "
            ":1687-1700); this kernel leaves a waiting lane as it is")
    return "stub_intersect"


def tpu_slot_zero(scene: Scene) -> int | None:
    """The scene index of the sphere in slot 0 of the JAX package's
    ``pack_scene`` tables, or None where it is a padding slot (a scene
    without a real sphere). Slot 0 is the first sub-cluster's first slot,
    which holds a real sphere wherever there is one (``_cluster_slots``
    fills every sub-cluster it makes from its start). Where the JAX
    package keeps the hoist, that sub-cluster is the port's first cluster
    (``sphere_tables``); where it drops it (``tpu_table_slots``), its
    clustering of every real sphere is made here."""
    radii = scene.spheres.radius.cpu().numpy()
    real_s = np.nonzero(radii > 0)[0]
    if not len(real_s):
        return None
    part = _sphere_part(scene)
    n_hoist = part["n_hoist"]
    n_reg = len(real_s) - n_hoist
    if n_hoist and (_round_up(n_reg, CLUSTER) + CLUSTER) // SUB > SUPER_CLUSTERS:
        centers = scene.spheres.center.cpu().numpy()
        rr = radii[real_s][:, None]
        slots, _ = _cluster_slots(centers[real_s] - rr, centers[real_s] + rr)
        return int(real_s[slots[0]])
    return int(part["sphere_orig"][n_hoist])


def stub_row(scene: Scene, probe: str) -> np.ndarray:
    """The stub row (``STUB_ROW`` f32, layout at ``STUB_ROW``) of the knob
    setting ``probe`` (one of ``STUBS``) for ``scene``: what the TPU
    kernel's segment body reads from a winner's fetch under it
    (``megakernel.py:1382-1388``, ``:1454-1620``). stub_fetch (and
    ``"stubs"``): the constant ``0.1 + 0.01 * i`` for the field at place i
    of the scene's fetch fields (``kernels/pack.fetch_fields``), 0 for a
    field the scene does not fetch; stub_intersect alone: the fields of
    the sphere in the JAX tables' slot 0 (``tpu_slot_zero``; a padding
    slot's centre 0 and radius -1, so r^2 1, and the material of the
    scene's first sphere row). The JAX kernel reads some fields only for
    some scenes, and the row follows it: the emission strength only for an
    emissive scene (0 otherwise: no emission is added), the flag only where
    a material has a flag (0 otherwise), is_sph only with triangles (1
    otherwise). Made on the host once a scene and setting."""
    cache = _scene_cache(scene)
    key = ("stub_row", probe)
    if key in cache:
        return cache[key]
    mats, tri = scene.materials, scene.triangles
    host = {name: getattr(mats, name).cpu().numpy() for name in (
        "colour", "emission_colour", "specular_colour", "emission_strength",
        "smoothness", "specular_probability", "ior", "flag")}
    feats = scene_features(host["flag"], host["emission_strength"],
                           *(getattr(tri, f).cpu().numpy() for f in (
                               "n", "normal_a", "normal_b", "normal_c")))
    row = np.zeros(STUB_ROW, np.float32)
    m = row[STUB_MAT:]
    if probe == "stub_intersect":
        s0 = tpu_slot_zero(scene)
        sph = scene.spheres
        if s0 is None:
            centre, r = np.zeros(3, np.float32), np.float32(-1.0)
            s0 = 0
        else:
            centre = sph.center[s0].cpu().numpy()
            r = np.float32(sph.radius[s0].cpu())
        mat = int(sph.mat_idx[s0]) if sph.count else 0
        row[0:3], row[3] = centre, r * r
        row[25] = 1.0
        m[0:3], m[3:6] = host["colour"][mat], host["emission_colour"][mat]
        m[6:9], m[9] = host["specular_colour"][mat], host["emission_strength"][mat]
        m[10], m[11] = host["smoothness"][mat], host["specular_probability"][mat]
        m[12], m[13] = host["ior"][mat], host["flag"][mat]
    else:
        value = {f: np.float32(0.1 + 0.01 * i)
                 for i, f in enumerate(fetch_fields(feats))}

        def get(*names):
            return [value.get(n, np.float32(0.0)) for n in names]

        def xyz(base):
            return get(f"{base}_x", f"{base}_y", f"{base}_z")

        row[0:4] = get("scx", "scy", "scz", "sr2")
        for at, base in ((4, "pa"), (7, "eab"), (10, "eac"), (13, "gn"),
                         (16, "na"), (19, "nb"), (22, "nc")):
            row[at:at + 3] = xyz(base)
        row[25] = get("is_sph")[0] if "tris" in feats else 1.0
        m[9:14] = get("estr", "smooth", "sprob", "ior", "flag")
        m[0:3] = get("col_r", "col_g", "col_b")
        m[3:6] = get("em_r", "em_g", "em_b")
        m[6:9] = get("spec_r", "spec_g", "spec_b")
    row[26] = float("vnormals" in feats)
    if "emissive" not in feats:
        m[9] = 0.0
    if not {"checker", "invisible", "dielectric"} & set(feats):
        m[13] = 0.0
    cache[key] = row
    return row


def stub_surface(o, d, row: torch.Tensor, is_sph: bool, vnormals: bool):
    """The hit point and shading normal the TPU kernel's segment body
    derives from a winner's fetched fields (``megakernel.py:1487-1530``),
    for the stub row ``row`` (``stub_row``, on the rays' device): the
    winner's distance recomputed from its fields (a sphere's
    ``-b - sqrt(max(b^2 - cc, 0))`` in the ``o - c`` form, or a triangle's
    ``dot(o - a, n) * (1 / det)``), then the sphere's normal at that point,
    or the triangle's vertex normals interpolated there (with ``vnormals``;
    else the one at a), normalised. The CUDA kernel's ``stub_surface`` runs
    the same operations."""
    sc = row[0:3]
    oc = o - sc
    b = vm.dot(oc, d)
    cc = vm.dot(oc, oc) - row[3]
    t = -b - vm.sqrt(torch.clamp(b * b - cc, min=0.0))
    if not is_sph:
        ao = o - row[4:7]
        gn = row[13:16].expand_as(d)
        det = -vm.dot(d, gn)
        inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
        t = vm.dot(ao, gn) * inv_det
    point = o + d * t[:, None]
    if is_sph:
        return point, vm.normalize(point - sc)
    if not vnormals:
        return point, vm.normalize(row[16:19].expand_as(d))
    dao = vm.cross(ao, d)
    u = vm.dot(row[10:13].expand_as(d), dao) * inv_det
    v = -vm.dot(row[7:10].expand_as(d), dao) * inv_det
    w = 1.0 - u - v
    raw = (row[16:19] * w[:, None] + row[19:22] * u[:, None]
           + row[22:25] * v[:, None])
    return point, vm.normalize(raw)


def stub_intersector(intersect_fn, row: np.ndarray, intersect: bool, device):
    """``intersect_fn`` under a stub knob, with the stub row ``row``
    (``stub_row``): with ``intersect`` (stub_intersect, the TPU kernel's
    ``t, code = 2, 0``, ``megakernel.py:2030-2031``) every ray hits and no
    closest hit is computed; else (stub_fetch) the closest hit decides only
    whether a ray hits. A hit's point, normal and material are the stub
    row's (``stub_surface``; ``HitRecord.material``)."""
    r = torch.from_numpy(row).to(device)
    c = STUB_MAT
    mat = Materials(
        colour=r[None, c:c + 3], emission_colour=r[None, c + 3:c + 6],
        specular_colour=r[None, c + 6:c + 9],
        emission_strength=r[c + 9:c + 10], smoothness=r[c + 10:c + 11],
        specular_probability=r[c + 11:c + 12], ior=r[c + 12:c + 13],
        flag=r[c + 13:c + 14].to(torch.int32))
    is_sph, vnormals = bool(row[25] > 0.5), bool(row[26])

    def fn(o, d, scene):
        b = o.shape[0]
        zeros = torch.zeros((b,), dtype=torch.int64, device=o.device)
        if intersect:
            hit = torch.ones((b,), dtype=torch.bool, device=o.device)
            t, index = torch.full((b,), 2.0, device=o.device), zeros
        else:
            h = intersect_fn(o, d, scene)
            hit, t, index = h.hit, h.t, h.index
        point, normal = stub_surface(o, d, r, is_sph, vnormals)
        return HitRecord(hit=hit, t=t, point=point, normal=normal,
                         mat_idx=zeros, index=index, material=mat.take(zeros))

    return fn


def emissive_copy(scene: Scene, strength: float = 0.5) -> Scene:
    """``scene`` with every material emitting its own colour at
    ``strength``: a stub_intersect frame of a scene whose slot 0 emits
    nothing is black wherever no ray reaches the sky, which holds a
    kernel to nothing; of this copy it is lit, and depends on the slot's
    material and on every segment's throughput. A new scene object, so its
    tables are its own."""
    mats = scene.materials
    return dataclasses.replace(scene, materials=dataclasses.replace(
        mats, emission_colour=mats.colour.clone(),
        emission_strength=torch.full_like(mats.emission_strength, strength)))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plain_block_size(cfg: RenderConfig, scene: Scene, n: int) -> int:
    """Pixels per block of the plain path for ``n`` pixels: ``cfg.block_size``
    (as in the JAX package's XLA path), cut to a multiple of 256 that keeps
    each (pixels x (spheres + triangles)) temporary within
    ``MAX_PAIR_ELEMENTS`` (where a BVH carries the triangles, their
    column is the traversal stack's width)."""
    tri = (STACK_DEPTH if geometry(scene, cfg) == "bvh"
           else scene.triangles.count)
    prims = scene.spheres.count + tri
    cap = max(256, MAX_PAIR_ELEMENTS // prims // 256 * 256)
    return min(cfg.block_size, cap, _round_up(n, 256))


def _padded_pixel_blocks(block: int, start: int, stop: int) -> np.ndarray:
    """(nb, block) pixel indices covering pixels ``start .. stop - 1``;
    padding lanes repeat the last pixel (they are traced and counted in the
    segment total, then dropped), as the JAX package's XLA path lays out
    the whole image."""
    n = stop - start
    idx = start + np.minimum(np.arange(_round_up(n, block)), n - 1)
    return idx.reshape(-1, block)


def render_block(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frame,
    pix_idx: torch.Tensor,
    intersect_fn=None,
    with_bounce_counts: bool = False,
    n_real: int | None = None,
    dup_fetch: bool = False,
):
    """One flat block of pixels -> ``(mean radiance (B, 3), segments (B,))``
    plus, with ``with_bounce_counts``, the (max_bounce + 1,) live counts of
    its first ``n_real`` pixels (all of them by default; a block's padding
    lanes come last).

    ``pix_idx`` holds global pixel indices ``y * width + x``. The spp loop
    is sequential: one PCG state runs through all of a pixel's samples
    (RayTracing.shader:374-385). ``cfg.fast_scatter`` picks the 2-draw
    scatter sampler; ``cfg.adaptive_spp`` is not read here (see
    ``render_frames_plain``). ``dup_fetch`` sets that profiling knob
    (``ops/trace.fetch_again``)."""
    x = pix_idx % cfg.width
    y = pix_idx // cfg.width
    state = rng_ops.seed(pix_idx, frame)
    fp = focus_points(camera, x, y, cfg.width, cfg.height)
    dev = pix_idx.device
    total = torch.zeros((pix_idx.shape[0], 3), dtype=torch.float32, device=dev)
    segs = torch.zeros(pix_idx.shape[0], dtype=torch.int32, device=dev)
    counts = torch.zeros(cfg.max_bounce + 1, dtype=torch.int32, device=dev)
    bounces = torch.arange(cfg.max_bounce + 1, device=dev)
    for _ in range(cfg.spp):
        state, origin, direction = generate_rays(state, camera, fp, cfg.width)
        state, light, s = trace(
            state, origin, direction, scene, cfg.max_bounce,
            intersect_fn=intersect_fn, fast_scatter=cfg.fast_scatter,
            dup_fetch=dup_fetch,
        )
        total = total + light
        segs = segs + s
        # a path is live at bounce index b iff it traced more than b segments
        counts += (s[:n_real, None] > bounces).sum(0, dtype=torch.int32)
    mean = vm.div(total, float(cfg.spp))
    if with_bounce_counts:
        return mean, segs, counts
    return mean, segs


def _render_frame_plain(scene, camera, cfg, frame, y0, y1, intersect_fn,
                        dup_fetch):
    dev = scene.device
    imgs, segs, counts = [], [], []
    start, stop = y0 * cfg.width, y1 * cfg.width
    block_size = plain_block_size(cfg, scene, stop - start)
    for i, block in enumerate(_padded_pixel_blocks(block_size, start, stop)):
        pix = torch.from_numpy(block).to(dev)
        img, s, c = render_block(scene, camera, cfg, frame, pix,
                                 intersect_fn=intersect_fn,
                                 with_bounce_counts=True,
                                 n_real=stop - start - i * block_size,
                                 dup_fetch=dup_fetch)
        imgs.append(img)
        segs.append(s)
        counts.append(c)
    n = (y1 - y0) * cfg.width
    segs = torch.cat(segs)
    img = torch.cat(imgs)[:n].reshape(y1 - y0, cfg.width, 3)
    return (
        img,
        segs.sum(dtype=torch.int64),
        segs[:n].reshape(y1 - y0, cfg.width),
        torch.stack(counts).sum(0, dtype=torch.int32),
    )


def render_frames_plain(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frame0,
    n_frames: int = 1,
    accum: torch.Tensor | None = None,
    collect_stats: bool = False,
    rows: tuple[int, int] | None = None,
    groups: np.ndarray | None = None,
    intersect_fn=None,
    probe: str | None = None,
    phase_one: dict | None = None,
    pair_costs: torch.Tensor | None = None,
):
    """The plain PyTorch version of the kernel, on the scene's device.

    Renders frames ``frame0 .. frame0 + n_frames - 1``. Without ``accum``
    (then ``n_frames`` must be 1) the image is the frame's mean radiance;
    with it, each frame folds into the running average
    (``ops/accumulate.py``). Returns ``(image (H, W, 3) f32, total segments
    (int64 0-d), per-pixel segments (H, W) int32, per-bounce live counts
    (max_bounce + 1,) int32 or None)``. The histogram counts real pixels
    only, as the kernel's does, so it sums to the per-pixel map. With exact
    spp, like the JAX package's XLA path, the total also counts the padding
    lanes of the last pixel block. A block holds at most
    ``plain_block_size`` pixels, so where many triangles cut it, the
    padding and the total can be smaller than the XLA path's.

    With ``cfg.adaptive_spp`` it runs the refill over the TPU kernel's
    lanes, as the kernel groups them: ``refill_knobs``' pixels a lane and
    phases over the tiles of ``refill_tile_size`` (``tile_lanes``), a
    lane's pixels in ``pair_perm``'s order of ``pair_costs`` ((y1 - y0, W),
    the band's rows; read with more than one pixel a lane only, as the JAX
    package reads it), or, with one pixel a lane, over ``groups``, a (G, P)
    array of pixel indices with -1 for padding; in the kernel's two phases
    (``_refill_two_phase``, the TPU kernel's slot machine bit for bit). Its
    totals count real pixels only. ``phase_one``, a dict, gains the first
    phase's ``segs`` and ``slots`` ((y1 - y0, W) int32: each pixel's
    segments, and its slot, when its quota was done) and ``tile_max`` ((G,)
    int32: each group's vote, the largest of its lanes' slots at their
    quotas' end, in tile order, or the order of ``groups``' rows, within
    the band), and with more than one pixel a lane the lane pass's
    ``resume`` ((y1 - y0, W) int32, ``refill_lane_pass_plain``) and
    ``lane_list`` (``refill_lane_list``). With exact spp ``pair_costs`` is
    not read: it moves no sample of an exact-spp image.

    ``rows=(y0, y1)`` renders only rows ``y0 .. y1 - 1`` of the full frame,
    with the same pixels and random streams; ``accum``, the image and the
    per-pixel map then hold ``y1 - y0`` rows. With refill the band must be
    made of whole groups. This makes a full-width check of the kernel
    affordable at large sizes. ``intersect_fn`` is the closest-hit
    function (``ops/trace.trace_segment``); by default the one
    ``plain_intersector`` picks for ``cfg.intersector`` and ``camera``
    (the kernel's visit order). ``probe``, one of ``PROBE_SETTINGS``, sets
    that profiling knob: ``dup_intersect`` (``ops/trace.dup_intersect`` on
    the closest-hit function), ``dup_fetch`` (``ops/trace.fetch_again``)
    and ``no_cull`` (``plain_intersector(..., cull=False)``; it takes no
    ``intersect_fn``) give the image, maps and histogram without the knob;
    the stubs wrap the closest-hit function (``stub_intersector``) where
    ``probe_instantiation`` does not take the production kernel (and raise
    where it raises).
    """
    _check_frames(n_frames, accum)
    inst = probe_instantiation(scene, probe, cfg)
    if probe == "no_cull" and intersect_fn is not None:
        raise ValueError("no_cull takes the clustered scan without culls: "
                         "pass no intersect_fn")
    if intersect_fn is None:
        # the plain version's counterpart of the launch's scene_tables
        with annotate(WRAPPER_TABLES):
            intersect_fn = plain_intersector(scene, camera, cfg,
                                             cull=probe != "no_cull")
    if probe == "dup_intersect":
        intersect_fn = dup_intersect(intersect_fn)
    elif inst in ("stub_intersect", "stub_fetch"):
        intersect_fn = stub_intersector(intersect_fn, stub_row(scene, probe),
                                        inst == "stub_intersect",
                                        scene.device)
    dup_fetch = probe == "dup_fetch"
    y0, y1 = (0, cfg.height) if rows is None else rows
    if not 0 <= y0 < y1 <= cfg.height:
        raise ValueError(f"rows {rows} outside 0..{cfg.height}")
    if cfg.adaptive_spp:
        return _render_adaptive(scene, camera, cfg, frame0, n_frames, accum,
                                collect_stats, y0, y1, groups, intersect_fn,
                                dup_fetch, phase_one, pair_costs=pair_costs)
    total = 0
    segs_map = 0
    hist = 0
    for k in range(n_frames):
        frame = (int(frame0) + k) & 0xFFFFFFFF
        img, s, m, h = _render_frame_plain(scene, camera, cfg, frame, y0, y1,
                                           intersect_fn, dup_fetch)
        if accum is not None:
            img = accum = accumulate(accum, img, frame, clamp=cfg.clamp_accumulate)
        total = total + s
        segs_map = segs_map + m
        hist = hist + h
    return img, total, segs_map, (hist if collect_stats else None)


def warp_groups(width: int, height: int) -> np.ndarray:
    """The kernel's warps: (G, 32) pixel indices, one row per warp of its
    16x8 block (16 columns by 2 rows, row-major), -1 where the warp
    reaches past the image (``warp_schedule_counts``' tiles). Groups are
    ordered by pixel row pair, then by column, so a band of rows starting
    and ending on even rows is a run of whole groups."""
    gw, gh = BLOCK_X, WARP // BLOCK_X
    ys = np.arange(_round_up(height, gh)).reshape(-1, gh)  # (Ry, 2)
    xs = np.arange(_round_up(width, gw)).reshape(-1, gw)  # (Rx, 16)
    y = ys[:, None, :, None]
    x = xs[None, :, None, :]
    pix = np.where((y < height) & (x < width), y * width + x, -1)
    return pix.reshape(-1, WARP)


def queue_tiles(width: int, y0: int, y1: int) -> int:
    """The warp tiles of a band of rows ``y0 .. y1 - 1``, a warp's 16x2
    pixels of ``warp_groups``: what the ``"queue"`` schedule of
    ``schedule_counts`` hands to its resident warps."""
    return -(-width // BLOCK_X) * -(-(y1 - y0) // (WARP // BLOCK_X))


def band_resident_warps(launch_warps: int, cfg: RenderConfig,
                        rows: tuple[int, int]) -> int:
    """A band's share of a whole-frame launch's resident warps: as many
    warps as hold its tiles at the launch's tiles a warp (at least one),
    the queue's ``resident_warps`` for ``warp_schedule_counts`` on a
    band."""
    share = queue_tiles(cfg.width, *rows) / queue_tiles(cfg.width, 0,
                                                        cfg.height)
    return max(1, round(launch_warps * share))


def tile_groups(width: int, height: int, ts: int) -> np.ndarray:
    """The refill groups of the TPU kernel and of this one: (G, ts * ts)
    pixel indices, one row per ts x ts tile (tiles row-major, pixels
    row-major inside a tile: the kernel's tile index), -1 where a tile
    reaches past the image. (The TPU kernel re-renders a
    border pixel there; that duplicate's stream is its original's, so it
    never changes a tile's vote.)"""
    ys = np.arange(_round_up(height, ts)).reshape(-1, ts)
    xs = np.arange(_round_up(width, ts)).reshape(-1, ts)
    y = ys[:, None, :, None]
    x = xs[None, :, None, :]
    pix = np.where((y < height) & (x < width), y * width + x, -1)
    return pix.reshape(-1, ts * ts)


def pair_perm(costs: torch.Tensor, width: int, height: int, ts: int,
              ppl: int, y0: int, y1: int) -> torch.Tensor:
    """The TPU launcher's cost pairing (``kernels/megakernel.py:2596-2632``)
    for the tiles of rows ``y0 .. y1 - 1``: ``costs`` ((y1 - y0, width),
    e.g. a launch's per-pixel segment map) -> (G, ts * ts) int32 tile-local
    pixel indices, lane j's phase-p pixel at ``p * ts * ts // ppl + j``.
    Each tile's pixels sorted by falling cost (ties in tile order, the
    stable sort of ``jnp.argsort``), each odd phase's block reversed, so a
    lane's pixels pair heavy with light. A position past the frame takes its
    clamped pixel's cost, as the TPU kernel re-renders that pixel there."""
    if tuple(costs.shape) != (y1 - y0, width):
        raise ValueError(
            f"pair_costs must be ({y1 - y0}, {width}), the band's rows, got "
            f"{tuple(costs.shape)}")
    n_tx, n_ty = -(-width // ts), -(-(y1 - y0) // ts)
    dev = costs.device
    ys = torch.clamp(y0 + torch.arange(n_ty * ts, device=dev),
                     max=height - 1) - y0
    xs = torch.clamp(torch.arange(n_tx * ts, device=dev), max=width - 1)
    cost = (costs[ys][:, xs].reshape(n_ty, ts, n_tx, ts).permute(0, 2, 1, 3)
            .reshape(n_tx * n_ty, ts * ts).to(torch.float32))
    order = torch.argsort(-cost, dim=1, stable=True)
    npl = ts * ts // ppl
    blocks = [order[:, p * npl:(p + 1) * npl] for p in range(ppl)]
    return torch.cat([b if p % 2 == 0 else b.flip(1)
                      for p, b in enumerate(blocks)], dim=1).to(torch.int32)


def tile_lanes(width: int, height: int, ts: int, ppl: int, y0: int, y1: int,
               perm: torch.Tensor | None = None, device="cpu"):
    """The TPU kernel's lanes over the ts x ts tiles of rows ``y0 .. y1 - 1``
    (tiles row-major from ``y0``) -> ``(pix, inside)``, each (G, ts * ts //
    ppl, ppl): lane j's phase-p pixel, the frame's index ``y * width + x``,
    and whether that tile position lies in the band. Lane j's phase-p
    position is tile-local index ``p * ts * ts // ppl + j``
    (``megakernel.py:545-552``), or ``perm``'s entry there (``pair_perm``);
    a position past the frame's right or bottom edge traces the clamped
    border pixel (``inside`` False), whose output the launcher drops, but
    whose slots still count in its lane."""
    n_tx, n_ty = -(-width // ts), -(-(y1 - y0) // ts)
    g = n_tx * n_ty
    npl = ts * ts // ppl
    if perm is None:
        local = torch.arange(ts * ts, device=device).expand(g, -1)
    else:
        local = perm.to(device=device, dtype=torch.int64)
    local = local.reshape(g, ppl, npl).transpose(1, 2)
    t = torch.arange(g, device=device)[:, None, None]
    ux = (t % n_tx) * ts + local % ts
    uy = y0 + (t // n_tx) * ts + local // ts
    inside = (ux < width) & (uy < y1)
    pix = (torch.clamp(uy, max=height - 1) * width
           + torch.clamp(ux, max=width - 1))
    return pix, inside


def refill_lane_pass_plain(slots: torch.Tensor, pix: torch.Tensor,
                           inside: torch.Tensor, phases: int, offset: int):
    """The plain version of ``refill_lanes``: ``slots`` (n,), each pixel's
    slot after its exact-spp samples (phase 1: E), lanes ``pix`` / ``inside``
    ((G, L, ppl), ``tile_lanes``; -1 a padding lane) -> ``(resume (n,),
    tile_max (G,))``, both int32. A lane traces its pixels in turn and
    starts the next on the first slot its phase allows (with two phases
    the first even one), so its quota is done at its lanes' sum; its tile
    votes for extra samples until its largest lane's. ``resume`` is a
    lane's slot at that sum for its last pixel, where that pixel is in the
    band, and -1 for every other pixel: no extra samples. Frame index ``i``
    is ``slots[i - offset]``."""
    e = torch.where(pix >= 0, slots[torch.clamp(pix - offset, min=0)], 0).to(
        torch.int64)
    start = e + (e & 1) if phases == 2 else e
    lane = start[..., :-1].sum(-1) + e[..., -1]
    resume = torch.full_like(slots, -1, dtype=torch.int32)
    last = inside[..., -1]
    resume[pix[..., -1][last] - offset] = lane[last].to(torch.int32)
    return resume, lane.amax(dim=1).to(torch.int32)


def refill_lane_list(pix: torch.Tensor, inside: torch.Tensor, width: int,
                     ts: int, y0: int) -> torch.Tensor:
    """The plain version of the lane pass's list (the ``refill_lanes``
    kernel writes it; phase 2 of refill under the lane knobs runs over it)
    for lanes ``pix`` / ``inside``, ``tile_lanes``' over the tiles of side
    ``ts`` of a ``width``-wide band from row ``y0``: L = ts * ts // ppl
    int32 entries a tile, the frame indices of its lanes' last pixels in
    the band, in the order of their threads in a launch over the band
    (``lane_list_order``), then -1."""
    last, at = inside[..., -1], pix[..., -1]
    key = torch.where(last, lane_list_order(at, width, ts, y0), ts * ts)
    order = torch.argsort(key, dim=1)
    return torch.take_along_dim(torch.where(last, at, -1), order,
                                dim=1).reshape(-1).to(torch.int32)


def lane_list_order(pix: torch.Tensor, width: int, ts: int,
                    y0: int) -> torch.Tensor:
    """The place of frame pixels ``pix`` ((G, ...), row g in refill tile g
    of the band from row ``y0``, tiles of side ``ts`` row-major) among
    their tile's threads in a launch over the band: 16x8 blocks in grid
    order, 16x2 warps, x fastest (the kernel's ``thread_order``): block
    row, block column, then row and column in the block."""
    n_tx = -(-width // ts)
    g = torch.arange(pix.shape[0], device=pix.device).reshape(
        (-1,) + (1,) * (pix.dim() - 1))
    lx = pix % width - (g % n_tx) * ts
    ly = pix // width - y0 - (g // n_tx) * ts
    return (((ly // BLOCK_Y) * (ts // BLOCK_X) + lx // BLOCK_X)
            * (BLOCK_X * BLOCK_Y) + (ly % BLOCK_Y) * BLOCK_X + lx % BLOCK_X)


def refill_lanes(slots: torch.Tensor, width: int, height: int, ts: int,
                 ppl: int, phases: int, rows: tuple[int, int],
                 perm: torch.Tensor | None = None):
    """Each refill lane's slots and its tile's vote from phase 1's slot map
    ``slots`` ((y1 - y0, width) int32 of the band ``rows``) -> ``(resume
    (y1 - y0, width), tile_max (G,))``, both int32 (see
    ``refill_lane_pass_plain``); the lanes of ``tile_lanes(width, height,
    ts, ppl, *rows, perm)``. On a CUDA tensor the ``refill_lanes`` kernel
    (``PathTraceKernel.lane_pass``, whose lane list this drops), on the CPU
    its plain version."""
    y0, y1 = rows
    if slots.device.type == "cuda":
        n_tiles = -(-(y1 - y0) // ts) * -(-width // ts)
        resume = torch.empty_like(slots)
        tile_max = torch.empty(n_tiles, dtype=torch.int32,
                               device=slots.device)
        lane_list = torch.empty(n_tiles * (ts * ts // ppl),
                                dtype=torch.int32, device=slots.device)
        KERNEL.lane_pass(slots, resume, tile_max, lane_list, width, height,
                         ts, ppl, phases, rows, perm)
        return resume, tile_max
    if slots.device.type != "cpu":
        raise ValueError(f"no lane pass for device {slots.device}")
    pix, inside = tile_lanes(width, height, ts, ppl, y0, y1, perm)
    resume, tile_max = refill_lane_pass_plain(slots.reshape(-1), pix, inside,
                                              phases, y0 * width)
    return resume.reshape(slots.shape), tile_max


def refill_warp_counts(phase_one_segs: torch.Tensor, segs: torch.Tensor,
                       lane_list: torch.Tensor | None = None,
                       y0: int = 0) -> dict:
    """How full a refill launch keeps its warps, from its per-pixel segment
    maps ((y1 - y0, W) of the band from row ``y0``) after phase 1 (each
    pixel's exact-spp segments E) and after phase 2 (F): a warp of the
    kernel's 16 x 2 lanes runs phase 1 for as many slots as their largest
    E, and phase 2, each lane resuming at its own slot, for as many as
    their largest F - E (``"phase_2"``: a launch over the band); with a
    lane list (``refill_lanes``), phase 2's warps are its runs of 32
    entries, -1 an idle lane (``"phase_2_list"``). -> each one's
    warp-slots and the share of its lane-slots that traced a segment.
    Segments stand in for slots: under two phases a lane also waits a slot
    for its phase."""
    h, w = segs.shape
    extra = (segs - phase_one_segs).to(torch.int64)
    out = {}
    for name, per_lane in (("phase_1", phase_one_segs.to(torch.int64)),
                           ("phase_2", extra)):
        x = torch.nn.functional.pad(per_lane, (0, -w % BLOCK_X, 0, -h % 2))
        x = x.reshape(x.shape[0] // 2, 2, x.shape[1] // BLOCK_X, BLOCK_X)
        out[name] = x.permute(0, 2, 1, 3).reshape(-1, WARP)
    if lane_list is not None:
        at = lane_list.to(device=segs.device, dtype=torch.int64)
        got = extra.reshape(-1)[torch.clamp(at - y0 * w, min=0)]
        out["phase_2_list"] = torch.where(at >= 0, got, 0).reshape(-1, WARP)
    counts = {}
    for name, lanes in out.items():
        slots = int(lanes.amax(dim=1).sum())
        counts[name] = dict(warp_slots=slots, lane_segments=int(lanes.sum()),
                            live_share=int(lanes.sum()) / max(WARP * slots, 1))
    return counts


def phase_ms(events, n_frames: int) -> list:
    """A refill call's launches' ms a frame from the five CUDA events that
    ``phase_one`` gains (``PathTraceKernel.launch``): phase 1, the lane pass
    (about nothing with one pixel a lane) and phase 2."""
    e = events
    return [e[0].elapsed_time(e[1]) / n_frames,
            e[1].elapsed_time(e[4]) / n_frames,
            e[2].elapsed_time(e[3]) / n_frames]


def lane_pass_ms(scene, cfg, slots: torch.Tensor,
                 costs: torch.Tensor | None = None, reps: int = 50) -> float:
    """The ``refill_lanes`` kernel's device ms under ``cfg``'s lane knobs on
    phase 1's slot map ``slots`` ((H, W) int32 on the card, the whole
    frame), its lanes paired by ``costs`` where given: ``reps`` launches
    queued behind a spin of the card (about 25 ms), so that their events
    hold the card's time and not the host's."""
    ppl, phases = refill_knobs(scene, cfg)
    h, w = slots.shape
    ts = refill_tile_size(scene, cfg)
    n_tiles = -(-h // ts) * -(-w // ts)
    perm = (None if costs is None
            else pair_perm(costs, w, h, ts, ppl, 0, h).contiguous())
    outs = (torch.empty_like(slots),
            torch.empty(n_tiles, dtype=torch.int32, device=slots.device),
            torch.empty(n_tiles * (ts * ts // ppl), dtype=torch.int32,
                        device=slots.device))

    def call():
        KERNEL.lane_pass(slots, *outs, w, h, ts, ppl, phases, (0, h), perm)

    call()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        call()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def knob_tag(ppl: int, phases: int, paired: bool) -> str:
    """A lane-knob setting's name, as ``ppl2_ph1_paired``."""
    return f"ppl{ppl}_ph{phases}" + ("_paired" if paired else "")


def knob_digests(scene, cam, cfg, settings, seed: int = 0) -> dict:
    """Refill's outputs under each lane-knob setting (pixels a lane, phases,
    paired) of ``settings``: {``knob_tag``: {"frame3": the first 16 hex
    digits of the SHA-256 of frame 3's image, segment map and bounce
    histogram, "k4": of the K = 4 fold of frames 1-4 from an accumulator
    drawn from ``seed`` (image, segment map)}}, a paired setting's lanes
    paired by the default refill's frame-3 segment map; on ``scene``'s
    device."""
    def digest(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()[:16]

    dev = scene.device
    ad = dataclasses.replace(cfg, adaptive_spp=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    acc0 = 2.0 * torch.rand((cfg.height, cfg.width, 3), generator=gen,
                            device=dev)
    costs = render_frames_mega(scene, cam, ad, 3)[2]
    out = {}
    for ppl, phases, paired in settings:
        c = dataclasses.replace(ad, mega_pixels_per_lane=ppl,
                                mega_phases=phases)
        pc = costs if paired else None
        one = render_frames_mega(scene, cam, c, 3, collect_stats=True,
                                 pair_costs=pc)
        k4 = render_frames_mega(scene, cam, c, 1, 4, accum=acc0,
                                pair_costs=pc)
        out[knob_tag(ppl, phases, paired)] = dict(
            frame3=digest(one[0], one[2], one[3]), k4=digest(k4[0], k4[2]))
    return out


# Warp schedules of the exact kernel's work (``schedule_counts``): a loop
# over samples and bounces, the slot loop with one warp a tile (the
# kernel's), and the slot loop of resident warps that take warp tiles from a
# queue (measured on the card as a kernel and not kept: PERF.md).
SCHEDULES = ("nested", "slots", "queue")

# The slot loop of the kernel's 16x8 blocks, BLOCK_WARPS warps each, whose
# slot ends when the block's last live lane has traced its segment and whose
# sphere cluster visits test the block's rays that entered a cluster, WARP a
# warp step, the batches dealt round-robin to its warps (``schedule_counts``;
# measured on the card as the kSpheres kernels' cluster scan and not kept:
# PERF.md).
BLOCK_SCHEDULE = "block"
BLOCK_WARPS = BLOCK_X * BLOCK_Y // WARP


def _slot_iterations(key, packed, sizes, base) -> tuple[int, int]:
    """Records grouped into slots by ``key`` (R,) -> ``(slots, iterations)``:
    a slot runs ``base`` plus the ``sizes`` of the union of its records'
    members (``packed``, (R, bytes) uint8, each record's members as
    ``np.packbits`` of a (R, len(sizes)) bool array)."""
    order = np.argsort(key, kind="stable")
    k = key[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]]) if k.size else k
    iterations = starts.size * base
    if sizes.size and starts.size:
        union = np.bitwise_or.reduceat(packed[order], starts, axis=0)
        members = np.unpackbits(union, axis=1, count=sizes.size)
        iterations += int(members.sum(0, dtype=np.int64) @ sizes)
    return int(starts.size), int(iterations)


def chunk_scan_across_warp(sizes) -> bool:
    """Whether a scene whose chunks hold ``sizes`` triangles has a chunk
    that a visit of one lane takes across the warp (``CHUNK_SCAN_MAX``'s
    rule: 32 x runs < CHUNK_SCAN_MAX x size). Where none has, the kChunks
    kernels' lanes scan the chunks each on its own, without the votes (the
    source's ``Triangles::warp_scan``): Cornell, six chunks of two."""
    sizes = np.asarray(sizes, np.int64)
    return bool((WARP * -(-sizes // WARP) < CHUNK_SCAN_MAX * sizes).any())


def _cluster_visits(key, members, sizes, scan_max,
                    by_runs: bool = False) -> tuple[np.ndarray, int]:
    """Records grouped into slots by ``key`` (R,) -> ``(visit_lanes,
    ray_steps)``: a (slot, cluster) pair is a visit when ``members`` (R, K)
    bool has a record of the slot that tested the cluster (or chunk); its k
    lanes are those records. ``visit_lanes`` (WARP,) int64 counts the
    visits of k = 1 .. WARP lanes; ``ray_steps`` is what the cooperative
    scan runs for them: k ray steps a run of WARP of the cluster's
    ``sizes`` members a cooperative visit, the size in per-lane steps
    another. A visit is cooperative where k < ``scan_max`` (the kSpheres
    cluster loop, ``WARP_SCAN_MAX``) or, ``by_runs``, where k * WARP *
    runs < ``scan_max`` * size (the kChunks chunk loop,
    ``CHUNK_SCAN_MAX``)."""
    hist = np.zeros(WARP, np.int64)
    if not (sizes.size and key.size):
        return hist, 0
    order = np.argsort(key, kind="stable")
    k = key[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    # a slot holds at most one record a lane: at most WARP lanes a visit
    lanes = np.add.reduceat(members[order].view(np.uint8), starts, axis=0,
                            dtype=np.int64)
    hist += np.bincount(lanes[lanes > 0], minlength=WARP + 1)[1:]
    runs = -(-sizes[None, :] // WARP)
    coop = (lanes * WARP * runs < scan_max * sizes[None, :] if by_runs
            else lanes < scan_max)
    steps = np.where(coop, lanes * runs, sizes[None, :])
    return hist, int(steps[lanes > 0].sum())


def _block_visits(key, spheres, sizes, n_hoist) -> dict:
    """Records grouped into block slots by ``key`` (R,) -> the ``"block"``
    schedule's cluster visits: a (slot, cluster) pair whose slot has n
    records that tested the cluster (``spheres`` (R, K) bool, of ``sizes``
    (K,) spheres) runs ceil(n / WARP) batches of the cluster's size in
    per-lane sphere steps, batch b on warp b mod BLOCK_WARPS. A slot's
    busiest warp runs the hoisted spheres and, each visit, the most batches
    of a warp: the block waits for it at the visit's end."""
    hist = np.zeros(BLOCK_WARPS * WARP, np.int64)
    out = dict(block_visit_lanes=hist, block_sphere_steps=0,
               busiest_warp_steps=0)
    if not key.size:
        return out
    order = np.argsort(key, kind="stable")
    k = key[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    out["busiest_warp_steps"] = starts.size * n_hoist
    if not sizes.size:
        return out
    lanes = np.add.reduceat(spheres[order].view(np.uint8), starts, axis=0,
                            dtype=np.int64)
    hist += np.bincount(lanes[lanes > 0], minlength=hist.size + 1)[1:]
    batches = -(-lanes // WARP)
    out["block_sphere_steps"] = int((batches @ sizes).sum())
    out["busiest_warp_steps"] += int(
        (-(-batches // BLOCK_WARPS) @ sizes).sum())
    return out


def _queue_schedule(lengths: np.ndarray,
                    resident_warps: int) -> tuple[np.ndarray, np.ndarray]:
    """List scheduling of warp tiles onto resident warps, the pixel queue
    of ``schedule_counts``: ``lengths`` (T, WARP) each tile's pixels' live
    slots in lane order (0: no pixel). A warp starts with every lane wanting
    a pixel; in a slot its lanes that want one take the tile's next pixels
    in lane order, and where the tile runs out the warp takes the next tile
    of the queue (warps in a slot in warp order). A pixel taken in slot s
    keeps its lane through slot s + length - 1; the lane wants the next one
    in slot s + length. -> ``(warp, first)`` (T, WARP): each pixel's warp
    and first slot, -1 where there is no pixel."""
    n_tiles = lengths.shape[0]
    pixels = [np.flatnonzero(row) for row in lengths]
    warp = np.full(lengths.shape, -1, np.int64)
    first = np.full(lengths.shape, -1, np.int64)
    free = np.zeros((resident_warps, WARP), np.int64)  # a lane's next slot
    idle = np.iinfo(np.int64).max  # a lane the queue has no pixel for
    tile = [-1] * resident_warps
    cursor = [0] * resident_warps
    taken = 0  # tiles the queue handed out
    events = [(0, w) for w in range(resident_warps)]
    while events:
        t, w = heapq.heappop(events)
        for lane in np.flatnonzero(free[w] == t):
            while tile[w] < 0 or cursor[w] == pixels[tile[w]].size:
                if taken == n_tiles:
                    break
                tile[w], cursor[w] = taken, 0
                taken += 1
            g = tile[w]
            if g < 0 or cursor[w] == pixels[g].size:
                free[w, lane] = idle
                continue
            p = pixels[g][cursor[w]]
            cursor[w] += 1
            warp[g, p], first[g, p] = w, t
            free[w, lane] = t + lengths[g, p]
        busy = free[w][free[w] != idle]
        if busy.size:
            heapq.heappush(events, (int(busy.min()), w))
    return warp, first


def schedule_counts(lane, nested_slot, spheres, sphere_sizes, n_hoist,
                    triangles=None, triangle_sizes=None,
                    warp_scan_max: int = WARP_SCAN_MAX,
                    resident_warps: int | None = None,
                    chunk_scan_max: int = CHUNK_SCAN_MAX,
                    warp_blocks=None) -> dict:
    """How the exact kernel's warps spend their slots under three warp
    schedules and a block schedule, from the segments its lanes trace: one
    record a segment, each lane's records in the order it traces them. ``lane`` (R,) is the
    record's lane (its warp is ``lane // WARP``), ``nested_slot`` (R,) its
    slot in a loop over samples and bounces (``sample * (max_bounce + 1) +
    bounce``); ``spheres`` (R, K) bool the sphere clusters the segment
    tested, of ``sphere_sizes`` (K,) spheres each, beside the ``n_hoist``
    hoisted spheres every segment tests; ``triangles`` (R, C) bool and
    ``triangle_sizes`` (C,) the chunks and their triangles, or None.

    ``"nested"``, for each sample, for each bounce (the kernel's
    ``kLockstep``): a warp runs a sample's bounce while one of its lanes is
    on that path, so each (warp, ``nested_slot``) is a slot. ``"slots"``,
    the slot loop with one warp a tile of 32 lanes (the kernel's
    ``kExact``): a lane whose path ended starts its next sample in the next
    slot, so it traces its k-th segment in its warp's slot k, and each
    (warp, k) is a slot. ``"queue"``, the slot loop of ``resident_warps``
    warps that take the tiles from a queue (None: one warp a tile): a lane
    is a tile's pixel, ``lane // WARP`` its tile, and a lane whose pixel is
    done takes its warp's next pixel in the next slot
    (``_queue_schedule``), so a pixel taken in its warp's slot s traces its
    k-th segment in slot s + k. The queue's ``makespan`` is its last warp's
    slots, ``ideal_slots`` the segments over ``WARP * resident_warps``. For
    each schedule: ``slots``, ``lanes_per_slot`` (live lanes a slot),
    ``lane_segments`` (R_lanes,) (each lane's live slots, by lane id), and
    ``sphere_iterations`` / ``triangle_iterations``: what a warp's scan
    runs a slot, the hoisted spheres and the union of its live lanes'
    tested clusters' spheres (chunks' triangles), summed over slots.
    The kSpheres kernels' warp-cooperative cluster scan: ``visit_lanes``
    (WARP,) int64, the (slot, cluster) visits with k = 1 .. WARP live
    lanes that passed the cluster's gate, and ``sphere_ray_steps``, the
    steps its cluster loop runs for them (k a visit under
    ``warp_scan_max`` lanes, the cluster's size at or above; the hoisted
    spheres are ``n_hoist`` steps a slot in either scan, as in
    ``sphere_iterations``), against ``cluster_sphere_steps``, the per-lane
    cluster loop's (``sphere_iterations`` less the hoisted). With
    triangles, the kChunks kernels' cooperative chunk scan the same way:
    ``chunk_visit_lanes``, and ``triangle_ray_steps`` (k ray steps a run of
    32 triangles a visit under ``chunk_scan_max``'s rule, the chunk's size
    at or above it) against ``chunk_triangle_steps``, the per-lane loop's
    (a visit's chunk size each: ``triangle_iterations``). Beside them
    ``segments`` and the lanes' own tests summed (``lane_sphere_tests``,
    ``lane_triangle_tests``).

    ``"block"`` (``BLOCK_SCHEDULE``), the slot loop of blocks of
    ``BLOCK_WARPS`` warps (``warp_blocks`` (W,), each warp's block; None:
    ``BLOCK_WARPS`` consecutive warps a block): a lane traces its k-th
    segment in its block's slot k, and a (block, k) slot runs until the
    block's last live lane has traced. Its sphere clusters are tested on
    the block's rays that entered them (``_block_visits``): ``slots``,
    ``lanes_per_slot``, ``lane_segments``, ``block_visit_lanes``
    (BLOCK_WARPS * WARP,) the visits of n = 1 .. 128 lanes,
    ``block_sphere_steps`` their batches' per-lane sphere steps summed over
    the warps (``cluster_sphere_steps`` too), ``busiest_warp_steps`` the
    slots' busiest warps' steps, the hoisted spheres included, and
    ``busiest_warp_steps_per_slot``; ``hoisted_sphere_steps``, the hoisted
    spheres on each warp with a live lane a slot, and beside them
    ``sphere_iterations``. Spheres only: the chunk scan is the warps'."""
    lane = np.asarray(lane, np.int64)
    nested_slot = np.asarray(nested_slot, np.int64)
    sphere_sizes = np.asarray(sphere_sizes, np.int64)
    spheres = np.asarray(spheres, bool)
    n = lane.size
    n_lanes = int(lane.max(initial=-1)) + 1
    # k: how many of its lane's records come before a record
    order = np.argsort(lane, kind="stable")
    starts = np.searchsorted(lane[order], lane[order], side="left")
    k = np.empty(n, np.int64)
    k[order] = np.arange(n) - starts
    warp = lane // WARP
    per_lane = np.zeros(n_lanes, np.int64)
    np.maximum.at(per_lane, lane, k + 1)
    n_tiles = -(-n_lanes // WARP)
    warps = n_tiles if resident_warps is None else resident_warps
    if warps < 1:
        raise ValueError(f"resident_warps must be >= 1, got {warps}")
    q_warp, q_first = _queue_schedule(
        np.pad(per_lane, (0, n_tiles * WARP - n_lanes)).reshape(-1, WARP),
        warps)
    q_warp, q_first = q_warp.reshape(-1), q_first.reshape(-1)
    q_slot = q_first[lane] + k
    makespan = int(q_slot.max(initial=-1)) + 1
    slot_of = {
        "nested": warp * (int(nested_slot.max(initial=0)) + 1) + nested_slot,
        "slots": warp * (int(k.max(initial=0)) + 1) + k,
        "queue": q_warp[lane] * max(makespan, 1) + q_slot,
    }
    lane_segments = {
        "nested": np.bincount(lane, minlength=n_lanes),
        "slots": per_lane,
        "queue": per_lane,
    }
    parts = [("sphere", np.packbits(spheres, axis=1), sphere_sizes, n_hoist)]
    out = {"segments": n,
           "lane_sphere_tests": n * n_hoist + int(
               spheres.sum(0, dtype=np.int64) @ sphere_sizes)}
    if triangles is not None:
        triangles = np.asarray(triangles, bool)
        triangle_sizes = np.asarray(triangle_sizes, np.int64)
        parts.append(("triangle", np.packbits(triangles, axis=1),
                      triangle_sizes, 0))
        out["lane_triangle_tests"] = int(
            triangles.sum(0, dtype=np.int64) @ triangle_sizes)
    for name, key in slot_of.items():
        res = {"lane_segments": lane_segments[name]}
        for part, packed, sizes, base in parts:
            res["slots"], res[f"{part}_iterations"] = _slot_iterations(
                key, packed, sizes, base)
        hist, res["sphere_ray_steps"] = _cluster_visits(
            key, spheres, sphere_sizes, warp_scan_max)
        res["visit_lanes"] = hist.tolist()
        if triangles is not None:
            hist, res["triangle_ray_steps"] = _cluster_visits(
                key, triangles, triangle_sizes, chunk_scan_max, by_runs=True)
            res["chunk_visit_lanes"] = hist.tolist()
            res["chunk_triangle_steps"] = res["triangle_iterations"]
        res["cluster_sphere_steps"] = (res["sphere_iterations"]
                                       - res["slots"] * n_hoist)
        res["lanes_per_slot"] = n / max(res["slots"], 1)
        out[name] = res
    out["queue"].update(resident_warps=warps, makespan=makespan,
                        ideal_slots=n / (WARP * warps))
    if warp_blocks is None:
        warp_blocks = np.arange(n_tiles) // BLOCK_WARPS
    warp_blocks = np.asarray(warp_blocks, np.int64)
    if warp_blocks.ndim != 1 or warp_blocks.size < n_tiles:
        raise ValueError(f"warp_blocks must hold a block for each of the "
                         f"{n_tiles} warps, got shape {warp_blocks.shape}")
    key = warp_blocks[warp] * (int(k.max(initial=0)) + 1) + k
    block = _block_visits(key, spheres, sphere_sizes, n_hoist)
    hoisted = out["slots"]["slots"] * n_hoist
    block.update(
        slots=int(np.unique(key).size), lane_segments=per_lane,
        cluster_sphere_steps=block["block_sphere_steps"],
        hoisted_sphere_steps=hoisted,
        sphere_iterations=hoisted + block["block_sphere_steps"],
        block_visit_lanes=block["block_visit_lanes"].tolist())
    block["lanes_per_slot"] = n / max(block["slots"], 1)
    block["busiest_warp_steps_per_slot"] = (
        block["busiest_warp_steps"] / max(block["slots"], 1))
    out[BLOCK_SCHEDULE] = block
    return out


def warp_schedule_counts(scene: Scene, camera: Camera, cfg: RenderConfig,
                         rows: tuple[int, int] | None = None,
                         frame: int = 0, n_frames: int = 1,
                         resident_warps: int | None = None) -> dict:
    """The exact kernel's warp schedules counted on the plain version: the
    ``n_frames`` frames from ``frame`` (one launch's) of rows ``rows``
    (whole warp rows, even bounds; the whole frame for None) traced as
    ``render_frames_plain`` traces them, each segment's tested clusters and
    chunks recorded (``clustered_winner``'s ``visits``), then
    ``schedule_counts`` over the kernel's warp tiles (``warp_groups``), the
    queue's on ``resident_warps`` warps (None: one a tile). Returns its
    dict with each schedule's ``lane_segments`` as a ``segment_map`` ((y1 -
    y0, W) int32, the live slots of each pixel over the frames), ``warps``
    (the tiles), and ``ratios``: the slot loop's slots and iterations over
    the nested loop's, ``queue_ratios``: the queue's over the slot loop's,
    and ``block_ratios``: the block schedule's sphere steps over the slot
    loop's cluster scan steps (``sphere_ray_steps``) and per-lane loop
    steps (``cluster_sphere_steps``), its busiest warps' steps over the slot
    loop's ``sphere_iterations`` (None where the divisor is 0). The block
    schedule runs on the launch's 16x8 blocks from the band's first row.
    The sphere geometry and the chunk scan only: a BVH lane's walk is its
    own."""
    y0, y1 = (0, cfg.height) if rows is None else rows
    if not 0 <= y0 < y1 <= cfg.height:
        raise ValueError(f"rows {rows} outside 0..{cfg.height}")
    geom = geometry(scene, cfg)
    if geom == "bvh" or plain_through_sphere_bvh(scene, cfg):
        raise ValueError("warp_schedule_counts counts the clustered scans only")
    tables = visit_tables(scene, geom, camera)
    w, mb = cfg.width, cfg.max_bounce
    groups = _band_groups(warp_groups(w, cfg.height), w, y0, y1)
    lanes = groups.reshape(-1)
    real = np.flatnonzero(lanes >= 0)
    block = plain_block_size(cfg, scene, real.size)
    rec = collections.defaultdict(list)
    visits = []
    fn = functools.partial(closest_hit_clustered, tables=tables, visits=visits)
    for i in range(0, real.size, block):
        ids = real[i:i + block]
        pix = torch.from_numpy(lanes[ids]).to(scene.device)
        fp = focus_points(camera, pix % w, pix // w, w, cfg.height)
        for f in range(n_frames):
            state = rng_ops.seed(pix, frame + f)
            for sample in range(f * cfg.spp, (f + 1) * cfg.spp):
                state, o, d = generate_rays(state, camera, fp, w)
                state = trace(state, o, d, scene, mb, intersect_fn=fn,
                              fast_scatter=cfg.fast_scatter)[0]
                for bounce, (live, sph, tri) in enumerate(visits):
                    live = live.cpu().numpy()
                    rec["lane"].append(ids[live])
                    rec["slot"].append(np.full(int(live.sum()),
                                               sample * (mb + 1) + bounce))
                    rec["spheres"].append(sph.cpu().numpy()[live])
                    if tri is not None:
                        rec["triangles"].append(tri.cpu().numpy()[live])
                visits.clear()
    cat = {k: np.concatenate(v) for k, v in rec.items()}
    sizes = _int_column(tables.clusters, 7).cpu().numpy()
    tri_sizes = None
    if geom == "chunks":
        tri_sizes = _int_column(tables.chunks, 7).cpu().numpy()
    # a band's groups by row pair, then column: the launch's blocks start on
    # the band's first row, BLOCK_WARPS row pairs a block row
    row_pair, column = np.divmod(np.arange(groups.shape[0]), -(-w // BLOCK_X))
    warp_blocks = row_pair // BLOCK_WARPS * -(-w // BLOCK_X) + column
    out = schedule_counts(cat["lane"], cat["slot"], cat["spheres"], sizes,
                          tables.n_hoist, cat.get("triangles"), tri_sizes,
                          resident_warps=resident_warps,
                          warp_blocks=warp_blocks)
    for name in (*SCHEDULES, BLOCK_SCHEDULE):
        seg_map = np.zeros((y1 - y0) * w, np.int32)
        seg_map[lanes[real] - y0 * w] = out[name].pop("lane_segments")[real]
        out[name]["segment_map"] = seg_map.reshape(y1 - y0, w)
    out["warps"] = int(groups.shape[0])

    def ratios(a, b):
        return {key: out[a][key] / out[b][key] if out[b][key] else None
                for key in ("slots", "sphere_iterations",
                            "triangle_iterations", "sphere_ray_steps",
                            "triangle_ray_steps")
                if key in out[b]}

    out["ratios"] = ratios("slots", "nested")
    out["queue_ratios"] = ratios("queue", "slots")
    blk, slots = out[BLOCK_SCHEDULE], out["slots"]

    def over(a, b):
        return a / b if b else None

    out["block_ratios"] = dict(
        sphere_steps_over_ray_steps=over(blk["block_sphere_steps"],
                                         slots["sphere_ray_steps"]),
        sphere_steps_over_cluster_sphere_steps=over(
            blk["block_sphere_steps"], slots["cluster_sphere_steps"]),
        busiest_warp_steps_over_sphere_iterations=over(
            blk["busiest_warp_steps"], slots["sphere_iterations"]))
    return out


def _band_groups(groups: np.ndarray, width: int, y0: int, y1: int):
    """The groups whose pixels lie in rows ``y0 .. y1 - 1``; raises if a
    group has pixels on both sides of the band's edges."""
    groups = np.asarray(groups, np.int64)
    valid = groups >= 0
    inside = valid & (groups >= y0 * width) & (groups < y1 * width)
    keep = inside.any(axis=1)
    if (inside != valid)[keep].any():
        raise ValueError(
            f"rows ({y0}, {y1}) cut through a refill group: a band must "
            "hold whole groups"
        )
    return groups[keep]


def _render_adaptive(scene, camera, cfg, frame0, n_frames, accum,
                     collect_stats, y0, y1, groups, intersect_fn, dup_fetch,
                     phase_one=None, two_phase=True, pair_costs=None):
    """Adaptive sample refill, the TPU kernel's slot loop
    (``megakernel.py:1802-2150``) vectorised over lanes.

    A lane traces its pixels one after another, ``ppl`` of them
    (``refill_knobs``; one by default). Each slot, a dead lane that still
    owes samples, or whose group has a lane that does, starts its next
    camera sample (a pixel's first sample of a frame from the seed ``pix +
    frame * 719393``), then every live lane traces one segment; with two
    phases a lane starts a sample on even slots only and traces a bounce on
    odd ones, and waits between. A lane's quota is ``n_frames * spp`` a
    pixel: it folds a frame's mean into ``accum`` and moves to the next
    frame after ``spp`` completed samples, and to its next pixel after the
    last frame's, so all extra samples continue the last frame of its last
    pixel, whose mean divides by the samples it completed. The slot bound
    is ``ppl * quota * (max_bounce + 1) * phases``; a sample still in
    flight at the bound is dropped. Segments and the histogram count every
    segment traced for a pixel of the band.

    The lanes are the TPU kernel's over its tiles (``tile_lanes``; with
    ``pair_costs``, a (y1 - y0, W) map, and more than one pixel a lane in
    ``pair_perm``'s order), or, with ``groups`` ((G, P) pixel indices, -1
    for padding), one lane a pixel of each group (one pixel a lane only).

    By default in the kernel's two phases (``_refill_two_phase``); with
    ``two_phase=False`` as the slot machine itself over blocks of whole
    groups (``_adaptive_block``), the reference a CPU test holds the two
    phases to, bit for bit."""
    dev = scene.device
    w = cfg.width
    ppl, phases = refill_knobs(scene, cfg)
    if groups is not None:
        if ppl > 1:
            raise ValueError(
                f"groups take one pixel a lane; mega_pixels_per_lane is {ppl}")
        band = torch.from_numpy(_band_groups(groups, w, y0, y1)).to(dev)
        lanes, inside = band[:, :, None], band[:, :, None] >= 0
        ts = None
    else:
        ts = refill_tile_size(scene, cfg)
        if y0 % ts or (y1 != cfg.height and y1 % ts):
            raise ValueError(
                f"rows ({y0}, {y1}) cut through a refill group: a band must "
                f"hold whole groups (tiles of {ts})")
        perm = None
        if pair_costs is not None and ppl > 1:
            perm = pair_perm(pair_costs.to(dev), w, cfg.height, ts, ppl, y0,
                             y1)
        lanes, inside = tile_lanes(w, cfg.height, ts, ppl, y0, y1, perm, dev)
    n_band = (y1 - y0) * w
    hist = torch.zeros(cfg.max_bounce + 1, dtype=torch.int32, device=dev)
    acc = None if accum is None else accum.reshape(n_band, 3)
    if two_phase:
        img, seg_map = _refill_two_phase(
            scene, camera, cfg, int(frame0), n_frames, lanes, inside, phases,
            y0, y1, acc, hist, intersect_fn, dup_fetch, phase_one, ts)
    else:
        img = torch.zeros((n_band, 3), dtype=torch.float32, device=dev)
        seg_map = torch.zeros(n_band, dtype=torch.int32, device=dev)
        block = plain_block_size(cfg, scene, lanes.numel())
        per_block = max(1, block // lanes.shape[1])
        for g0 in range(0, lanes.shape[0], per_block):
            _adaptive_block(scene, camera, cfg, int(frame0), n_frames,
                            lanes[g0:g0 + per_block],
                            inside[g0:g0 + per_block], phases, y0 * w, acc,
                            img, seg_map, hist, intersect_fn, dup_fetch,
                            block)
    return (
        img.reshape(y1 - y0, w, 3),
        seg_map.sum(dtype=torch.int64),
        seg_map.reshape(y1 - y0, w),
        hist if collect_stats else None,
    )


def _lane_state(n: int, dev, acc) -> dict:
    """The refill slot loop's per-lane state for ``n`` lanes: the RNG
    ``state``, the last frame's banked light ``total``, the running
    average ``acc`` (None without an accumulator), samples completed
    ``ns``, frame ``fk``, segments traced ``segs``, and the sample in
    flight: ``o``, ``d``, ``colour``, ``incoming``, bounce ``bc``,
    ``live``."""
    def f3():
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def i64():
        return torch.zeros(n, dtype=torch.int64, device=dev)

    return dict(state=i64(), total=f3(), acc=acc, ns=i64(), fk=i64(),
                segs=i64(), o=f3(), d=f3(), colour=f3(), incoming=f3(),
                bc=i64(), live=torch.zeros(n, dtype=torch.bool, device=dev))


def _slot(scene, camera, cfg, frame0, n_frames, pix, fp, need, s, hist,
          intersect_fn, dup_fetch, block, trace=None, counted=None) -> None:
    """One slot of the refill slot loop over lanes ``pix`` (focus points
    ``fp``), their state ``s`` (``_lane_state``) written in place: the
    lanes ``need`` start their next camera sample (a lane whose frame is
    done folds it into ``acc`` and moves to the next; a frame's first
    sample is seeded ``pix + frame * 719393``), then the lanes ``trace``
    (every live lane by default) trace one segment, counted in ``segs`` and,
    where ``counted`` (every lane by default), in ``hist``, at most
    ``block`` lanes a call of the closest hit (``plain_block_size``: its
    temporaries stay bounded however many lanes the loop holds; a lane's
    segment does not depend on the lanes traced beside it)."""
    spp, mb = cfg.spp, cfg.max_bounce
    ni = need.nonzero().squeeze(1)
    if ni.numel():
        ns_i, fk_i = s["ns"][ni], s["fk"][ni]
        if n_frames > 1:
            # a lane whose frame is done folds it and moves on
            fdone = (ns_i - fk_i * spp >= spp) & (fk_i < n_frames - 1)
            fi = ni[fdone]
            for k in s["fk"][fi].unique().tolist():
                fik = fi[s["fk"][fi] == k]
                s["acc"][fik] = accumulate(
                    s["acc"][fik], vm.div(s["total"][fik], float(spp)),
                    (frame0 + k) & 0xFFFFFFFF, clamp=cfg.clamp_accumulate)
            s["total"][fi] = 0.0
            s["fk"][fi] += 1
            fk_i = s["fk"][ni]
        fresh = ns_i - fk_i * spp == 0
        st = torch.where(fresh, rng_ops.seed(pix[ni], frame0 + fk_i),
                         s["state"][ni])
        st, s["o"][ni], s["d"][ni] = generate_rays(st, camera, fp[ni],
                                                   cfg.width)
        s["state"][ni] = st
        s["colour"][ni] = 1.0
        s["bc"][ni] = 0
        s["live"][ni] = True

    live = (s["live"] if trace is None else trace).nonzero().squeeze(1)
    s["segs"][live] += 1
    hist_lanes = live if counted is None else live[counted[live]]
    hist += torch.bincount(s["bc"][hist_lanes], minlength=mb + 1).to(
        torch.int32)
    for c0 in range(0, live.numel(), block):
        pi = live[c0:c0 + block]
        bc_i = s["bc"][pi]
        st, o_i, d_i, inc_i, col_i, cont = trace_segment(
            s["state"][pi], s["o"][pi], s["d"][pi], s["incoming"][pi],
            s["colour"][pi], torch.ones_like(bc_i, dtype=torch.bool), bc_i,
            scene, intersect_fn=intersect_fn, fast_scatter=cfg.fast_scatter,
            dup_fetch=dup_fetch,
        )
        cont = cont & (bc_i < mb)
        died = ~cont
        s["state"][pi], s["o"][pi], s["d"][pi] = st, o_i, d_i
        s["colour"][pi] = col_i
        s["total"][pi[died]] += inc_i[died]
        s["ns"][pi[died]] += 1
        s["incoming"][pi] = torch.where(died[:, None], 0.0, inc_i)
        s["live"][pi] = cont
        s["bc"][pi] += 1


def _last_fold(cfg, frame0, n_frames, total, ns, acc) -> torch.Tensor:
    """The last frame's mean (light ``total`` over the samples it
    completed, >= spp, of ``ns`` in all), folded into ``acc`` where there
    is one."""
    last = torch.clamp(ns - (n_frames - 1) * cfg.spp, min=1).to(torch.float32)
    mean = total / last[:, None]
    if acc is not None:
        mean = accumulate(acc, mean, (frame0 + n_frames - 1) & 0xFFFFFFFF,
                          clamp=cfg.clamp_accumulate)
    return mean


def _adaptive_block(scene, camera, cfg, frame0, n_frames, lanes, inside,
                    phases, offset, acc_in, img, seg_map, hist, intersect_fn,
                    dup_fetch, block):
    """The slot machine over one block of groups (``lanes`` / ``inside``,
    (Gb, L, ppl) as ``tile_lanes`` gives them; -1 a padding lane), slot by
    slot as the TPU kernel runs it: a group's vote, a lane's pixel switch
    (``megakernel.py:1857-1885``), with two phases the even and odd slots.
    Writes its pixels of ``img``, ``seg_map`` and ``hist`` (band-local
    pixel index = global index - ``offset``); ``block`` as ``_slot`` takes
    it."""
    spp, mb, w = cfg.spp, cfg.max_bounce, cfg.width
    quota = n_frames * spp
    n_groups, per_group, ppl = lanes.shape
    n = n_groups * per_group
    dev = lanes.device
    valid = lanes[:, :, 0].reshape(n) >= 0
    pix = torch.where(lanes >= 0, lanes, offset).reshape(n, ppl)
    keep = inside.reshape(n, ppl)
    local = pix - offset
    fps = focus_points(camera, pix % w, pix // w, w, cfg.height)
    lane = torch.arange(n, device=dev)
    ph = torch.zeros(n, dtype=torch.int64, device=dev)
    s = _lane_state(n, dev, None if acc_in is None else acc_in[local[:, 0]])

    def bank(lanes_of):
        """The lanes' current pixels, done: their images and segments."""
        i = lanes_of.nonzero().squeeze(1)
        at, k = local[i, ph[i]], keep[i, ph[i]]
        mean = _last_fold(cfg, frame0, n_frames, s["total"][i], s["ns"][i],
                          None if s["acc"] is None else s["acc"][i])
        img[at[k]] = mean[k]
        seg_map[at[k]] = s["segs"][i][k].to(torch.int32)
        return i

    for slot in range(ppl * quota * (mb + 1) * phases):
        live0 = s["live"].clone()
        undone = valid & ((s["ns"] < quota) | (ph < ppl - 1))
        if not bool((live0 | undone).any()):
            break
        group = undone.reshape(n_groups, per_group).any(dim=1)
        primary = phases == 1 or slot % 2 == 0
        need = (valid & ~live0 & group.repeat_interleave(per_group)
                & primary)
        switch = need & (s["ns"] >= quota) & (ph < ppl - 1)
        if bool(switch.any()):
            i = bank(switch)
            for key in ("total", "ns", "fk", "segs"):
                s[key][i] = 0
            ph[i] += 1
            if s["acc"] is not None:
                s["acc"][i] = acc_in[local[i, ph[i]]]
        trace = need | (live0 if phases == 1 or not primary else False)
        _slot(scene, camera, cfg, frame0, n_frames, pix[lane, ph],
              fps[lane, ph], need, s, hist, intersect_fn, dup_fetch, block,
              trace=trace, counted=keep[lane, ph])
    bank(valid)


def _refill_two_phase(scene, camera, cfg, frame0, n_frames, lanes, inside,
                      phases, y0, y1, acc_in, hist, intersect_fn, dup_fetch,
                      phase_one, ts=None):
    """Adaptive refill as the kernel runs it, in two passes over the pixels
    of rows ``y0 .. y1 - 1`` and the lane pass between them, for the lanes
    ``lanes`` / ``inside`` (``_render_adaptive``; ``tile_lanes``' over tiles
    of side ``ts``, or None for other groups) -> ``(image (n, 3), segments
    (n,) int32)`` of the band's n pixels; adds to ``hist``.

    Under the slot machine a lane that owes samples starts one at the first
    slot its phase allows after its path ends, so until its quota is done
    its pixels run as under exact spp, whatever its group does: a pixel's
    quota is done at its slot E, its segment count with one phase (a lane
    is live every slot), with two the sum of each path's slots from an even
    slot to its last segment's odd one. A lane starts its next pixel at
    the first slot its phase allows after E, so it is done at the sum over
    its pixels, and its group's vote is true at slot s iff s < T_g, the
    group's largest such sum (``refill_lane_pass_plain``). So afterwards a
    dead lane starts an extra sample iff its slot is below T_g (and even,
    with two phases), whatever else its neighbours do. Phase 1 runs each
    pixel's exact slot loop without the last frame's fold, each pixel's
    slot kept; the lane pass takes each lane's sum and T_g; phase 2 runs
    each lane's last pixel from the lane's sum on, a dead lane re-seeding
    while its slot is below T_g, a sample still in flight at the slot bound
    dropped; then the last fold (the kernel's phase 2 with more than one
    pixel a lane runs over the lane pass's list of those last pixels alone,
    ``refill_lane_list``: the others take no extra sample, and phase 1
    folds them). Each pixel keeps a slot counter, which a
    lane waiting for its phase's slot moves on without a trace. Each phase's
    loop holds every pixel of the band, and its live lanes trace in calls
    of ``plain_block_size`` (``_slot``), so a phase runs as many
    iterations as its slowest lane traces segments, once. ``phase_one`` as
    ``render_frames_plain`` takes it."""
    dev = scene.device
    w = cfg.width
    quota = n_frames * cfg.spp
    n_slots = lanes.shape[-1] * quota * (cfg.max_bounce + 1) * phases
    off, n = y0 * w, (y1 - y0) * w
    pix = torch.arange(off, off + n, device=dev)
    fp = focus_points(camera, pix % w, pix // w, w, cfg.height)
    s = _lane_state(n, dev, None if acc_in is None else acc_in.clone())
    slot = torch.zeros(n, dtype=torch.int64, device=dev)
    limit = torch.zeros(n, dtype=torch.int64, device=dev)
    block = plain_block_size(cfg, scene, n)
    for phase in (1, 2):
        if phase == 2:
            resume, tile_max = refill_lane_pass_plain(slot, lanes, inside,
                                                      phases, off)
            if phase_one is not None:
                phase_one["segs"] = s["segs"].to(torch.int32).reshape(
                    y1 - y0, w)
                phase_one["slots"] = slot.to(torch.int32).reshape(y1 - y0, w)
                phase_one["tile_max"] = tile_max
                if lanes.shape[-1] > 1:
                    phase_one["resume"] = resume.reshape(y1 - y0, w)
                    phase_one["lane_list"] = refill_lane_list(
                        lanes, inside, w, ts, y0)
            group = torch.zeros(n, dtype=torch.int64, device=dev)
            group[lanes[inside] - off] = torch.arange(
                lanes.shape[0], device=dev)[:, None, None].expand(
                    lanes.shape)[inside]
            go = resume >= 0
            slot = torch.where(go, resume.to(torch.int64), slot)
            limit = torch.where(go, tile_max.to(torch.int64)[group], 0)
        while True:
            if phases == 2:
                # a live lane traces on odd slots, a dead one that owes or
                # may refill starts on even ones: it waits a slot for it
                owes = (s["ns"] < quota) | (slot + 1 < limit)
                slot += torch.where(s["live"], slot % 2 == 0,
                                    (slot % 2 == 1) & owes).long()
            s["live"] &= slot < n_slots
            need = ~s["live"] & ((s["ns"] < quota) | (slot < limit))
            if phases == 2:
                need &= slot % 2 == 0
            traced = s["live"] | need
            if not bool(traced.any()):
                break
            _slot(scene, camera, cfg, frame0, n_frames, pix, fp, need, s,
                  hist, intersect_fn, dup_fetch, block)
            slot += traced.long()
    return (_last_fold(cfg, frame0, n_frames, s["total"], s["ns"], s["acc"]),
            s["segs"].to(torch.int32))


def band_rows(scene: Scene, cfg: RenderConfig,
              rows: tuple[int, int] | None) -> tuple[int, int]:
    """The rows ``(y0, y1)`` of a launch over ``rows`` (the whole frame for
    None); raises unless ``0 <= y0 < y1 <= height`` and, with refill, the
    band holds whole refill tiles (``y0``, and ``y1`` unless it is the
    frame's height, multiples of ``refill_tile_size``): then its tiles are
    the whole-frame launch's and the band's image is that launch's rows
    bit for bit. Exact spp takes any band."""
    y0, y1 = (0, cfg.height) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= y0 < y1 <= cfg.height:
        raise ValueError(f"rows {rows} outside 0..{cfg.height}")
    if cfg.adaptive_spp:
        ts = refill_tile_size(scene, cfg)
        if y0 % ts or (y1 != cfg.height and y1 % ts):
            raise ValueError(
                f"rows {rows}: with adaptive_spp a band starts and ends on "
                f"a row of the refill tiles ({ts}x{ts}: multiples of {ts}, "
                "or the frame's height), so that it holds whole tiles, "
                "which are the whole frame's"
            )
    return y0, y1


def _check_frames(n_frames: int, accum) -> None:
    if n_frames < 1:
        raise ValueError(f"n_frames must be >= 1, got {n_frames}")
    if n_frames > 1 and accum is None:
        raise ValueError("n_frames > 1 requires an accumulator image")


def _check_probe(probe) -> None:
    if probe is not None and probe not in PROBE_SETTINGS:
        raise ValueError(
            f"probe must be None or one of {PROBE_SETTINGS}, got {probe!r}")


# --------------------------------- kernel -----------------------------------


_VP, _CI = ctypes.c_void_p, ctypes.c_int
# rtx_render's arguments; rtx_render_probe takes a Probe value before them
_RENDER_ARGTYPES = [
    _CI, _CI, _VP, _VP, _VP, _CI, _VP, _CI, _CI, _VP, _CI, _VP, _VP, _VP, _VP,
    _CI, _VP, _CI,
    _CI, _VP, _VP, _CI, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _CI, ctypes.c_uint,
    _CI, _VP, _CI, _CI, _CI, _CI, _VP, _VP, _CI, _VP, _CI, _CI, _VP, _VP, _CI,
    _VP, _VP, _VP, _VP,
]


def _bind(lib) -> None:
    lib.rtx_render.argtypes = _RENDER_ARGTYPES
    lib.rtx_render.restype = _CI
    lib.rtx_shared_bytes.argtypes = [_CI] * 7
    lib.rtx_shared_bytes.restype = ctypes.c_size_t
    lib.rtx_occupancy.argtypes = [_CI, _CI, _CI, _CI, _CI, ctypes.c_size_t]
    lib.rtx_occupancy.restype = _CI
    lib.rtx_refill_lanes.argtypes = [_VP] * 5 + [_CI] * 7 + [_VP]
    lib.rtx_refill_lanes.restype = _CI


def _bind_probes(lib) -> None:
    lib.rtx_render_probe.argtypes = [_CI, _VP, _CI] + _RENDER_ARGTYPES
    lib.rtx_render_probe.restype = _CI


def probe_library(probe: str, fast_scatter: bool, tables: str) -> CudaLibrary:
    """The probe library of a knob (one of ``PROBES``), sampler and route:
    ``csrc/megakernel.cu`` with ``-DRTX_PROBES`` and its Probe value,
    sampler and Tables value, its twelve instantiations (``variant``'s
    render_kernel, render_adaptive and the ``kKnobs`` one with its
    render_listed twin, for each geometry). Not built until its first
    launch."""
    scatter = "fast" if fast_scatter else "boxmuller"
    return CudaLibrary(
        "megakernel.cu", f"megakernel_{probe}_{scatter}_{tables}", _bind_probes,
        flags=NVCC_FLAGS + (
            "-DRTX_PROBES", f"-DRTX_PROBE={1 + PROBES.index(probe)}",
            f"-DRTX_FAST_SCATTER={int(fast_scatter)}",
            f"-DRTX_TABLES={TABLES.index(tables)}"))


class PathTraceKernel:
    """Builds, loads and launches ``csrc/megakernel.cu``: the production
    library (both routes), and at the first launch with a profiling knob
    that knob's library for the launch's sampler and route
    (``probe_library``; ``probe_libraries``, by ``(probe, fast_scatter,
    tables)``).

    ``variant_launches`` counts the kernel launches this object made, by
    instantiation (``variant``, which names the route; a ``kKnobs`` one's
    phase 2 over the lane list, its ``render_listed`` twin, under its
    name), and refill's lane passes under ``LANE_PASS``; only ``launch``
    and ``lane_pass`` add to it."""

    def __init__(self):
        self.variant_launches: collections.Counter = collections.Counter()
        self.library = CudaLibrary("megakernel.cu", "megakernel", _bind)
        self.probe_libraries = {
            (p, f, t): probe_library(p, f, t)
            for p in PROBES for f in (False, True) for t in TABLES}

    @property
    def build_info(self) -> BuildInfo | None:
        return self.library.build_info

    @property
    def launches(self) -> int:
        """Launches of every instantiation."""
        return sum(self.variant_launches.values())

    def reset_counts(self) -> None:
        self.variant_launches.clear()

    def build(self) -> BuildInfo:
        """Compile the source (if its library is not built yet) and load
        it. Raises if nvcc is missing or fails."""
        return self.library.build()

    def lane_pass(self, slots, resume, tile_max, lane_list, width, height,
                  ts, ppl, phases, rows, perm=None) -> None:
        """One launch of the ``refill_lanes`` kernel (``refill_lanes``), a
        block a tile: ``slots`` -> ``resume``, ``tile_max`` and
        ``lane_list``, int32 CUDA tensors of the band ``rows``, ``perm``
        None or ``pair_perm``'s."""
        dev = slots.device
        n_tiles = -(-(rows[1] - rows[0]) // ts) * -(-width // ts)
        want = [(slots, (rows[1] - rows[0], width)), (resume, slots.shape),
                (tile_max, (n_tiles,)),
                (lane_list, (n_tiles * (ts * ts // ppl),))]
        if perm is not None:
            want.append((perm, (n_tiles, ts * ts)))
        for t, shape in want:
            if (t.device != dev or t.dtype != torch.int32
                    or tuple(t.shape) != tuple(shape)
                    or not t.is_contiguous()):
                raise ValueError(
                    f"the lane pass takes contiguous int32 tensors of shape "
                    f"{tuple(shape)} on {dev}, got {tuple(t.shape)} "
                    f"{t.dtype} on {t.device}")
        with torch.cuda.device(dev):
            rc = self.library.lib.rtx_refill_lanes(
                slots.data_ptr(), None if perm is None else perm.data_ptr(),
                resume.data_ptr(), tile_max.data_ptr(), lane_list.data_ptr(),
                width, height,
                rows[0], rows[1], ts, ppl, phases,
                torch.cuda.current_stream(dev).cuda_stream)
        self.library.check(rc, "refill_lanes")
        self.variant_launches[LANE_PASS] += 1

    def shared_bytes(self, tab: KernelTables, cfg: RenderConfig,
                     tables: str = "staged") -> int:
        """A launch's dynamic shared memory for tables ``tab`` on the route
        ``tables``, as the source computes it (``launch_shared_bytes`` is
        its Python mirror)."""
        return self.library.lib.rtx_shared_bytes(
            GEOMETRIES.index(tab.geometry), TABLES.index(tables),
            tab.spheres.shape[0],
            tab.clusters.shape[0],
            0 if tab.chunks is None else tab.chunks.shape[0],
            0 if tab.supers is None else tab.supers.shape[0], cfg.max_bounce)

    def blocks_per_sm(self, scene: Scene, cfg: RenderConfig) -> int:
        """How many blocks of the instantiation that ``geometry(scene, cfg)``,
        ``cfg`` and ``table_route`` pick one SM holds at once, at the
        launch's shared memory
        (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
        tab = geometry_tables(scene, geometry(scene, cfg))
        tables = table_route(tab, cfg)
        n = self.library.lib.rtx_occupancy(
            GEOMETRIES.index(tab.geometry), TABLES.index(tables),
            int(cfg.adaptive_spp), int(cfg.fast_scatter),
            int(knobbed(scene, cfg)), self.shared_bytes(tab, cfg, tables))
        if n < 0:
            self.library.check(-n, "occupancy query")
        return n

    def resident_warps(self, scene: Scene, cfg: RenderConfig) -> int:
        """The warps a grid of resident blocks would hold for a whole-frame
        launch of the instantiation: as many 16x8 blocks as the card's SMs
        hold at once (``blocks_per_sm``), no more than the frame's warp
        tiles need (``queue_tiles``); the ``"queue"`` schedule's warps of
        ``warp_schedule_counts``."""
        per_block = BLOCK_X * BLOCK_Y // WARP
        sms = torch.cuda.get_device_properties(
            scene.device).multi_processor_count
        tiles = queue_tiles(cfg.width, 0, cfg.height)
        blocks = min(-(-tiles // per_block),
                     sms * self.blocks_per_sm(scene, cfg))
        return blocks * per_block

    def launch(
        self,
        scene: Scene,
        camera: Camera,
        cfg: RenderConfig,
        frame0,
        n_frames: int,
        accum: torch.Tensor | None,
        collect_stats: bool,
        rows: tuple[int, int] | None = None,
        probe: str | None = None,
        tables: str | None = None,
        phase_one: dict | None = None,
        pair_costs: torch.Tensor | None = None,
    ):
        """One call over the rows ``rows=(y0, y1)`` of the frame (the
        whole frame by default; ``band_rows`` says which bands a launch
        takes), of the instantiation that ``geometry(scene, cfg)``,
        ``cfg.adaptive_spp`` / ``cfg.fast_scatter`` and the route pick: by
        default ``table_route``'s, the staged tables where they fit a
        block's shared memory and the global ones where they do not;
        ``tables`` (one of ``TABLES``) forces one, which the tests and
        ``chip_smoke.py`` do on scenes that fit. Returns the same
        tuple as ``render_frames_plain`` with its default grouping (the
        total and the histogram count real pixels only): ``accum``, the
        image and the per-pixel map hold ``y1 - y0`` rows. Exact spp is one
        launch; refill two of ``render_adaptive`` (the source's
        ``render_slots``): phase 1 into a scratch row a pixel and an int a
        refill tile, phase 2 from them, under ``refill_knobs``' pixels a
        lane and phases, with more than one pixel a lane the lane pass
        between them (``refill_lanes``, its lanes in ``pair_perm``'s order
        of ``pair_costs``, the band's (y1 - y0, W) map, where given; with
        exact spp ``pair_costs`` is not read; with more than one pixel a
        lane, phase 2 runs over the lane pass's list of each lane's last
        pixel, one thread an entry). ``phase_one``, a dict, gains what
        ``render_frames_plain`` gives it (copies of phase 1's segment and
        slot maps and tile maxima, and the lane pass's resume map and list)
        and ``events``, five
        CUDA events: before and after phase 1, before and after phase 2,
        and after the lane pass (with one pixel a lane, right after phase
        1), refill only. Reads
        nothing back from the device and does not synchronise, except at a
        scene's first launch, which reads its sphere arrays back to cluster
        them (``geometry_tables``); the camera's visit order is made on the
        device (``visit_tables``).

        ``probe``, one of ``PROBE_SETTINGS``, launches the profiling
        instantiation ``probe_instantiation`` picks, from its knob's library
        for the launch's sampler and route (``probe_library``), built at
        first use; under a stub its stub row (``stub_row``, kept on the
        device per scene). A failing build or launch raises: there is no
        fall back to the production kernel, nor from one route to the
        other."""
        _check_frames(n_frames, accum)
        inst = probe_instantiation(scene, probe, cfg)
        if tables is not None and tables not in TABLES:
            raise ValueError(f"tables must be one of {TABLES}, got {tables!r}")
        knobs = knobbed(scene, cfg)
        y0, y1 = band_rows(scene, cfg, rows)
        dev = scene.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel needs a CUDA scene, got {dev}")
        h, w = y1 - y0, cfg.width
        if accum is not None and (
            accum.device != dev
            or accum.dtype != torch.float32
            or tuple(accum.shape) != (h, w, 3)
            or not accum.is_contiguous()
        ):
            raise ValueError(
                f"accum must be a contiguous ({h}, {w}, 3) float32 tensor on "
                f"{dev}, got {tuple(accum.shape)} {accum.dtype} on {accum.device}"
            )
        if camera.position.device != dev:
            raise ValueError(
                f"camera on {camera.position.device}, scene on {dev}"
            )
        geom = geometry(scene, cfg)
        tab = scene_tables(scene, camera, cfg)
        n_sph = tab.spheres.shape[0]
        n_clusters = tab.clusters.shape[0]
        n_chunks = 0 if tab.chunks is None else tab.chunks.shape[0]
        n_supers = 0 if tab.supers is None else tab.supers.shape[0]
        n_sph_supers = 0 if tab.sph_supers is None else tab.sph_supers.shape[0]
        code = GEOMETRIES.index(geom)
        route = tables or table_route(tab, cfg)
        if inst is None:
            library = self.library
            render = library.lib.rtx_render
        else:
            library = self.probe_libraries[(inst, cfg.fast_scatter, route)]
            stub = None
            if inst in ("stub_intersect", "stub_fetch"):
                stub = _stub_on_device(scene, probe)
            render = functools.partial(
                library.lib.rtx_render_probe, 1 + PROBES.index(inst),
                None if stub is None else stub.data_ptr(),
                0 if tab.tri_rows is None else tab.tri_rows.shape[0])

        out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
        segs = torch.empty((h, w), dtype=torch.int32, device=dev)
        hist = (
            torch.zeros(cfg.max_bounce + 1, dtype=torch.int32, device=dev)
            if collect_stats else None
        )

        def ptr(t):
            # an empty tensor's pointer is null: the kernel reads no row of it
            return None if t is None or t.numel() == 0 else t.data_ptr()

        def run(accum_in, image, phase=0, scratch=None, tile_max=None, ts=0,
                slot_map=None, ppl=1, phases=1, last_image=None,
                lane_list=None):
            rc = render(
                code, TABLES.index(route), ptr(tab.spheres),
                ptr(tab.sphere_orig), ptr(tab.sphere_mat), n_sph,
                ptr(tab.clusters), n_clusters, tab.n_hoist,
                ptr(tab.sph_supers), n_sph_supers,
                ptr(tab.tri_rows), ptr(tab.tri_normals), ptr(tab.tri_mat),
                ptr(tab.chunks), n_chunks, ptr(tab.supers), n_supers,
                SUPER_CHUNKS, ptr(tab.bvh_nodes),
                ptr(tab.bvh_leaves), tab.bvh_node_count, ptr(tab.materials),
                ptr(tab.params), w, cfg.height, y0, y1, cfg.spp, cfg.max_bounce,
                int(frame0) & 0xFFFFFFFF, n_frames, ptr(accum_in),
                int(cfg.clamp_accumulate), int(cfg.adaptive_spp),
                int(cfg.fast_scatter), phase, ptr(scratch), ptr(tile_max), ts,
                ptr(slot_map), ppl, phases, ptr(last_image), ptr(lane_list),
                int(tab.chunk_warp_scan), ptr(image), ptr(segs), ptr(hist),
                torch.cuda.current_stream(dev).cuda_stream,
            )
            library.check(rc, "megakernel")
            self.variant_launches[variant(
                geom, cfg.adaptive_spp, cfg.fast_scatter, inst, route, knobs
            )] += 1

        with torch.cuda.device(dev):
            if not cfg.adaptive_spp:
                run(accum, out)
                return out, segs.sum(dtype=torch.int64), segs, hist
            # refill: phase 1 leaves each pixel's RNG state and last frame's
            # light in `scratch`, its segments in `segs`, the running average
            # of the frames before the last in `mid`, its slot in `slots`
            # (its segments with one pixel a lane and one phase), and with
            # one pixel a lane each tile's last finish in `tile_max`; with
            # more each pixel's image without extra samples in `out`, and
            # the lane pass takes the tiles' last finish, each lane's slot
            # and the list of each lane's last pixel, over which phase 2
            # runs; phase 2 takes them from there
            ts = refill_tile_size(scene, cfg)
            ppl, phases = refill_knobs(scene, cfg)
            n_tiles = -(-h // ts) * -(-w // ts)
            scratch = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
            tile_max = (torch.zeros if ppl == 1 else torch.empty)(
                n_tiles, dtype=torch.int32, device=dev)
            mid = None if accum is None else torch.empty_like(out)
            slots = lane_list = None
            if ppl > 1 or phases > 1:
                slots = torch.empty((h, w), dtype=torch.int32, device=dev)
            if ppl > 1:
                lane_list = torch.empty(n_tiles * (ts * ts // ppl),
                                        dtype=torch.int32, device=dev)
            perm = None
            if pair_costs is not None and ppl > 1:
                perm = pair_perm(pair_costs.to(dev), w, cfg.height, ts, ppl,
                                 y0, y1).contiguous()
            events = None
            if phase_one is not None:
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(5)]
                events[0].record()
            with annotate(REFILL_PHASE1):
                run(accum, mid, 1, scratch, tile_max, ts, slots, ppl, phases,
                    last_image=out if ppl > 1 else None)
            if phase_one is not None:
                events[1].record()
            resume = slots
            if ppl > 1:
                with annotate(REFILL_LANE_PASS):
                    resume = torch.empty_like(slots)
                    self.lane_pass(slots, resume, tile_max, lane_list, w,
                                   cfg.height, ts, ppl, phases, (y0, y1),
                                   perm)
            if phase_one is not None:
                events[4].record()
                phase_one.update(segs=segs.clone(), tile_max=tile_max.clone(),
                                 slots=segs.clone() if slots is None
                                 else slots.clone(), events=events)
                if lane_list is not None:
                    phase_one.update(resume=resume.clone(),
                                     lane_list=lane_list.clone())
                events[2].record()
            with annotate(REFILL_PHASE2):
                run(mid, out, 2, scratch, tile_max, ts, resume, ppl, phases,
                    lane_list=lane_list)
            if phase_one is not None:
                events[3].record()
        return out, segs.sum(dtype=torch.int64), segs, hist


def _stub_on_device(scene: Scene, probe: str) -> torch.Tensor:
    """``stub_row(scene, probe)`` on the scene's device, copied there once
    a scene and setting."""
    cache = _scene_cache(scene)
    key = ("stub_row_device", probe)
    if key not in cache:
        cache[key] = torch.from_numpy(stub_row(scene, probe)).to(scene.device)
    return cache[key]


@dataclasses.dataclass
class KernelTables:
    """The kernel's inputs on the scene's device (layouts in
    ``csrc/megakernel.cu``), and what the plain version needs beside them.
    The triangle fields are None for the sphere geometry, the chunk table
    for the BVH geometry, and the BVH tables for the other two.

    Spheres are in clustered order (``kernels/pack.py``): the hoisted ones
    first, then each sub-cluster's live slots, sub-cluster after
    sub-cluster. Only real spheres have a slot. ``geometry_tables`` holds
    the clusters, and their supers, in that table order; ``visit_tables``
    in a camera's visit order (the sphere rows do not move: a cluster row
    names its slots)."""

    geometry: str
    spheres: torch.Tensor  # (N, 4) f32: cx, cy, cz, r^2
    sphere_orig: torch.Tensor  # (N,) int32: the slot's index in the scene
    sphere_mat: torch.Tensor  # (N,) int32
    # (K, 8) f32: box min, first slot, box max, live slots (the two counts
    # as int32 bits); the box is the sub-cluster's, one ulp wider each way
    clusters: torch.Tensor
    n_hoist: int
    # (R, 8) f32: box min, first cluster row, box max, cluster count (int32
    # bits): one super over each run of SUPER_CLUSTERS clusters in table
    # order, its box the union of theirs; None for at most one run, and for
    # the triangle geometries (their kernels scan the clusters in one level)
    sph_supers: torch.Tensor | None
    # (S,) int64, by the scene's sphere index: its cluster, K for a hoisted
    # sphere, K + 1 for a padding sphere
    cluster_of: torch.Tensor
    # (K + 1, M) int64: the scene indices of each cluster's spheres, row K
    # the hoisted ones, filled up with S
    cluster_members: torch.Tensor
    # (K,) int64: the table index of each row of ``clusters``
    cluster_order: torch.Tensor
    materials: torch.Tensor  # (M, 16) f32
    params: torch.Tensor | None = None  # (32,) f32, set a launch
    tri_rows: torch.Tensor | None = None  # (T, 12) f32: a, b - a, c - a, n
    tri_normals: torch.Tensor | None = None  # (T, 9) f32: at a, b, c
    tri_mat: torch.Tensor | None = None  # (T,) int32
    # (C, 8) f32: box min, first triangle, box max, triangle count
    chunks: torch.Tensor | None = None
    # (T,) int64: the triangle's chunk, C for a padding triangle
    chunk_of: torch.Tensor | None = None
    # (C, M) int64: each chunk's triangles, filled up with T
    chunk_members: torch.Tensor | None = None
    # (R, 8) f32: box min, 0, box max, 0, the chunk scan's box levels
    # (``super_levels``) one after the other: over each run of SUPER_CHUNKS
    # chunks, then over each run of SUPER_CHUNKS of those; None for a scene
    # of at most SUPER_CHUNKS chunks
    supers: torch.Tensor | None = None
    # (1 + internal nodes, 16) f32: ``bvh_node_table``
    bvh_nodes: torch.Tensor | None = None
    bvh_leaves: torch.Tensor | None = None  # (L, 4) int32
    bvh_node_count: int = 0  # the BVH's nodes: the traversal's pop cap
    bvh_sentinel: int | None = None  # the leaves' padding index
    # the chunk geometry: whether a chunk visit can go across the warp
    # (``chunk_scan_across_warp``), else each lane scans alone
    chunk_warp_scan: bool = False
    # host seconds the sphere clustering took when these were built
    cluster_seconds: float = 0.0


@dataclasses.dataclass
class TableBuilds:
    """How often ``geometry_tables`` built (and did not find) a scene's
    tables, and the host seconds that took; of them the clustering's."""

    builds: int = 0
    seconds: float = 0.0
    cluster_seconds: float = 0.0

    def reset(self) -> None:
        self.builds, self.seconds, self.cluster_seconds = 0, 0.0, 0.0


TABLE_BUILDS = TableBuilds()


def _int_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)[:, None].view(torch.float32)


def _int_column(rows: torch.Tensor, c: int) -> torch.Tensor:
    """Column ``c`` of f32 ``rows``, read as the int32 it holds."""
    return rows[:, c].contiguous().view(torch.int32)


def _tensor_leaves(tree):
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensor_leaves(getattr(tree, f.name))
    elif torch.is_tensor(tree):
        yield tree


def sphere_tables(scene: Scene) -> dict:
    """The clustered sphere tables of ``KernelTables`` (its fields, by
    name) from ``pack_spheres`` on the scene's sphere arrays, read back to
    the host once. The JAX package's tables carry dead slots and, after
    the regular sub-clusters, all-dead ones; here a sub-cluster keeps only
    its live slots and an empty one is dropped, so a scene without spheres
    has no cluster. A box is widened by one ulp each way: ``c - r`` and
    ``c + r`` round to nearest, so the sub-cluster's own box can miss its
    sphere's surface by half an ulp. Over more than ``SUPER_CLUSTERS``
    clusters, one super a run of that many in table order, its box the
    union of theirs (the JAX package's ``_supers``, ``pack.py:698-730``;
    the hoisted spheres stay hoisted, tested before either level)."""
    dev = scene.device
    sph = scene.spheres
    centers = sph.center.cpu().numpy()
    radii = sph.radius.cpu().numpy()
    t0 = time.perf_counter()
    pack = pack_spheres(centers, radii)
    seconds = time.perf_counter() - t0
    live = pack.sph_sub_cols[:, :, 3] > 0
    perm = pack.perm.reshape(-1, SUB)
    n_sub = pack.n_sphere_subs_visit
    order = [perm[n_sub:][live[n_sub:]][: pack.n_hoist]]
    boxes = []
    cluster_of = np.full(centers.shape[0], -1, np.int64)
    first = pack.n_hoist
    for k in range(n_sub):
        members = perm[k][live[k]]
        if len(members) == 0:
            continue
        cluster_of[members] = len(boxes)
        lo = np.nextafter(pack.sph_sub_bounds[k, :3], np.float32(-np.inf))
        hi = np.nextafter(pack.sph_sub_bounds[k, 3:6], np.float32(np.inf))
        counts = np.array([first, len(members)], np.int32).view(np.float32)
        boxes.append(np.concatenate([lo, counts[:1], hi, counts[1:]]))
        order.append(members)
        first += len(members)
    order = np.concatenate(order).astype(np.int64)
    n_clusters = len(boxes)
    cluster_of[order[: pack.n_hoist]] = n_clusters
    cluster_of[cluster_of < 0] = n_clusters + 1
    if len(order) != int((radii > 0).sum()) or len(set(order.tolist())) != len(order):
        raise AssertionError("a real sphere is not in exactly one slot")
    r = radii[order]
    rows = np.concatenate([centers[order], (r * r)[:, None]], axis=1)
    clusters = np.stack(boxes) if boxes else np.zeros((0, 8), np.float32)
    supers = None
    if n_clusters > SUPER_CLUSTERS:
        supers = np.stack([
            np.concatenate([
                run[:, 0:3].min(axis=0),
                np.int32([k0]).view(np.float32),
                run[:, 4:7].max(axis=0),
                np.int32([len(run)]).view(np.float32),
            ])
            for k0 in range(0, n_clusters, SUPER_CLUSTERS)
            for run in [clusters[k0:k0 + SUPER_CLUSTERS]]
        ])
        supers = torch.from_numpy(supers).to(dev)
    order_t = torch.from_numpy(order).to(dev)
    return dict(
        spheres=torch.from_numpy(rows.astype(np.float32)).to(dev),
        sphere_orig=order_t.to(torch.int32),
        sphere_mat=sph.mat_idx[order_t].to(torch.int32).contiguous(),
        clusters=torch.from_numpy(clusters).to(dev),
        n_hoist=pack.n_hoist,
        sph_supers=supers,
        cluster_order=torch.arange(n_clusters, device=dev),
        cluster_of=torch.from_numpy(cluster_of).to(dev),
        cluster_members=torch.from_numpy(
            _members(cluster_of, n_clusters + 1, centers.shape[0])).to(dev),
        cluster_seconds=seconds,
    )


def bvh_node_table(bvh: BVH, sentinel: int) -> np.ndarray:
    """The kernel's BVH node table from ``bvh``'s arrays, on the host:
    (1 + internal nodes, 16) f32, layout in ``csrc/megakernel.cu``. Row 0
    holds the root's box and reference; row ``1 + k`` the ``k``-th
    internal node in node order: its left child's box and reference, then
    its right child's. A reference to an internal node is its row (>= 1),
    to a leaf ``~(leaf row << LEAF_COUNT_BITS | real slots)`` < 0, the real
    slots those below ``sentinel``. References are int32 bits in columns
    3 and 11 (row 0: column 3); columns 7 and 15 are 0. Raises unless each
    leaf's real slots come first."""
    lo, hi, left, right, leaf_row, prims = (
        getattr(bvh, f).cpu().numpy() for f in (
            "bounds_min", "bounds_max", "left", "right", "leaf_row",
            "leaf_prims"))
    real = prims < sentinel
    n_real = real.sum(axis=1)
    if (real != (np.arange(prims.shape[1]) < n_real[:, None])).any():
        raise ValueError("a BVH leaf has a padding slot before a real one")
    internal = np.nonzero(leaf_row < 0)[0]
    row_of = np.zeros(left.shape[0], np.int64)
    row_of[internal] = np.arange(1, internal.shape[0] + 1)
    leaf = leaf_row.astype(np.int64)
    ref = np.where(
        leaf >= 0,
        ~((leaf << LEAF_COUNT_BITS) | n_real[np.maximum(leaf, 0)]), row_of,
    ).astype(np.int32).view(np.float32)
    table = np.zeros((1 + internal.shape[0], 16), np.float32)
    table[0, 0:3], table[0, 3], table[0, 4:7] = lo[0], ref[0], hi[0]
    for k, child in ((0, left[internal]), (8, right[internal])):
        table[1:, k:k + 3] = lo[child]
        table[1:, k + 3] = ref[child]
        table[1:, k + 4:k + 7] = hi[child]
    return table


def _scene_cache(scene: Scene) -> dict:
    """What is kept on ``scene`` for the kernel (its tables, the sphere
    clustering, counts): emptied when one of its tensors was replaced or
    written to in place."""
    key = tuple((id(t), t._version) for t in _tensor_leaves(scene))
    cache = scene.__dict__.setdefault("_kernel_tables", {})
    if cache.get("key") != key:
        cache.clear()
        cache["key"] = key
    return cache


def _sphere_part(scene: Scene) -> dict:
    """``sphere_tables(scene)``, made once a scene."""
    cache = _scene_cache(scene)
    if "sphere_tables" not in cache:
        cache["sphere_tables"] = sphere_tables(scene)
    return cache["sphere_tables"]


def geometry_tables(scene: Scene, geom: str) -> KernelTables:
    """The scene's part of the kernel's tables for geometry ``geom``, built
    once a scene: kept on the scene object and found again as long as none
    of its tensors was replaced or written to in place (an animation's
    frames are scenes of their own and build their own).

    The chunk table holds each chunk's first triangle and triangle count as
    int32 bits in its f32 columns 3 and 7; the BVH's node table is
    ``bvh_node_table``'s."""
    cache = _scene_cache(scene)
    if geom in cache:
        return cache[geom]
    with annotate(WRAPPER_TABLE_BUILD):
        tab = _build_geometry_tables(scene, geom)
    cache[geom] = tab
    return tab


def _build_geometry_tables(scene: Scene, geom: str) -> KernelTables:
    """``geometry_tables``' build, counted in ``TABLE_BUILDS``."""
    t0 = time.perf_counter()
    dev = scene.device
    mat = scene.materials
    tab = KernelTables(
        geometry=geom,
        materials=torch.cat(
            [
                mat.colour, mat.emission_colour, mat.specular_colour,
                mat.emission_strength[:, None], mat.smoothness[:, None],
                mat.specular_probability[:, None], mat.ior[:, None],
                mat.flag.to(torch.float32)[:, None],
                torch.zeros((mat.count, 2), dtype=torch.float32, device=dev),
            ],
            dim=1,
        ).contiguous(),
        **_sphere_part(scene),
    )
    if geom != "spheres":
        # the triangle instantiations scan the sphere clusters in one level
        # (csrc/megakernel.cu closest_hit)
        tab.sph_supers = None
        tri = scene.triangles
        tab.tri_rows = torch.cat(
            [tri.pos_a, tri.edge_ab, tri.edge_ac, tri.n], dim=1
        ).contiguous()
        tab.tri_normals = torch.cat(
            [tri.normal_a, tri.normal_b, tri.normal_c], dim=1
        ).contiguous()
        tab.tri_mat = tri.mat_idx.to(torch.int32).contiguous()
    if geom == "chunks":
        ch = scene.chunks
        first = ch.first_tri.cpu().numpy()
        ends = first + ch.num_tris.cpu().numpy()
        if first[0] != 0 or (first[1:] != ends[:-1]).any():
            raise ValueError(
                "the scene's chunks are not consecutive runs of its triangles"
            )
        tab.chunks = torch.cat(
            [ch.bounds_min, _int_bits(ch.first_tri), ch.bounds_max,
             _int_bits(ch.num_tris)],
            dim=1,
        ).contiguous()
        # each box the exact union of its members' boxes; a chunk without
        # triangles takes no part
        real = (ch.num_tris > 0)[:, None]
        lo = torch.where(real, ch.bounds_min, INF)
        hi = torch.where(real, ch.bounds_max, -INF)
        levels = []
        for n_runs in super_levels(first.shape[0]):
            if not n_runs:
                break
            pad = n_runs * SUPER_CHUNKS - lo.shape[0]
            lo = F.pad(lo, (0, 0, 0, pad), value=INF).reshape(
                n_runs, SUPER_CHUNKS, 3).amin(dim=1)
            hi = F.pad(hi, (0, 0, 0, pad), value=-INF).reshape(
                n_runs, SUPER_CHUNKS, 3).amax(dim=1)
            zero = torch.zeros((n_runs, 1), dtype=torch.float32, device=dev)
            levels.append(torch.cat([lo, zero, hi, zero], dim=1))
        if levels:
            tab.supers = torch.cat(levels).contiguous()
        tab.chunk_warp_scan = chunk_scan_across_warp(ends - first)
        chunk_of = np.searchsorted(ends, np.arange(tri.count), side="right")
        tab.chunk_of = torch.from_numpy(chunk_of).to(dev)
        tab.chunk_members = torch.from_numpy(
            _members(chunk_of, first.shape[0], tri.count)).to(dev)
    elif geom == "bvh":
        bvh = scene.tri_bvh
        if bvh.leaf_prims.shape[1] != LEAF_WIDTH:
            raise ValueError(
                f"the kernel's BVH leaves hold {LEAF_WIDTH} triangles, this "
                f"scene's {bvh.leaf_prims.shape[1]}"
            )
        # the leaves' padding index is the first padding triangle: the
        # number of real ones, which the chunks hold
        tab.bvh_sentinel = int(scene.chunks.num_tris.sum())
        tab.bvh_nodes = torch.from_numpy(
            bvh_node_table(bvh, tab.bvh_sentinel)).to(dev)
        tab.bvh_leaves = bvh.leaf_prims.to(torch.int32).contiguous()
        tab.bvh_node_count = bvh.left.shape[0]
    TABLE_BUILDS.builds += 1
    TABLE_BUILDS.seconds += time.perf_counter() - t0
    TABLE_BUILDS.cluster_seconds += tab.cluster_seconds
    return tab


def super_levels(n_chunks: int) -> tuple[int, int]:
    """The boxes of the chunk scan's two levels over ``n_chunks`` chunks in
    index order -> ``(boxes over runs of SUPER_CHUNKS chunks, boxes over
    runs of SUPER_CHUNKS of those)``: none for at most SUPER_CHUNKS chunks,
    the first level alone for at most SUPER_CHUNKS squared, both past it.
    The source derives the same split from the chunk count and refuses
    box rows of another count."""
    f = SUPER_CHUNKS
    runs = -(-n_chunks // f) if n_chunks > f else 0
    return runs, -(-runs // f) if runs > f else 0


def chunk_box_levels(supers: torch.Tensor | None, n_chunks: int) -> list:
    """``KernelTables.supers`` of a scene of ``n_chunks`` chunks split into
    its levels, the one over the chunks first: a list of (R, 8) row
    tensors, empty without boxes."""
    out, at = [], 0
    for n in super_levels(n_chunks) if supers is not None else ():
        if n:
            out.append(supers[at:at + n])
            at += n
    return out


def _boxdist2(pos: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Squared distance from the point ``pos`` (3,) to each box ``lo``,
    ``hi`` (N, 3), clipped per axis (the JAX package's ``_boxdist2``,
    ``megakernel.py:2512-2515``): 0 for a box that holds it."""
    e = torch.minimum(torch.maximum(pos[None, :], lo), hi) - pos[None, :]
    e = e * e
    return (e[:, 0] + e[:, 1]) + e[:, 2]


def front_to_back(tab: KernelTables, position: torch.Tensor) -> dict:
    """The sphere clusters of ``tab`` (in table order) in the visit order
    of a camera at ``position``, the TPU kernel's rule
    (``megakernel.py:2512-2533``, ``sperm_sup`` ``:2568``): the nearest box
    first by ``_boxdist2``, a tie to the lower table index. With supers,
    the supers in that order and each one's clusters in that order within
    it (``_f2b_within``); without, all clusters (``_f2b``). -> the fields
    ``clusters`` (the rows gathered into visit order), ``sph_supers`` (the
    supers' rows gathered, column 3 the first row of their run in the
    gathered clusters) and ``cluster_order`` (each row's table index).
    Made on the device: no value is read back."""
    cl, su = tab.clusters, tab.sph_supers
    k = cl.shape[0]
    d2 = _boxdist2(position, cl[:, 0:3], cl[:, 4:7])
    if su is None:
        order = torch.argsort(d2, stable=True)
        return dict(clusters=cl[order], cluster_order=order)
    r, size = su.shape[0], SUPER_CLUSTERS
    sup_order = torch.argsort(_boxdist2(position, su[:, 0:3], su[:, 4:7]),
                              stable=True)
    # the last run's missing clusters sort last within it
    within = torch.argsort(F.pad(d2, (0, r * size - k), value=INF)
                           .reshape(r, size), dim=1, stable=True)
    # a cluster's visit key: its super's rank, then its rank within it
    rank = torch.argsort(sup_order)[:, None] * size + torch.argsort(within, dim=1)
    order = torch.argsort(rank.reshape(-1)[:k])
    counts = _int_column(su, 7)[sup_order]
    rows = su[sup_order]
    rows[:, 3] = (torch.cumsum(counts, 0, dtype=torch.int32)
                  - counts).view(torch.float32)
    return dict(clusters=cl[order], sph_supers=rows, cluster_order=order)


def visit_tables(scene: Scene, geom: str, camera: Camera) -> KernelTables:
    """``geometry_tables(scene, geom)`` with its sphere clusters in the
    visit order of ``camera`` (``front_to_back``), as a launch from that
    camera takes them. Kept beside the scene's tables, one camera at a
    time, and found again while the camera's position is the same tensor,
    not written in place (the way ``geometry_tables`` keeps a scene's): a
    still camera pays for its order once."""
    tab = geometry_tables(scene, geom)
    if tab.clusters.shape[0] < 2:
        return tab
    pos = camera.position
    cache = scene.__dict__["_kernel_tables"]
    kept = cache.get(("visit", geom))
    if (kept is not None and kept[0] is tab and kept[1] is pos
            and kept[2] == pos._version):
        return kept[3]
    with annotate(WRAPPER_VISIT_BUILD):
        out = dataclasses.replace(tab, **front_to_back(tab, pos))
    cache[("visit", geom)] = (tab, pos, pos._version, out)
    return out


def scene_tables(scene: Scene, camera: Camera, cfg: RenderConfig) -> KernelTables:
    """The scene, camera and config flattened into the kernel's tables, for
    ``geometry(scene, cfg)``: the scene's part from ``geometry_tables`` with
    its clusters in the camera's visit order (``visit_tables``), the
    camera's and the environment's parameters made anew."""
    with annotate(WRAPPER_TABLES):
        env = scene.env
        params = torch.cat(
            [
                camera.position, camera.rotation.reshape(-1),
                camera_params(camera, cfg.width, cfg.height),
                env.enabled.reshape(1), env.ground_colour,
                env.sky_colour_horizon, env.sky_colour_zenith,
                env.sun_focus.reshape(1), env.sun_intensity.reshape(1),
                env.sun_dir,
            ]
        ).to(torch.float32)
        return dataclasses.replace(
            visit_tables(scene, geometry(scene, cfg), camera), params=params
        )


KERNEL = PathTraceKernel()


def render_frames_mega(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frame0,
    n_frames: int = 1,
    accum: torch.Tensor | None = None,
    collect_stats: bool = False,
    rows: tuple[int, int] | None = None,
    probe: str | None = None,
    tables: str | None = None,
    phase_one: dict | None = None,
    pair_costs: torch.Tensor | None = None,
):
    """Render ``n_frames`` frames from ``frame0`` (folded into ``accum``
    when given) -> ``(image, total segments, per-pixel segments, bounce
    histogram or None)``.

    A scene on the CPU takes the plain version; a scene on a CUDA device
    takes the kernel (one launch for all frames): ``render_adaptive`` with
    ``cfg.adaptive_spp``, else ``render_kernel``, each in the instantiation
    of ``geometry(scene, cfg)`` and in its fast one with
    ``cfg.fast_scatter``, on the route ``table_route`` picks: the staged
    tables where they fit a block's shared memory, the global ones where
    they do not. ``tables`` (one of ``TABLES``) forces a route on the card
    (the outputs are the same bit for bit); the plain version has no
    routes and only checks the value.

    ``rows=(y0, y1)`` renders a band of the frame's rows, on both devices
    under ``band_rows``'s rule: ``accum``, the image and the per-pixel map
    hold ``y1 - y0`` rows, and they equal those rows of the whole frame's
    bit for bit (the multi-GPU split, ``parallel/sharding.py``).

    ``probe``, one of ``PROBE_SETTINGS``, sets that profiling knob: on the
    card its probe library's instantiation (``PathTraceKernel.launch``), on
    the CPU the plain version's (``render_frames_plain``); the outputs are
    those without it but for the stubs, which change the rays' paths
    (``stub_row``). ``phase_one``, a dict, gains refill's first phase
    (``render_frames_plain``; on the card also the launches' events,
    ``PathTraceKernel.launch``). ``pair_costs``, a (y1 - y0, W) cost map
    (a launch's per-pixel segments), pairs a refill lane's pixels by cost
    where a lane has more than one (``pair_perm``), as the JAX package's
    ``render_frames_mega`` does; exact spp does not read it."""
    dev = scene.device
    if dev.type == "cpu":
        band_rows(scene, cfg, rows)  # the kernel's rule, checked there too
        if tables is not None and tables not in TABLES:
            raise ValueError(f"tables must be one of {TABLES}, got {tables!r}")
        with annotate(WRAPPER_LAUNCH):
            return render_frames_plain(
                scene, camera, cfg, frame0, n_frames, accum, collect_stats,
                rows=rows, probe=probe, phase_one=phase_one,
                pair_costs=pair_costs,
            )
    if dev.type == "cuda":
        with annotate(WRAPPER_LAUNCH):
            return KERNEL.launch(
                scene, camera, cfg, frame0, n_frames, accum, collect_stats,
                rows=rows, probe=probe, tables=tables, phase_one=phase_one,
                pair_costs=pair_costs,
            )
    raise ValueError(f"no render path for device {dev}")


def probe_setting(use_cull: bool = True, stub_fetch: bool = False,
                  stub_intersect: bool = False, dup_intersect: bool = False,
                  dup_fetch: bool = False) -> str | None:
    """The knob setting (one of ``PROBE_SETTINGS``, or None) of the JAX
    package's ``render_frame_mega`` knobs. One knob at a time, or the two
    stubs together; ``use_cull=False`` beside stub_intersect changes
    nothing (no scan runs). Any other pair raises ValueError."""
    on = [name for name, set_ in (
        ("no_cull", not use_cull), ("stub_fetch", stub_fetch),
        ("stub_intersect", stub_intersect), ("dup_intersect", dup_intersect),
        ("dup_fetch", dup_fetch)) if set_]
    if stub_intersect and "no_cull" in on:
        on.remove("no_cull")
    if set(on) == {"stub_fetch", "stub_intersect"}:
        return "stubs"
    if len(on) > 1:
        raise ValueError(
            f"set at most one profiling knob, or the two stubs together: {on}")
    return on[0] if on else None


def render_frame_mega(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frame,
    use_cull: bool = True,
    stub_fetch: bool = False,
    stub_intersect: bool = False,
    dup_intersect: bool = False,
    dup_fetch: bool = False,
    y0: int = 0,
    band_height: int | None = None,
    collect_stats: bool = False,
    segs_map: bool = False,
):
    """One frame through the path-trace kernel (on the CPU its plain
    version): the JAX package's ``render_frame_mega``
    (``megakernel.py:2285-2330``) with its arguments but ``interpret``.

    The profiling knobs (``probe_setting``; ``render_frames_mega(...,
    probe=)``): ``use_cull=False`` (no gate), ``dup_intersect`` and
    ``dup_fetch`` give the image and counts without the knob;
    ``stub_intersect`` and ``stub_fetch`` change the rays' paths
    (``stub_row``; under the JAX package's winner fetch stub_fetch changes
    nothing and stub_intersect raises NotImplementedError,
    ``probe_instantiation``).

    ``y0`` and ``band_height`` render the band of rows ``y0 .. y0 +
    band_height - 1`` (``band_rows``' rule, with refill whole tiles); rows
    past the frame, which the JAX kernel's edge tiles fill by re-rendering
    their clamped border pixel, repeat the frame's last row, and count in
    the per-pixel map but not in the total.

    Returns ``(image (bh, W, 3) f32, total segments)``; with
    ``collect_stats`` also the JAX package's ``counts``, (hist_rows,) int32
    with hist_rows = max_bounce + 1 rounded up to 8: rows ``[0,
    max_bounce]`` the bounce histogram (real pixels only, as this port
    counts), the rows above zeros (there the TPU kernel keeps its
    sub-cluster visit counts, which this kernel does not make); else with
    ``segs_map`` the per-pixel segments (bh, W) int32."""
    probe = probe_setting(use_cull, stub_fetch, stub_intersect,
                          dup_intersect, dup_fetch)
    bh = cfg.height - y0 if band_height is None else band_height
    if not 0 <= y0 < cfg.height or bh < 1:
        raise ValueError(f"band y0={y0}, band_height={band_height} outside "
                         f"0..{cfg.height}")
    rows = (y0, min(y0 + bh, cfg.height))
    img, total, seg_map, hist = render_frames_mega(
        scene, camera, cfg, frame, collect_stats=collect_stats,
        rows=None if rows == (0, cfg.height) else rows, probe=probe)
    extra = y0 + bh - rows[1]
    if extra > 0:
        img = torch.cat([img, img[-1:].expand(extra, -1, -1)])
        seg_map = torch.cat([seg_map, seg_map[-1:].expand(extra, -1)])
    if collect_stats:
        counts = torch.zeros(_round_up(cfg.max_bounce + 1, 8),
                             dtype=torch.int32, device=hist.device)
        counts[:cfg.max_bounce + 1] = hist
        return img, total, counts
    if segs_map:
        return img, total, seg_map
    return img, total
